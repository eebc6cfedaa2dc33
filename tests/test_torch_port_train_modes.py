"""``vo_loss_fn``'s gradient in semisup and unsup against the JAX
trainer's: (a) of tests/test_torch_port_train_step.py in the other two
loss modes (a file of its own, so that the JAX programs of the three
modes compile on different test workers).

In semisup every weight tensor above 1e-4 of the total norm is within
1e-3 relative L2 of JAX's. In unsup ``self_label_masks`` thresholds the
full-minus-camera flow at 0.5 (losses.py:439), where rounding can flip a
label, so the criterion is tests/test_nets.py's (cos > 0.99, norm ratio
0.95-1.05), and the labels flipped between the two forwards are counted
and printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.geom import projective as jproj
from pvo_tpu.vo import losses as jl
from pvo_tpu.vo.net.droidnet import DroidNet as JaxDroidNet
from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.utils.convert import droidnet_from_jax
from pvo_tpu_torch.vo import losses

from test_torch_port_train_step import (II, ITERS, JJ, check_mode, jax_pass,
                                        jit_fast, the_batch, weights)  # noqa: F401
from torch_one_thread import one_thread  # noqa: F401


def flipped_labels(weights):
    """Self labels (losses.py:439) of the last step that differ between
    the two packages' forwards."""
    var, params = weights
    b = {k: v[0] for k, v in the_batch().items()}
    fwd = (lambda v: JaxDroidNet().apply(
        v, b["poses_init"], b["images"], b["disps_init"], b["intrinsics"],
        II, JJ, num_steps=ITERS, ret_flow=True, downsample=True))
    oj = jit_fast(fwd, var)(var)
    cf, _ = jproj.induced_flow(oj["poses"][-1],
                               oj["disps_up"][-1][:, :, 3::8, 3::8],
                               jnp.asarray(b["intrinsics"]), II, JJ)
    art_j = np.asarray(jl.self_label_masks(oj["flows"][-1], cf))
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        ot = droidnet_from_jax(params)(
            bt["poses_init"], bt["images"], bt["disps_init"],
            bt["intrinsics"], II, JJ, num_steps=ITERS, ret_flow=True,
            downsample=True, corr_impl="plain")
        cf, _ = projective.induced_flow(
            ot["poses"][-1], ot["disps_up"][-1][:, :, 3::8, 3::8],
            bt["intrinsics"], II, JJ)
        art_t = losses.self_label_masks(ot["flows"][-1], cf).numpy()
    return int((art_t != art_j).sum())


@pytest.mark.parametrize("mode", ["semisup", "unsup"])
def test_vo_loss_gradients_match_jax_per_mode(weights, mode):
    batch = the_batch()
    fn = jax_pass(weights[0], mode, batch)[0]
    msg = check_mode(weights, mode, fn(weights[0], batch,
                                       batch["poses_init"],
                                       batch["disps_init"]))
    if mode == "unsup":
        msg += f", self labels flipped: {flipped_labels(weights)}"
    print(msg)
