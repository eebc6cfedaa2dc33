"""The card against the CPU in training, and the tracker against itself:
the faults B4 and B5 of ROADMAP.md Queue 3, held on the card (skips
without one; imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_cuda_train.py -q

* B4: one VO restart pass (chip_smoke.py phase 10 (a)) with cuDNN on,
  every weight tensor's gradient above 1e-4 of the total norm within
  5e-4 relative L2 of the CPU's (fnet's instance-normed convolutions run
  without cuDNN under grad, ``layers.NormedConv2d``: with cuDNN's weight
  gradients there the pass read 4.45e-3); the VPS full loss's gradients
  at 64x96 on the R-50 (``fault_probe.vps_card_errors``) within 2e-4
  (5.1e-5 measured).
* B5, its cause: the bench_track stream tracked twice gives bit-equal
  keyframe poses after every frame once ``Tensor.index_add_`` (float
  atomics on the card) is replaced by PyTorch's sort-based
  ``index_put_(accumulate=True)``. The port keeps ``index_add_``: the
  order-fixed sums cost 10-18% of bench_track's frames/s.
"""

import pytest
import torch

from pvo_tpu_torch.parallel import data_parallel as dp
from pvo_tpu_torch.scripts import fault_probe
from pvo_tpu_torch.scripts.bench_track import tame_net
from pvo_tpu_torch.utils.device import open_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return open_device("cuda")


def test_vo_training_gradients_match_the_cpu_with_cudnn(dev):
    batch = dp.make_synthetic_batch(1, F=4, H=48, W=64, seed=0)
    lp, ref = fault_probe.vo_pass(tame_net(0, mask_bias=-2.0).train(),
                                  "cpu", batch)
    total = float(torch.sqrt(sum((g ** 2).sum() for g in ref.values())))
    lc, grads = fault_probe.vo_pass(
        tame_net(0, mask_bias=-2.0).to(dev).train(), "cuda", batch)
    errs = fault_probe.rel_errors(grads, ref, total)
    assert len(errs) >= 60
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 5e-4, (worst, errs[worst])


def test_vps_training_gradients_match_the_cpu_with_cudnn(dev):
    loss_rel, errs = fault_probe.vps_card_errors("full")[True]
    assert loss_rel <= 1e-4 and len(errs) >= 60
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 2e-4, (worst, errs[worst])


def test_tracker_repeats_itself_with_order_fixed_sums(dev):
    with fault_probe.scatter_sums("index_put"):
        a, _ = fault_probe.track_poses(20)
        b, _ = fault_probe.track_poses(20)
    assert fault_probe.first_difference(a, b) == (None, 0.0)
