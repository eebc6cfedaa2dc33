"""The port's training forward and restart step against the JAX trainer.

(a) ``vo_loss_fn``'s gradient through the restart step's ``pass_fn``
    (``make_restart_step``), in sup here, in semisup and unsup in
    tests/test_torch_port_train_modes.py, at 48x64, F=3
    (the ring of train_vo: all 6 pairs, one free pose), 2 iterations,
    on bridged weights: the JAX gradient tree goes through
    ``params_from_jax`` (a linear re-layout) to the port's names.
    Tensors under 1e-4 of the total norm are skipped. In sup and semisup
    every other weight tensor is within 1e-3 relative L2 of JAX's; in
    unsup ``self_label_masks`` thresholds the full-minus-camera flow at
    0.5 (losses.py:439), where rounding can flip a label, so the
    criterion is tests/test_nets.py's (cos > 0.99, norm ratio
    0.95-1.05), and the flipped labels are counted and printed.
(b) ``make_restart_step``: a second pass from the first pass's detached
    estimates, ``acc_fn`` and ``apply_fn`` against JAX's: the estimates,
    the summed gradients and each tensor's update (1e-2 relative L2:
    Adam's first step is about lr * sign(g)).
(c) ``remat=True`` against ``remat=False`` in the port: the same loss
    and gradients within 1e-6 relative.
(d) The corr kernels' refusal under grad, and B1: the affine-brightness
    head against the JAX module, reference keys loading, the forward's
    ``aff_params``, and VOSystem with ``use_aff_bri`` tracking 8 frames.

Weights: the export test's tamed weights (flow/mask heads x0.01, mask
bias -2), so the dynamic-mask gate does not flip on rounding between the
two packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.parallel import data_parallel as jdp
from pvo_tpu.vo import system as jsys
from pvo_tpu.vo.net.droidnet import DroidNet as JaxDroidNet
from pvo_tpu_torch.parallel import data_parallel as dp
from pvo_tpu_torch.scripts.train_vo import ring_edges
from pvo_tpu_torch.utils.config import VOConfig
from pvo_tpu_torch.utils.convert import (droidnet_from_jax, load_droidnet_torch,
                                         params_from_jax)
from pvo_tpu_torch.vo import losses
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.vo.system import VOSystem

from test_torch_port_system import H as sys_H
from test_torch_port_system import W as sys_W
from test_torch_port_system import synth_stream as sys_stream
from test_torch_port_system import tame_params
from torch_one_thread import one_thread  # noqa: F401

H, W, F, ITERS = 48, 64, 3, 2
II, JJ = ring_edges(F)
TREES = ("fnet", "cnet", "update", "agg")


def jax_params(use_aff_bri=False):
    params = tame_params(jsys.init_params(jsys.make_modules(use_aff_bri),
                                          image_size=(H, W), seed=0))
    conv = params["update"]["params"]["delta_mask"]["conv1"]["Conv_0"]
    conv["bias"] = conv["bias"] - np.float32(2.0)
    return params


def variables(params):
    return {"params": {k: jax.tree.map(jnp.asarray, params[k]["params"])
                       for k in TREES}}


def to_port(tree):
    """A JAX ``{"params": {fnet, cnet, update, agg}}`` tree (params or
    gradients) under the port's state-dict names."""
    tree = jax.device_get(tree)["params"]
    return params_from_jax({k: {"params": tree[k]} for k in TREES})


def the_batch(seed=0, n=1):
    return jdp.make_synthetic_batch(n, F=F, H=H, W=W, seed=seed)


# XLA:CPU compiles the JAX trainer's programs in 13-14 s with these
# options against 19-20 s without (48x64, F=3, 2 iterations; losses equal
# to 3e-7 relative)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jit_fast(fn, *args):
    """``fn`` compiled for ``args`` with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def jax_pass(var, mode, batch):
    """The JAX restart step's compiled pass_fn for ``mode`` and its
    (apply_fn, acc_fn, tx)."""
    tx = jdp.make_optimizer(total_steps=100)
    pass_fn, apply_fn, acc_fn = jdp.make_restart_step(
        JaxDroidNet(), tx, II, JJ, num_steps=ITERS, mode=mode)
    return (jit_fast(pass_fn, var, batch, batch["poses_init"],
                     batch["disps_init"]), apply_fn, acc_fn, tx)


@pytest.fixture(scope="module")
def weights():
    params = jax_params()
    return variables(params), params


@pytest.fixture(scope="module")
def jax_sup(weights):
    """The JAX sup pass on the batch: ((loss, metrics, grads, est),
    (pass_fn, apply_fn, acc_fn, tx))."""
    batch = the_batch()
    fns = jax_pass(weights[0], "sup", batch)
    return fns[0](weights[0], batch, batch["poses_init"],
                  batch["disps_init"]), fns


def port_step(params, mode, remat=False):
    net = droidnet_from_jax(params)
    tx = dp.make_optimizer(net.parameters(), total_steps=100)
    fns = dp.make_restart_step(net, tx, II, JJ, num_steps=ITERS, mode=mode,
                               remat=remat)
    return net, tx, fns


def norms(g):
    return {k: float(np.linalg.norm(np.asarray(v, np.float64)))
            for k, v in g.items()}


def compare_grads(gt, gj, criterion):
    """Per tensor, skipping those under 1e-4 of the total norm; returns
    the worst relative L2 difference (or worst 1 - cos) and the number
    of tensors compared."""
    gt = {k: v.detach().numpy().astype(np.float64) for k, v in gt.items()}
    gj = {k: v.numpy().astype(np.float64) for k, v in gj.items()}
    assert gt.keys() == gj.keys()
    total = np.sqrt(sum(n ** 2 for n in norms(gj).values()))
    worst, n = 0.0, 0
    for k in gj:
        a, b = gt[k].ravel(), gj[k].ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert np.isfinite(a).all(), k
        if max(na, nb) < 1e-4 * total:
            continue
        n += 1
        if criterion == "rel":
            r = np.linalg.norm(a - b) / nb
            assert r < 1e-3, (k, r)
            worst = max(worst, r)
        else:
            cos = a @ b / (na * nb)
            assert cos > 0.99, (k, cos)
            assert 0.95 < na / nb < 1.05, (k, na / nb)
            worst = max(worst, 1 - cos)
    return worst, n


def check_mode(weights, mode, jax_out):
    """The port's pass against the JAX pass's (loss, metrics, grads,
    est); returns a line to print."""
    _, params = weights
    loss_j, met_j, grads_j, est_j = jax_out
    net, _, (pass_fn, _, _) = port_step(params, mode)
    batch = dp.to_device(the_batch(), "cpu")
    loss, met, grads, est = pass_fn(batch, batch["poses_init"],
                                    batch["disps_init"])
    assert abs(float(loss) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    assert met.keys() == met_j.keys()
    for k in met_j:
        np.testing.assert_allclose(float(met[k]), float(met_j[k]),
                                   rtol=1e-3, atol=1e-6, err_msg=k)
    worst, n = compare_grads(grads, to_port(grads_j),
                             "cos" if mode == "unsup" else "rel")
    assert n >= 60
    for a, b in zip(est, est_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    return f"{mode}: loss {float(loss):.6g}, {n} tensors, worst {worst:.3g}"


def test_vo_loss_gradients_match_jax(weights, jax_sup):
    print(check_mode(weights, "sup", jax_sup[0]))


def test_restart_pass_accumulate_and_apply_match_jax(weights, jax_sup):
    var, params = weights
    (loss1, _, g1, (pi, di)), (j_pass, j_apply, j_acc, jtx) = jax_sup
    batch = the_batch()
    loss2, _, g2, est2 = j_pass(var, batch, pi, di)
    summed_j = j_acc(g1, g2)

    net, tx, (pass_fn, apply_fn, acc_fn) = port_step(params, "sup")
    bt = dp.to_device(batch, "cpu")
    _, _, t1, (pt, dt) = pass_fn(bt, bt["poses_init"], bt["disps_init"])
    # the carry is detached: the second pass cannot reach the first graph
    assert not pt.requires_grad and not dt.requires_grad
    l2, _, t2, est_t = pass_fn(bt, pt, dt)
    assert abs(float(l2) - float(loss2)) <= 1e-4 * abs(float(loss2))
    for a, b in zip(est_t, est2):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    # the second pass starts from estimates that agree to 1e-4, not from
    # the same inputs: the sum is held by direction and norm
    worst, _ = compare_grads(acc_fn(t1, t2), to_port(summed_j), "cos")
    print(f"restart: summed gradients, worst 1 - cos {worst:.3g}")

    # apply_fn on JAX's summed gradients: clip, decay, Adam, the LR of
    # step 0, one step, as the JAX apply_fn
    state = jax.jit(j_apply)(jdp.TrainState(var, jtx.init(var), jnp.zeros(
        (), jnp.int32)), summed_j)
    st = apply_fn(dp.TrainState(net, tx),
                  {k: torch.from_numpy(v.numpy().copy())
                   for k, v in to_port(summed_j).items()})
    assert st.step == 1
    after = to_port(state.params)
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_remat_gives_the_same_gradients(weights):
    _, params = weights
    batch = dp.to_device(the_batch(seed=1), "cpu")
    out = []
    for remat in (False, True):
        _, _, (pass_fn, _, _) = port_step(params, "semisup", remat=remat)
        out.append(pass_fn(batch, batch["poses_init"], batch["disps_init"]))
    (l0, _, g0, _), (l1, _, g1, _) = out
    assert abs(float(l0) - float(l1)) <= 1e-6 * abs(float(l0))
    for k in g0:
        d = (g0[k] - g1[k]).norm()
        assert d <= 1e-6 * max(float(g0[k].norm()), 1e-30), k


# ---- (d) the refusal under grad, and B1

def forward_args(seed=2):
    b = {k: torch.from_numpy(v[0]) for k, v in the_batch(seed).items()}
    return (b["poses_init"], b["images"], b["disps_init"], b["intrinsics"],
            II, JJ)


def test_cuda_corr_route_is_refused_under_grad():
    net = DroidNet.from_seed(0)
    args = forward_args()
    with pytest.raises(RuntimeError, match="no backward"):
        net(*args, num_steps=1, corr_impl="cuda")
    with torch.no_grad():
        net(*args, num_steps=1, corr_impl="cuda")
    net(*args, num_steps=1, corr_impl="plain")
    # on meta tensors, which reach the route's check without a card
    fm = torch.empty(F, 6, 8, 128, device="meta", requires_grad=True)
    ii = torch.as_tensor(II, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        DroidNet._corr_fn(fm, ii, ii, "cuda")
    DroidNet._corr_fn(fm.detach(), ii, ii, "cuda")


@pytest.fixture(scope="module")
def aff_weights():
    params = jax_params(use_aff_bri=True)
    return params, droidnet_from_jax(params)


def test_aff_head_matches_jax(aff_weights):
    params, net = aff_weights
    assert net.use_aff_bri
    rng = np.random.RandomState(3)
    args = [np.tanh(rng.randn(5, 6, 8, 128)), rng.randn(5, 6, 8, 128),
            rng.randn(5, 6, 8, 196), rng.randn(5, 6, 8, 8)]
    args = [a.astype(np.float32) for a in args]
    mods = jsys.make_modules(use_aff_bri=True)
    out_j = mods["update"].apply(params["update"], *map(jnp.asarray, args))
    with torch.no_grad():
        out_t = net.update(*map(torch.from_numpy, args))
    assert set(out_t) == set(out_j)
    assert tuple(out_t["aff_params"].shape) == (5, 2)
    np.testing.assert_allclose(out_t["aff_params"].numpy(),
                               np.asarray(out_j["aff_params"]), rtol=0,
                               atol=1e-5)
    # the other outputs as tests/test_torch_port_net.py holds them
    for k in out_j:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_aff_reference_keys_load(aff_weights, tmp_path):
    params, net = aff_weights
    sd = {f"module.{k}": v for k, v in params_from_jax(params).items()}
    assert "module.update.global_avg_pool.0.weight" in sd
    assert "module.update.param_linear.0.bias" in sd
    torch.save(sd, tmp_path / "aff.pth")
    loaded = load_droidnet_torch(str(tmp_path / "aff.pth"))
    assert loaded.use_aff_bri
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_aff_forward_outputs_and_gradient(aff_weights):
    """The forward collects per-step aff_params (1, E, 2); the full
    photometric loss with them backpropagates into the head."""
    _, net = aff_weights
    out = net(*forward_args(), num_steps=2, ret_flow=True, corr_impl="plain")
    assert len(out["aff_params"]) == 2
    assert tuple(out["aff_params"][0].shape) == (1, len(II), 2)
    # full-res flows: 6 edges of 48x64x3 valid entries, the mean's branch
    imgs = forward_args()[1].float()
    loss, _ = losses.photo_loss_full(imgs, out["flows"], None, II, JJ,
                                     aff_params=out["aff_params"],
                                     downsample=False)
    assert loss.item() > 0
    loss.backward()
    assert net.update.param_linear[0].weight.grad.abs().sum() > 0
    assert net.update.global_avg_pool[0].weight.grad is not None


def test_vosystem_with_aff_head_tracks(aff_weights):
    """tests/test_torch_port_system.py's 8-frame stream and configuration
    with the head; the tracker ignores its output, as the JAX one does."""
    _, net = aff_weights
    cfg = VOConfig(image_size=(sys_H, sys_W), warmup=5, filter_thresh=-1.0,
                   keyframe_thresh=0.0,
                   segm_filter=True, max_edges=48, frontend_window=8,
                   use_aff_bri=True)
    sysm = VOSystem(cfg, net=net, device="cpu", net_dtype=torch.float32)
    for t, img, intr, segm in sys_stream(8):
        sysm.track(t, img, intr, segments=segm)
    assert sysm.frontend.is_initialized and sysm.video.counter == 7
    assert np.isfinite(sysm.get_traj()).all()
    with pytest.raises(ValueError, match="affine-brightness"):
        VOSystem(cfg, net=DroidNet.from_seed(0), device="cpu")
