"""VPS training in the port (``pvo_tpu_torch.vps.train``) against
:mod:`pvo_tpu.vps.train` on the CPU: the 1-block Panoptic FPN at 64x96 on
bridged weights (``panoptic_fpn_from_jax``), the batch of
``tests/test_vps_train.py``.

* ``panoptic_losses``, full and fusion: the loss and each term within
  1e-4 relative, every parameter's gradient within 1e-4 of its largest
  entry against ``jax.grad`` (mapped by ``state_dict_from_jax``: fc1's
  columns permuted, J1), the RPN subsample fed the JAX draws of
  ``fold_in(PRNGKey(17), 0)``. The JAX gradient is jitted with XLA's
  fast-compile options (7 s; eagerly it takes 93 s, and the JAX
  package's own tests mark such cases slow); the port's gradients are
  within 5e-5 of either.
* Each solver on the JAX gradients: the parameters within 1e-6 of the
  optax chain's after three steps (warmup, momentum, decay). Each step
  function on its own gradients: the update within 1e-4 of the JAX
  step's. The fusion step moves only ``fusion_conv1``.
* J5: the JAX ``FrozenBN`` statistics get gradients and the JAX solver
  moves them; the port's step leaves its buffers bit-equal.
* The decay set equals the JAX ``_decay_mask`` by name; two full steps
  lower the loss; every head gets a gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pvo_tpu.vps import panoptic_fpn as jpfpn
from pvo_tpu.vps import train as jtrain
from pvo_tpu_torch.utils import convert_vps
from pvo_tpu_torch.vps import train
from pvo_tpu_torch.vps.panoptic_fpn import PanopticFPN, init_weights

from torch_one_thread import one_thread  # noqa: F401

H, W = 64, 96
BLOCKS = (1, 1, 1, 1)
LOSS_KW = dict(max_props=64, pre_nms_topk=128)
GRAD_TOL, STEP_TOL = 1e-4, 1e-6
# XLA:CPU compiles and runs the loss's gradient in 7 s with these options
# (level 0: 24 s, the unoptimized program runs 17 s)
FAST_COMPILE = {"xla_backend_optimization_level": 1,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _no_x64():
    """f32 on both sides (tests/conftest.py turns x64 on)."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def jit_fast(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def the_batch(seed=1):
    """tests/test_vps_train.py's batch (numpy, the JAX layout), with a
    reference frame for the fusion mode."""
    key = jax.random.PRNGKey(seed)
    x = np.asarray(jax.random.normal(key, (1, H, W, 3)) * 20 + 90)
    masks = np.zeros((4, H, W), np.float32)
    masks[0, 8:40, 8:40] = 1.0
    masks[1, 10:50, 20:60] = 1.0
    return {
        "image": x, "cur_image": x, "ref_image": x + 1.0,
        "flow": np.zeros((H, W, 2), np.float32),
        "gt_boxes": np.asarray([[8., 8., 40., 40.], [20., 10., 60., 50.],
                                [0., 0., 1., 1.], [0., 0., 1., 1.]],
                               np.float32),
        "gt_classes": np.asarray([1, 2, 0, 0], np.int32),
        "gt_valid": np.asarray([True, True, False, False]),
        "sem_labels": np.full((1, H, W), 3, np.int32),
        "gt_masks": masks,
    }


N_ANCHORS = 3 * (16 * 24 + 8 * 12 + 4 * 6 + 2 * 3 + 1 * 2)


def draws(step):
    key = jax.random.fold_in(jax.random.PRNGKey(17), step)
    return key, np.asarray(jax.random.uniform(key, (N_ANCHORS,)))


def jax_loss_fn(model, batch, warped):
    """The JAX loss of the batch; ``warped``: the warped reference
    features (fusion) or None (full)."""
    key, _ = draws(0)
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jtrain.panoptic_losses(
            model, p, b["cur_image"], warped, b["gt_boxes"],
            b["gt_classes"], b["gt_valid"], b["sem_labels"],
            gt_masks=b["gt_masks"], rng=key, **LOSS_KW)
    return loss_fn


@pytest.fixture(scope="module")
def setup():
    """(JAX model, its variables, the batch, {mode: (loss, metrics,
    grads)} of the JAX loss). In the fusion mode the warped reference
    features are an input of the loss, as in the port's step: no
    parameter they depend on moves."""
    jm = jpfpn.PanopticFPN(backbone_blocks=BLOCKS)
    batch = the_batch()
    init = jit_fast(jm.init, jax.random.PRNGKey(1),
                    jnp.asarray(batch["image"]))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1),
                                           jnp.asarray(batch["image"])))
    def warp(p, ref, flow):
        return jpfpn.flow_warp_features(jm.apply(p, ref, method="features"),
                                        flow)
    args = (params, jnp.asarray(batch["ref_image"]),
            jnp.asarray(batch["flow"]))
    warped = jit_fast(warp, *args)(*args)
    out = {}
    for mode, warp in (("full", None), ("fusion", warped)):
        fn = jax.value_and_grad(jax_loss_fn(jm, batch, warp), has_aux=True)
        (loss, metrics), grads = jit_fast(fn, params)(params)
        out[mode] = (float(loss), {k: float(v) for k, v in metrics.items()},
                     jax.tree.map(np.asarray, grads))
    return jm, params, batch, out


def port_model(params):
    return convert_vps.panoptic_fpn_from_jax(params).train()


def priorities(step, device):
    return torch.from_numpy(draws(step)[1])


def port_loss(model, batch, fusion):
    b = train.to_device(batch, "cpu")
    warped = None
    if fusion:
        with torch.no_grad():
            from pvo_tpu_torch.vps.panoptic_fpn import flow_warp_features
            warped = flow_warp_features(model.features(b["ref_image"]),
                                        b["flow"])
    return train.panoptic_losses(
        model, b["cur_image"], warped, b["gt_boxes"], b["gt_classes"],
        b["gt_valid"], b["sem_labels"], gt_masks=b["gt_masks"],
        rng=priorities(0, "cpu"), **LOSS_KW)


def check_grads(model, jgrads, tol=GRAD_TOL):
    """Every parameter's gradient against the JAX one by name; returns
    the names with a nonzero gradient."""
    ref = convert_vps.state_dict_from_jax(jgrads)
    touched = []
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(ref[name].abs().max())
        err = float((g - ref[name]).abs().max())
        assert err <= tol * scale or err == 0.0, (name, err, scale)
        if scale > 0:
            touched.append(name)
    return touched


@pytest.mark.parametrize("mode", ["full", "fusion"])
def test_panoptic_losses_match_jax(setup, mode):
    _, params, batch, out = setup
    jloss, jmet, jgrads = out[mode]
    model = port_model(params)
    loss, metrics = port_loss(model, batch, mode == "fusion")
    loss.backward()
    assert set(metrics) == set(jmet)
    for k, v in metrics.items():
        assert abs(float(v) - jmet[k]) <= GRAD_TOL * abs(jmet[k]), k
    assert abs(loss.item() - jloss) <= GRAD_TOL * abs(jloss)
    touched = check_grads(model, jgrads)
    # every head learns (tests/test_vps_train.py's criterion); the fusion
    # conv only where it is in the graph
    for part in ("bottom_up", "fpn_", "rpn_head", "box_head",
                 "box_predictor", "mask_head", "sem_seg_head"):
        assert any(part in n for n in touched), part
    assert any("fusion_conv1" in n for n in touched) == (mode == "fusion")


def jax_steps(tx, params, grads, n):
    """``n`` optax steps on the same gradients (jitted: optax's chain
    runs eagerly in 20 s)."""
    def run(params, grads):
        state = tx.init(params)
        for _ in range(n):
            updates, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
        return params
    return jax.tree.map(np.asarray, jit_fast(run, params, grads)(params,
                                                                  grads))


def port_steps(tx, model, grads, n):
    named = dict(model.named_parameters())
    for _ in range(n):
        for name, g in grads.items():
            if name in named and named[name].requires_grad:
                named[name].grad = g.clone()
        tx.step()


def assert_params(model, ref_params, tol=STEP_TOL, skip=()):
    ref = convert_vps.state_dict_from_jax(ref_params)
    sd = model.state_dict()
    for name, want in ref.items():
        if name in skip:
            continue
        err = float((sd[name] - want).abs().max())
        assert err <= tol, (name, err)


def frozen_bn_names(model):
    return set(model.state_dict()) - set(dict(model.named_parameters()))


def test_fusion_solver_matches_optax(setup):
    jm, params, _, out = setup
    grads = out["fusion"][2]
    ref = jax_steps(jtrain.make_fusion_optimizer(params, lr=1e-2), params,
                    grads, 3)
    model = port_model(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    port_steps(train.make_fusion_optimizer(model, lr=1e-2), model,
               convert_vps.state_dict_from_jax(grads), 3)
    assert_params(model, ref)
    for name, v in model.state_dict().items():
        moved = not torch.equal(v, before[name])
        assert moved == name.startswith("fusion_conv1."), name


def test_full_solver_matches_optax(setup):
    """Three steps of detectron2's solver (warmup over 2 iterations,
    momentum, decay but on the norms) on the same gradients."""
    jm, params, _, out = setup
    grads = out["full"][2]
    kw = dict(base_lr=1e-3, warmup_iters=2, steps=(2,), gamma=0.5)
    ref = jax_steps(jtrain.make_solver(params=params, **kw), params, grads,
                    3)
    model = port_model(params)
    port_steps(train.make_solver(model, **kw), model,
               convert_vps.state_dict_from_jax(grads), 3)
    assert_params(model, ref, skip=frozen_bn_names(model))


@pytest.mark.parametrize("mode", ["full", "fusion"])
def test_one_step_matches_the_jax_step(setup, mode):
    """The port's step on its own gradients moves every parameter as the
    JAX step does on its own (one step, lr 1e-2 fusion, 1e-3 full): the
    update within 1e-4 of its largest entry; FrozenBN excluded (J5)."""
    jm, params, batch, out = setup
    grads = out[mode][2]
    model = port_model(params)
    if mode == "fusion":
        jtx = jtrain.make_fusion_optimizer(params, lr=1e-2)
        tx = train.make_fusion_optimizer(model, lr=1e-2)
        step = train.make_fusion_train_step(model, tx, rng_fn=priorities,
                                            **LOSS_KW)
    else:
        jtx = jtrain.make_solver(base_lr=1e-3, warmup_iters=0, params=params)
        tx = train.make_solver(model, base_lr=1e-3, warmup_iters=0)
        step = train.make_full_train_step(model, tx, rng_fn=priorities,
                                          **LOSS_KW)
    ref = convert_vps.state_dict_from_jax(jax_steps(jtx, params, grads, 1))
    before = convert_vps.state_dict_from_jax(params)
    state, metrics = step(train.TrainState(model, tx),
                          train.to_device(batch, "cpu"))
    assert state.step == 1
    assert abs(float(metrics["loss"]) - out[mode][0]) <= \
        GRAD_TOL * out[mode][0]
    sd = model.state_dict()
    skip = frozen_bn_names(model)
    moved = set()
    for name, want in ref.items():
        if name in skip:
            continue
        upd, jupd = sd[name] - before[name], want - before[name]
        scale = float(jupd.abs().max())
        assert float((upd - jupd).abs().max()) <= GRAD_TOL * scale + \
            STEP_TOL, name
        if scale > 0:
            moved.add(name)
    if mode == "fusion":
        assert moved == {"fusion_conv1.weight", "fusion_conv1.bias"}
    else:
        assert len(moved) > 0.9 * (len(ref) - len(skip))


def test_frozen_bn_stays_frozen_j5(setup):
    """J5: the JAX package declares FrozenBN's statistics parameters, so
    ``jax.grad`` reaches them and ``make_solver`` moves them (the running
    variances too); the port keeps them as buffers, and its step leaves
    them bit-equal."""
    jm, params, batch, out = setup
    grads = out["full"][2]
    names = convert_vps.jax_param_names(params)
    model = port_model(params)
    bn = frozen_bn_names(model)
    var_paths = [p for p, n in names.items() if n in bn
                 and n.endswith("running_var")]
    assert len(var_paths) == len([n for n in bn if n.endswith("running_var")])

    def leaf(tree, path):
        for k in path.split("/"):
            tree = tree[k]
        return np.asarray(tree)

    assert any(np.abs(leaf(grads["params"], p)).max() > 0 for p in var_paths)
    new = jax_steps(jtrain.make_solver(base_lr=1e-3, warmup_iters=0,
                                       params=params), params, grads, 1)
    assert any(not np.array_equal(leaf(new["params"], p),
                                  leaf(params["params"], p))
               for p in var_paths)

    before = {n: v.clone() for n, v in model.state_dict().items() if n in bn}
    tx = train.make_solver(model, base_lr=1e-3, warmup_iters=0)
    step = train.make_full_train_step(model, tx, rng_fn=priorities,
                                      **LOSS_KW)
    step(train.TrainState(model, tx), train.to_device(batch, "cpu"))
    after = model.state_dict()
    assert all(torch.equal(after[n], before[n]) for n in bn)
    assert not any(p.requires_grad for n, p in model.named_buffers())


def test_decay_set_is_the_jax_decay_mask(setup):
    _, params, _, _ = setup
    mask = jtrain._decay_mask(params)["params"]
    names = convert_vps.jax_param_names(params)
    model = port_model(params)
    port = dict(model.named_parameters())
    seen = 0
    for path, name in names.items():
        node = mask
        for k in path.split("/"):
            node = node[k]
        if name in port:
            assert train.decays(name) == bool(node), name
            seen += 1
    assert seen == len(port)
    assert not all(train.decays(n) for n in port)


def test_two_full_steps_lower_the_loss():
    """tests/test_vps_train.py's criterion on the port alone: random
    weights from a seed, lr 1e-3 without warmup, three step calls."""
    torch.manual_seed(0)
    model = init_weights(PanopticFPN(backbone_blocks=BLOCKS), 2).train()
    tx = train.make_solver(model, base_lr=1e-3, warmup_iters=0)
    step = train.make_full_train_step(model, tx, **LOSS_KW)
    state = train.TrainState(model, tx)
    batch = train.to_device(the_batch(2), "cpu")
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_step_generator_is_seeded_by_the_step():
    a = torch.rand(5, generator=train.step_generator(3, "cpu"))
    b = torch.rand(5, generator=train.step_generator(3, "cpu"))
    c = torch.rand(5, generator=train.step_generator(4, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("module", [
    "sem_seg_head.predictor", "proposal_generator.rpn_head.anchor_deltas"])
def test_a_diverged_step_raises(module):
    """A non-finite loss (detectron2's trainer check) or non-finite
    proposals, whose boxes would index outside the levels, raise
    FloatingPointError, leave no gradient and take no solver step."""
    model = init_weights(PanopticFPN(backbone_blocks=BLOCKS), 3).train()
    with torch.no_grad():
        model.get_submodule(module).bias.fill_(float("inf"))
    tx = train.make_solver(model, base_lr=1e-3, warmup_iters=0)
    step = train.make_full_train_step(model, tx, **LOSS_KW)
    with pytest.raises(FloatingPointError):
        step(train.TrainState(model, tx), train.to_device(the_batch(2),
                                                          "cpu"))
    assert all(p.grad is None for p in model.parameters())
