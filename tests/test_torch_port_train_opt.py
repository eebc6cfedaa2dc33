"""The port's optimizer, learning-rate schedule and train step against
optax and the JAX trainer.

(a) The optimizer alone (clip by global norm 2.5, L2 decay 1e-5, Adam,
    the one-cycle LR) fed the same gradient trees as the optax chain of
    ``pvo_tpu.parallel.data_parallel.make_optimizer`` for 20 steps, some
    above the clip norm and some below: params within 1e-6.
(b) ``onecycle_lr`` and the LR the optimizer applies at each step,
    against ``optax.cosine_onecycle_schedule(pct_start=0.01)`` at every
    step of a 100-step and a 300-step run (and after them): within 1e-6
    relative.
(c) One ``make_train_step`` step on a 2-sample batch (48x64, F=3, sup,
    2 iterations, the tamed bridged weights of
    tests/test_torch_port_train_step.py) against JAX's jitted step plus
    optax: the loss within 1e-4 relative; the port's step equal (1e-6)
    to optax's chain applied to the port's own mean gradient, which
    (a) of tests/test_torch_port_train_step.py holds within 1e-3 a tensor
    of JAX's; and each tensor's update (after - before) against the JAX
    step's, leaving out tensors whose gradient is under 1e-4 of the
    total norm. Adam's first step is about lr * sign(g), so an element
    whose gradient is at noise level can flip its sign. The gradients
    agree to about 3.5e-4 relative L2 a tensor (two iterations through
    two BA solves each, f32 against JAX's partly-f64 run), and the flips
    that leaves put whole updates 0.7-1.4% apart (5 of 86 tensors above
    1%, measured): the whole update is held within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pvo_tpu.parallel import data_parallel as jdp
from pvo_tpu.utils.convert import convert_droidnet
from pvo_tpu.vo.net.droidnet import DroidNet as JaxDroidNet
from pvo_tpu_torch.parallel import data_parallel as dp
from pvo_tpu_torch.utils.convert import droidnet_from_jax

from test_torch_port_train_step import (II, ITERS, JJ, TREES, jax_params,
                                        jit_fast, the_batch, to_port,
                                        variables)
from torch_one_thread import one_thread  # noqa: F401


def test_optimizer_matches_optax():
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 2, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = jdp.make_optimizer(lr=5e-4, total_steps=100)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = dp.make_optimizer(tp.values(), lr=5e-4, total_steps=100)
    for step in range(20):
        # every third step's gradient is above the clip norm (2.5)
        scale = 3.0 if step % 3 == 0 else 0.1
        g = {k: (scale * rng.randn(*s)).astype(np.float32)
             for k, s in shapes.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        assert all(p.grad is None for p in tp.values())
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert np.abs(tp["a"].detach().numpy() - params["a"]).max() > 1e-3


@pytest.mark.parametrize("total", [100, 300])
def test_lr_schedule_matches_optax(total):
    sched = optax.cosine_onecycle_schedule(total, 5e-4, pct_start=0.01)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = dp.make_optimizer([p], lr=5e-4, total_steps=total)
    for k in range(total + 5):
        want = float(sched(k))
        assert abs(dp.onecycle_lr(k, total, 5e-4) - want) <= 1e-6 * want, k
        applied = opt.adam.param_groups[0]["lr"]
        assert abs(applied - want) <= 1e-6 * want, k
        p.grad = torch.ones(3)
        opt.step()
    # the peak is reached at int(0.01 * total), as in optax
    peak = int(0.01 * total)
    assert dp.onecycle_lr(peak, total, 5e-4) == pytest.approx(5e-4, rel=1e-12)


def test_lr_schedule_skips_a_phase_of_zero_steps():
    """Under 100 steps the warm-up phase has int(0.01 * total) = 0
    steps: optax's schedule divides by that length (NaN); the port's
    starts at the peak and anneals."""
    assert np.isnan(float(optax.cosine_onecycle_schedule(
        50, 5e-4, pct_start=0.01)(0)))
    lrs = [dp.onecycle_lr(k, 50, 5e-4) for k in range(51)]
    assert lrs[0] == pytest.approx(5e-4)
    assert all(a >= b for a, b in zip(lrs, lrs[1:]))
    assert lrs[-1] == pytest.approx(5e-4 / 25 / 1e4)


def test_train_step_matches_jax_and_optax():
    params = jax_params()
    var = variables(params)
    batch = the_batch(seed=3, n=2)
    tx = jdp.make_optimizer(total_steps=100)
    step = jdp.make_train_step(JaxDroidNet(), tx, II, JJ, num_steps=ITERS,
                               mode="sup")
    state = jdp.TrainState(var, tx.init(var), jnp.zeros((), jnp.int32))
    state, mj = jit_fast(step, state, batch)(state, batch)
    upd_j = {k: a.numpy() - b.numpy() for (k, a), b in
             zip(to_port(state.params).items(), to_port(var).values())}

    # the port's mean gradient over the batch, on a second copy
    twin = droidnet_from_jax(params)
    loss, _, _ = dp._batch_loss(twin, dp.to_device(batch, "cpu"), II, JJ,
                                ITERS, {}, "sup", True)
    loss.backward()
    g = {k: p.grad.numpy() for k, p in twin.named_parameters()}
    gn = {k: float(np.linalg.norm(v)) for k, v in g.items()}
    total = np.sqrt(sum(n ** 2 for n in gn.values()))

    net = droidnet_from_jax(params)
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    opt = dp.make_optimizer(net.parameters(), total_steps=100)
    tstep = dp.make_train_step(net, opt, II, JJ, num_steps=ITERS, mode="sup")
    st, mt = tstep(dp.TrainState(net, opt), dp.to_device(batch, "cpu"))
    assert st.step == 1
    assert float(mt["loss"]) == float(loss)
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= \
        1e-4 * abs(float(mj["loss"]))
    assert mt.keys() == mj.keys()

    # the port's step is optax's chain on the port's gradient
    gtree = convert_droidnet(g)
    upd, _ = tx.update({"params": {k: gtree[k]["params"] for k in TREES}},
                       tx.init(var), var)
    want = to_port(optax.apply_updates(var, upd))
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)

    # and its update against the JAX step's, tensor by tensor
    n, worst = 0, 0.0
    for k, p in net.named_parameters():
        if gn[k] < 1e-4 * total:
            continue
        u = (p.detach() - before[k]).numpy().ravel()
        uj = upd_j[k].ravel()
        r = np.linalg.norm(u - uj) / np.linalg.norm(uj)
        assert r <= 2e-2, (k, r)
        worst = max(worst, r)
        n += 1
    assert n >= 60
    print(f"train step: loss {float(mt['loss']):.6g}, {n} tensors, worst "
          f"update {worst:.3g}")
