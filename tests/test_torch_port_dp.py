"""Data-parallel training across processes in the port
(``parallel/data_parallel.py``, ``parallel/multihost.py``,
``vps/train.make_full_train_step_dp``) on the CPU: two gloo ranks
(spawned once for the module, ``tests/torch_dp_ranks.py``) against one
process on the same global batch, and the VPS step against the JAX
``make_full_train_step_dp`` on two of the 8 virtual CPU devices.

* The VO train step (sup, 48x64, F=4, 2 iterations, tamed weights,
  global batch 2, two steps; rank 1 starts from other weights and takes
  rank 0's through ``replicate``) and the restart step (two outer
  steps, the restart draws from a seed whose first step restarts once):
  the ranks' parameters bit-equal to each other; the first step's
  applied gradient within ``GRAD_TOL`` relative L2 of the one process's
  in every tensor (measured 8e-8: the shares' sum rounds otherwise);
  the losses within 1e-5 relative; after two steps at least
  ``PARAM_EQUAL`` of the parameters within 1e-6 of the one process's
  and all within ``PARAM_TOL``, twice the peak learning rate (Adam moves
  an entry by about the learning rate whatever its gradient's size, so
  an entry whose gradient is near zero can move either way; measured
  2.6e-4, 0.02% of the entries above 1e-6). Rank 1 asks ``restart_rng``
  for another seed, and still runs rank 0's passes: unequal restart
  draws cannot happen.
* The VPS full step (1-block Panoptic FPN at 64x96 on bridged JAX
  weights, two different samples, the RPN subsample of step k on the
  JAX draws of ``fold_in(PRNGKey(17), k)``, two solver steps at lr
  1e-3): the ranks' parameters within ``VPS_TOL`` of one process's on
  both samples, the metrics within 1e-5 relative; the first step's
  update within 1e-4 of its largest entry of the JAX data-parallel
  step's (FrozenBN excluded, J5) and its metrics within 1e-5 relative.
* ``multihost``: degenerate without a process group (the JAX helpers'
  single-host test, ``tests/test_multichip.py``) and with two ranks.
* ``shard_batch`` and the trainers' CLIs refuse a global batch that does
  not divide by the world size; ``make_mesh``
  raises where a requested group cannot be formed; the one-process DP
  step (which ``make_full_train_step`` runs) equals the plain one-card
  VPS step written out, bit for bit.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vps import panoptic_fpn as jpfpn
from pvo_tpu.vps import train as jtrain
from pvo_tpu_torch.parallel import data_parallel as dp
from pvo_tpu_torch.parallel import multihost as mh
from pvo_tpu_torch.utils import convert_vps
from pvo_tpu_torch.vps import train as vtrain

import torch_dp_ranks as ranks
from test_torch_port_vps_train import (FAST_COMPILE, LOSS_KW, draws,
                                       frozen_bn_names, jit_fast, the_batch)
from torch_one_thread import one_thread  # noqa: F401

WORLD = 2
# two restart passes in the first outer step, one in the second
RNG_SEED = 3
GRAD_TOL, PARAM_EQUAL, PARAM_TOL = 1e-6, 0.999, 1e-3
VPS_TOL, LOSS_RTOL = 1e-5, 1e-5
VPS_STEPS, VPS_LR = 2, 1e-3
JAX_KEYS = ("image", "gt_boxes", "gt_classes", "gt_valid", "sem_labels",
            "gt_masks")


@pytest.fixture(autouse=True, scope="module")
def _no_x64():
    """f32 on both sides (tests/conftest.py turns x64 on)."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def vps_global_batch():
    """Two different samples (tests/test_vps_train.py's batch from two
    seeds), the JAX layout with a leading batch axis."""
    a, b = the_batch(1), the_batch(2)
    return {k: np.stack([a[k], b[k]]) for k in JAX_KEYS}


@pytest.fixture(scope="module")
def jax_init():
    """(JAX variables of the 1-block Panoptic FPN, their bridged state
    dict)."""
    jm = jpfpn.PanopticFPN(backbone_blocks=ranks.VPS_BLOCKS)
    img = jnp.asarray(vps_global_batch()["image"][0])
    params = jax.tree.map(np.asarray, jit_fast(jm.init, jax.random.PRNGKey(1),
                                               img)(jax.random.PRNGKey(1),
                                                    img))
    model = convert_vps.panoptic_fpn_from_jax(params)
    return params, {k: v.detach().numpy()
                    for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_vps(jax_init):
    """(JAX variables, their bridged state dict, the JAX data-parallel
    step's parameters after each step, its metrics)."""
    params, sd = jax_init
    jm = jpfpn.PanopticFPN(backbone_blocks=ranks.VPS_BLOCKS)
    batch = vps_global_batch()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    tx = jtrain.make_solver(base_lr=VPS_LR, warmup_iters=0, params=params)
    step, data_sh, repl_sh = jtrain.make_full_train_step_dp(jm, tx, mesh,
                                                            **LOSS_KW)
    state = jtrain.TrainState(params, tx.init(params),
                              jnp.zeros((), jnp.int32))
    state = jax.tree.map(lambda x: jax.device_put(x, repl_sh), state)
    jb = {k: jax.device_put(jnp.asarray(v), data_sh)
          for k, v in batch.items()}
    compiled = step.lower(state, jb).compile(FAST_COMPILE)
    after, metrics = [], []
    for _ in range(VPS_STEPS):
        state, m = compiled(state, jb)
        after.append(convert_vps.state_dict_from_jax(
            jax.tree.map(np.asarray, state.params)))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, sd, after, metrics


@pytest.fixture(scope="module")
def inputs(jax_init):
    _, sd = jax_init
    return {"vo_batch": dp.make_synthetic_batch(WORLD, F=ranks.F, H=48,
                                                W=64, seed=0),
            "rng_seed": RNG_SEED, "vps_state": sd,
            "vps_batch": vps_global_batch(),
            "priorities": [draws(k)[1] for k in range(VPS_STEPS)]}


@pytest.fixture(scope="module")
def two_ranks(inputs, request):
    """Every scenario on two gloo ranks, one spawn for the module; the
    one-process scenarios and the JAX steps run here meanwhile."""
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(dp.spawn, ranks.all_scenarios, WORLD,
                                (inputs,), device="cpu", threads=1,
                                timeout=600)
        request.getfixturevalue("one_process")
        request.getfixturevalue("jax_vps")
        return ranks_run.result()


@pytest.fixture(scope="module")
def one_process(inputs):
    """The same scenarios in this process, without a process group, on
    the whole global batch."""
    mesh = dp.Mesh()
    return {"train": ranks.vo_train_steps(mesh, inputs["vo_batch"]),
            "restart": ranks.vo_restart_steps(mesh, inputs["vo_batch"],
                                              inputs["rng_seed"]),
            "vps": ranks.vps_steps(mesh, inputs["vps_state"],
                                   inputs["vps_batch"],
                                   inputs["priorities"])}


def assert_params_close(a, b, tol):
    assert a.keys() == b.keys()
    worst = max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
                for k in a if a[k].size)
    assert worst <= tol, worst


def ranks_bit_equal(result):
    r0, r1 = result
    for k, v in r0["params"].items():
        np.testing.assert_array_equal(v, r1["params"][k], err_msg=k)


@pytest.mark.parametrize("scenario", ["train", "restart"])
def test_two_ranks_equal_one_process_vo(two_ranks, one_process, scenario):
    ranks_bit_equal([r[scenario] for r in two_ranks])
    got, want = two_ranks[0][scenario], one_process[scenario]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    g, w = got["grads"][0], want["grads"][0]
    assert g.keys() == w.keys() and len(w) > 100
    total = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                        for v in w.values()))
    for k, v in w.items():
        err = np.linalg.norm(g[k] - v) / max(np.linalg.norm(v),
                                             1e-4 * total)
        assert err <= GRAD_TOL, (k, err)
    d = np.concatenate([np.abs(got["params"][k].astype(np.float64) -
                               want["params"][k]).ravel()
                        for k in want["params"]])
    assert (d <= 1e-6).mean() >= PARAM_EQUAL and d.max() <= PARAM_TOL, \
        ((d > 1e-6).mean(), d.max())


def test_restart_draws_are_rank_zeros(two_ranks, one_process):
    """Rank 1 seeds its restart generator with RNG_SEED + 1, whose first
    outer step would not restart: it runs rank 0's passes all the
    same, and its generator stays in step with rank 0's."""
    r0, r1 = (r["restart"] for r in two_ranks)
    assert r0["passes"] == r1["passes"] == one_process["restart"]["passes"]
    assert r0["passes"] == [2, 1]
    np.testing.assert_array_equal(r0["next_draws"], r1["next_draws"])
    alone = np.random.default_rng(RNG_SEED + 1)
    assert alone.random() >= 0.2   # its own first step: no restart


def test_two_ranks_equal_one_process_vps(two_ranks, one_process):
    ranks_bit_equal([r["vps"] for r in two_ranks])
    got, want = two_ranks[0]["vps"], one_process["vps"]
    for m, w in zip(got["metrics"], want["metrics"]):
        for k in w:
            assert abs(m[k] - w[k]) <= LOSS_RTOL * abs(w[k]) + 1e-7, k
    assert_params_close(got["params"], want["params"], VPS_TOL)


def test_two_ranks_match_the_jax_dp_step(two_ranks, jax_vps, inputs):
    """The first step's loss and metrics within 1e-5 relative of the JAX
    step's (measured 5e-7) and its update (from the bridged weights)
    within 1e-4 of its largest entry, FrozenBN excluded. The second step
    is held against one process only: the JAX solver has moved the
    FrozenBN statistics by then (J5), and the forward differs by 3e-4."""
    _, before, jafter, jmetrics = jax_vps
    got = two_ranks[0]["vps"]
    m, w = got["metrics"][0], jmetrics[0]
    assert m.keys() == w.keys()
    for k in w:
        assert abs(m[k] - w[k]) <= LOSS_RTOL * abs(w[k]), (k, m[k], w[k])
    from pvo_tpu_torch.vps.panoptic_fpn import PanopticFPN
    skip = frozen_bn_names(PanopticFPN(backbone_blocks=ranks.VPS_BLOCKS))
    want = {k: v.numpy() for k, v in jafter[0].items()}
    moved = 0
    for name, w in want.items():
        if name in skip:
            continue
        upd = got["first_params"][name] - before[name]
        jupd = w - before[name]
        scale = float(np.abs(jupd).max())
        assert float(np.abs(upd - jupd).max()) <= 1e-4 * scale + 1e-6, name
        moved += scale > 0
    assert moved > 0.9 * (len(want) - len(skip))


def test_multihost_helpers_with_two_ranks(two_ranks):
    got = [r["multihost"] for r in two_ranks]
    assert [g["count"] for g in got] == [2, 2]
    assert [g["main"] for g in got] == [True, False]
    for g in got:
        np.testing.assert_array_equal(
            g["global"], np.repeat(np.arange(2, dtype=np.float32), 2)
            [:, None].repeat(3, 1))
        assert g["payloads"] == [{"rank": 0}, 0, {"rank": 1}, 10]


def test_trainers_refuse_a_batch_that_does_not_divide(two_ranks):
    """``--batch`` is the global batch: 3 on two ranks raises on both."""
    for r in two_ranks:
        for name in ("train_vo", "train_vps"):
            assert "does not divide by the world size 2" in r["cli"][name]


def test_multihost_helpers_degenerate_without_a_group():
    assert mh.process_count() == 1 and mh.is_main_process()
    batch = {"x": np.arange(8, dtype=np.float32).reshape(2, 4)}
    g = mh.global_batch_from_local(batch)
    assert torch.is_tensor(g["x"])
    np.testing.assert_array_equal(g["x"].numpy(), batch["x"])
    payloads = [{"id": 1}, {"id": 2}]
    assert mh.gather_payloads(payloads) == payloads
    mh.sync()


def test_shard_batch_slices_and_refuses_a_remainder():
    batch = {"a": np.arange(6), "b": np.arange(12).reshape(6, 2)}
    parts = [dp.shard_batch(batch, r, 3) for r in range(3)]
    np.testing.assert_array_equal(
        np.concatenate([p["b"] for p in parts]), batch["b"])
    with pytest.raises(ValueError, match="does not divide"):
        dp.shard_batch(batch, 0, 4)


def test_make_mesh_raises_where_a_group_cannot_form(monkeypatch):
    """WORLD_SIZE asks for a group; without MASTER_ADDR it cannot form,
    and the trainer must not go on as one process."""
    for key in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        dp.make_mesh("cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("WORLD_SIZE")
    mesh = dp.make_mesh("cpu")
    assert (mesh.world, mesh.distributed) == (1, False)


def test_dp_vps_step_of_one_sample_is_the_one_card_step(inputs):
    """Without a process group, on one sample, the data-parallel step
    (and ``make_full_train_step``, which runs it) is the plain one-card
    step written out, bit for bit over two steps: the sample's losses,
    one backward, the solver's step."""
    from pvo_tpu_torch.vps.panoptic_fpn import PanopticFPN
    sample = vtrain.to_device({k: v[0] for k, v in
                               inputs["vps_batch"].items()}, "cpu")
    pri = inputs["priorities"]

    def rng_fn(step, device):
        return torch.as_tensor(np.array(pri[step]))

    def by_hand(model, tx):
        def step(state, b):
            loss, _ = vtrain.panoptic_losses(
                model, b["image"], None, b["gt_boxes"], b["gt_classes"],
                b["gt_valid"], b["sem_labels"], gt_masks=b["gt_masks"],
                rng=rng_fn(state.step, "cpu"), **ranks.VPS_LOSS_KW)
            loss.backward()
            tx.step()
            state.step += 1
            return state, {"loss": loss.detach()}
        return step, sample

    def dp_step(model, tx):
        return (vtrain.make_full_train_step_dp(
            model, tx, None, rng_fn=rng_fn, **ranks.VPS_LOSS_KW),
            {k: v[None] for k, v in sample.items()})

    def one_card(model, tx):
        return (vtrain.make_full_train_step(
            model, tx, rng_fn=rng_fn, **ranks.VPS_LOSS_KW), sample)

    out = []
    for make in (by_hand, dp_step, one_card):
        model = PanopticFPN(backbone_blocks=ranks.VPS_BLOCKS)
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in inputs["vps_state"].items()})
        model.train()
        tx = vtrain.make_solver(model, base_lr=VPS_LR, warmup_iters=0)
        step, b = make(model, tx)
        state, losses = vtrain.TrainState(model, tx), []
        for _ in range(VPS_STEPS):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        out.append((ranks.numpy_params(model), losses))
    for params, losses in out[1:]:
        assert losses == out[0][1]
        for k, v in out[0][0].items():
            np.testing.assert_array_equal(v, params[k], err_msg=k)


def test_dryruns_on_one_process():
    """``dryrun`` and ``dryrun_dp`` at world size 1 on the CPU: one step
    each, finite metrics (the JAX dry runs' keys)."""
    vps = vtrain.dryrun_dp(1, device="cpu")
    assert set(vps) == {"loss", "rpn_obj", "rpn_loc", "cls", "box_loc",
                        "sem_seg", "mask"}
    vo = dp.dryrun("cpu", num_steps=1, dry=True)
    assert {"loss", "res", "geo"} <= set(vo)
    assert np.isfinite(list(vps.values()) + list(vo.values())).all()
