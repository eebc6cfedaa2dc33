"""The port's device-resident planner (``vo/planner.py``) against the JAX
package's (``pvo_tpu/vo/planner.py``) and against the port's classic path.

1. The six topology operations on the same seeded inputs as the JAX
   planner's functions (the cases of ``tests/test_planner.py``), integer
   outputs and gathered buffers equal exactly.
2. PlannerDriver: precheck's cooldown and refusal logging; an overflow that
   disengages to the classic path and backs off; the frame program
   reads nothing back (every host read raises while it runs).
3. The planner against the classic path under an oracle update core
   (ground-truth reprojection targets, as ``tests/test_planner.py``):
   equal counter, t1, edges with their ages, inactive edges and
   timestamps, trajectories within 1e-3; in the compact regime, and in
   the full-width one on a stream that removes keyframes.
4. ``VOConfig.pipeline``: the planner engages at the frame where the JAX
   package engages it on ``bench.py``'s protocol at 64x96 (frame 13), and
   ``pipeline=False`` never engages it.
"""

import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vo import planner as jpl
from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.utils.config import VOConfig
from pvo_tpu_torch.vo import factor_graph as fg
from pvo_tpu_torch.vo import graph_capture
from pvo_tpu_torch.vo import planner as pl
from pvo_tpu_torch.vo.system import VOSystem

from torch_one_thread import one_thread  # noqa: F401

E, MI, h, w = 48, 96, 3, 4


def t(x, dtype=torch.int64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def j(x):
    return jnp.asarray(np.asarray(x))


def random_gt(rng, n=None, ni=None):
    n = rng.randint(1, E + 1) if n is None else n
    ni = rng.randint(0, MI + 1) if ni is None else ni
    gt = {"ii": rng.randint(0, 30, E), "jj": rng.randint(0, 30, E),
          "age": rng.randint(0, 40, E), "valid": np.arange(E) < n,
          "inac_ii": rng.randint(0, 30, MI), "inac_jj": rng.randint(0, 30, MI),
          "inac_valid": np.arange(MI) < ni}
    return gt, n, ni


def port_gt(gt, n, ni):
    out = {k: t(v, torch.bool if v.dtype == bool else torch.int64)
           for k, v in gt.items()}
    out["n"], out["inac_n"] = t(n), t(ni)
    return out


def jax_gt(gt, n, ni):
    out = {k: jnp.asarray(v if v.dtype == bool else v.astype(np.int32))
           for k, v in gt.items()}
    out["n"], out["inac_n"] = jnp.int32(n), jnp.int32(ni)
    return out


def same_gt(a, b, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


# ------------------------------------------------------------ 1. units

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_swap_compact_perm_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(1, E + 1)
    drop = np.zeros(E, bool)
    drop[:n] = rng.rand(n) < 0.4
    perm, n_new = pl._swap_compact_perm(t(drop, torch.bool), t(n), E)
    jperm, jn_new = jpl._swap_compact_perm(j(drop), jnp.int32(n), E)
    assert int(n_new) == int(jn_new)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("seed, store", [(0, False), (1, True), (2, True),
                                         (3, True)])
def test_retire_edges_matches_jax(seed, store):
    """Seed 3 fills the ring, so its stores evict the oldest entries."""
    rng = np.random.RandomState(seed)
    gt, n, ni = random_gt(rng, ni=MI - 2 if seed == 3 else None)
    drop = rng.rand(E) < 0.3
    bufs = [rng.randn(E, h, w, c).astype(np.float32)
            for c in (128, 2, 2, 2, 2, 2)]
    bufs += [rng.randn(MI, h, w, 2).astype(np.float32) for _ in range(2)]
    pgt, pbufs = pl._retire_edges(port_gt(gt, n, ni),
                                  [torch.tensor(b) for b in bufs],
                                  t(drop, torch.bool), store)
    jgt, jbufs = jpl._retire_edges(jax_gt(gt, n, ni),
                                   tuple(j(b) for b in bufs), j(drop), store)
    same_gt(pgt, jgt, ("ii", "jj", "age", "valid", "n", "inac_ii",
                       "inac_jj", "inac_valid", "inac_n"))
    for p, q in zip(pbufs, jbufs):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))


class _FakeVideo:
    def __init__(self, counter):
        self.counter = counter


def proximity_case():
    """tests/test_planner.py's injected case: well-separated distances,
    some active and inactive edges."""
    rng = np.random.RandomState(7)
    T, WD = 20, 32
    dmat = np.full((WD, WD), np.inf, np.float32)
    vals = rng.permutation(400)[: T * T].astype(np.float32)
    dmat[:T, :T] = (vals * 0.11 + 1.0).reshape(T, T)
    dmat = 0.5 * (dmat + dmat.T)
    act = [(14, 12), (15, 13), (16, 14), (17, 15), (18, 16), (19, 17),
           (12, 16), (16, 12)]
    inac = [(8, 6), (9, 7), (10, 8), (6, 10)]
    return T, dmat, act, inac


def _topology(act, inac):
    ii = np.zeros(E, np.int64)
    jj = np.zeros(E, np.int64)
    ii[:len(act)], jj[:len(act)] = zip(*act)
    iii = np.zeros(MI, np.int64)
    ijj = np.zeros(MI, np.int64)
    iii[:len(inac)], ijj[:len(inac)] = zip(*inac)
    gt = {"ii": ii, "jj": jj, "age": np.zeros(E, np.int64),
          "valid": np.arange(E) < len(act), "inac_ii": iii, "inac_jj": ijj,
          "inac_valid": np.arange(MI) < len(inac)}
    return gt, len(act), len(inac)


@pytest.mark.parametrize("maxacc", [24, 2], ids=["fits", "overflows"])
def test_device_proximity_matches_jax_and_host(monkeypatch, maxacc):
    T, dmat, act, inac = proximity_case()
    window, rad, nms, thresh = 25, 2, 1, 12.0
    gt, n, ni = _topology(act, inac)
    monkeypatch.setattr(pl, "MAXACC", maxacc)
    monkeypatch.setattr(jpl, "MAXACC", maxacc)
    got = pl._device_proximity(port_gt(gt, n, ni), torch.tensor(dmat), t(0),
                               t(T), t(T), 32, rad, nms, thresh, window)
    want = jpl._device_proximity(jax_gt(gt, n, ni), j(dmat), jnp.int32(0),
                                 jnp.int32(T), jnp.int32(T), 32, rad, nms,
                                 thresh, window)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    k = int(got[2])
    if maxacc == 2:
        assert int(got[3]) == pl.F_PROX_OVF
        return
    assert int(got[3]) == 0 and k > 4

    # the port's host proposal (FactorGraph.add_proximity_factors) adds
    # the same edges in the same order
    g = fg.FactorGraph.__new__(fg.FactorGraph)
    g.video = _FakeVideo(T)
    g.ii, g.jj = (np.asarray(x, np.int64) for x in zip(*act))
    g.age = np.zeros(len(act), np.int64)
    g.ii_inac, g.jj_inac = (np.asarray(x, np.int64) for x in zip(*inac))
    g.ii_bad = g.jj_bad = np.zeros(0, np.int64)
    added = []
    g.add_factors = lambda ii, jj, remove=False: added.extend(
        (a, b) for a, b in zip(np.ravel(ii).tolist(), np.ravel(jj).tolist())
        if (a, b) not in g._existing())
    g._existing = types.MethodType(fg.FactorGraph._existing, g)

    def dist_fn(ii, jj):
        return dmat[np.asarray(ii), np.asarray(jj)].astype(np.float64)

    g.add_proximity_factors(T - 5, max(T - window, 0), rad=rad, nms=nms,
                            thresh=thresh, remove=True, distance_fn=dist_fn)
    assert list(zip(got[0][:k].tolist(), got[1][:k].tolist())) == added


@pytest.mark.parametrize("seed, PAIRS", [(0, 2048), (1, 64), (2, 256)])
def test_build_pairs_matches_jax(seed, PAIRS):
    rng = np.random.RandomState(seed)
    ii = rng.randint(0, 12, 72)
    valid = rng.rand(72) < 0.8
    got = pl._build_pairs(t(ii), t(valid, torch.bool), PAIRS)
    want = jpl._build_pairs(j(ii.astype(np.int32)), j(valid), PAIRS)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert bool(got[3]) == (PAIRS == 64)


@pytest.mark.parametrize("n_new", [2, 5], ids=["fits", "overflows"])
def test_append_edges_matches_jax(n_new):
    Eb = 8
    gt = {"ii": np.zeros(Eb, np.int64), "jj": np.zeros(Eb, np.int64),
          "age": np.arange(Eb, dtype=np.int64), "valid": np.arange(Eb) < 6}
    new_ii = np.arange(10, 22)
    new_jj = np.arange(20, 32)
    pgt = {k: t(v, torch.bool if v.dtype == bool else torch.int64)
           for k, v in gt.items()}
    pgt["n"] = t(6)
    jgt = {k: j(v if v.dtype == bool else v.astype(np.int32))
           for k, v in gt.items()}
    jgt["n"] = jnp.int32(6)
    got = pl._append_edges(pgt, t(new_ii), t(new_jj), t(n_new), Eb)
    want = jpl._append_edges(jgt, j(new_ii.astype(np.int32)),
                             j(new_jj.astype(np.int32)), jnp.int32(n_new),
                             Eb)
    same_gt(got[0], want[0], ("ii", "jj", "age", "valid", "n"))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(got[2]) == (pl.F_EDGE_OVF if n_new == 5 else 0)


@pytest.mark.parametrize("ix, end", [(3, 6), (5, 12), (14, 16), (15, 16)])
def test_shift_window_rows_matches_jax(ix, end):
    buf = np.random.RandomState(ix).randn(16, 3, 2).astype(np.float32)
    got = pl._shift_window_rows(torch.tensor(buf), t(ix), t(end))
    want = jpl._shift_window_rows(j(buf), jnp.int32(ix), jnp.int32(end))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = pl._shift_window_rows(torch.tensor(buf), t(ix), t(end),
                                 when=t(False, torch.bool))
    np.testing.assert_array_equal(kept.numpy(), buf)


# ------------------------------------------------------------ 2. driver

def test_precheck_cooldown_and_refusal_logging(caplog):
    g = types.SimpleNamespace(n_edges=60, ii_bad=np.zeros(0),
                              ii_inac=np.zeros(0), max_inactive=96)
    fe = types.SimpleNamespace(is_initialized=True, graph=g, _dmat=None,
                               _packet=None)
    drv = pl.PlannerDriver(types.SimpleNamespace(frontend=fe))
    with caplog.at_level(logging.INFO, logger="pvo_tpu_torch.planner"):
        assert not drv.precheck()          # n_edges=60 > 48
    assert any("n_edges=60" in r.message for r in caplog.records)
    n_msgs = len(caplog.records)
    with caplog.at_level(logging.INFO, logger="pvo_tpu_torch.planner"):
        for _ in range(drv.RETRY_COOLDOWN):
            assert not drv.precheck()
    assert len(caplog.records) == n_msgs
    g.n_edges = 20
    assert drv.precheck()
    assert not drv.can_engage()            # no resolved distance matrix
    fe._dmat = np.zeros((32, 32))
    assert drv.can_engage()


# ------------------------------------------------------------ 3. streams

N, H, W = 18, 64, 96


def gt_scene():
    tang = torch.zeros(N, 6)
    tang[:, 0] = 0.04 * torch.arange(N)
    tang[:, 4] = 0.01 * torch.arange(N)
    return se3.exp(tang), torch.ones(N, H // 8, W // 8)


def oracle_core(gt_poses, gt_disps):
    """Ground-truth reprojection targets for every edge: bit-stable
    update outputs, so decisions do not hang on f32 summation order."""

    def core(graph, net, target, raw, dy, ii, jj, valid, w0, K, corr_fn,
             ctx_pre, segms_e):
        v = graph.video
        F = v.poses.shape[0]
        gp = torch.cat([gt_poses, gt_poses[-1:].expand(F - N, 7)])[None]
        gd = torch.cat([gt_disps, gt_disps[-1:].expand(
            (F - N,) + gt_disps.shape[1:])])[None]
        coords, vm = projective.projective_transform(
            gp, gd, v.intrinsics[0].expand(1, F, 4), ii, jj)
        target = coords[0]
        weight = (valid[:, None, None, None].float() *
                  vm[0].float()).expand_as(target).clone()
        eta = 1e-4 * torch.ones((K,) + target.shape[1:3])
        m = torch.where(valid, ii - w0, torch.full_like(ii, K))
        cnt = torch.zeros(K + 1).index_add_(0, m, valid.float())[:K]
        flow = target - projective.coords_grid(*target.shape[1:3])
        return net, target, weight, raw, dy, flow, eta, cnt > 0

    return core


def stream(n, seed=3):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (H * 2, W * 2, 3), np.uint8)
    intr = np.array([40.0, 40.0, W / 2, H / 2], np.float32)
    for k in range(n):
        dy, dx = (2 * k) % H, (3 * k) % W
        yield k, base[dy:dy + H, dx:dx + W], intr, None


def run_mode(pipeline, kf_thresh, frames=N):
    cfg = VOConfig(image_size=(H, W), buffer=64, warmup=5, filter_thresh=-1.0,
                   keyframe_thresh=kf_thresh, frontend_window=8,
                   max_edges=96, max_inactive=64, segm_filter=False,
                   pipeline=pipeline)
    sysm = VOSystem(cfg, device="cpu", net_dtype=torch.float32)
    engaged = []
    for k, img, intr, segm in stream(frames):
        sysm.track(k, img, intr, segments=segm)
        engaged.append(sysm.planner.engaged)
    n_removed = sysm.planner.n_removed
    sysm.planner.disengage()
    if sysm._pending_adm is not None:
        sysm.filterx.resolve_track(sysm._pending_adm)
        sysm._pending_adm = None
    sysm.frontend.resolve()
    g, v = sysm.frontend.graph, sysm.video
    return {"sys": sysm, "engaged": engaged, "counter": v.counter,
            "t1": sysm.frontend.t1,
            "edges": sorted(zip(g.ii.tolist(), g.jj.tolist(),
                                g.age.tolist())),
            "inac": sorted(zip(g.ii_inac.tolist(), g.jj_inac.tolist())),
            "tstamp": v.tstamp[:v.counter].copy(),
            "traj": v.poses[:v.counter].clone(), "n_removed": n_removed}


@pytest.fixture
def oracle(monkeypatch):
    monkeypatch.setattr(fg, "update_core", oracle_core(*gt_scene()))


def assert_same_decisions(plan, classic):
    assert any(plan["engaged"]) and not any(classic["engaged"])
    for key in ("counter", "t1", "edges", "inac"):
        assert plan[key] == classic[key], key
    np.testing.assert_array_equal(plan["tstamp"], classic["tstamp"])
    dt = float((plan["traj"] - classic["traj"]).abs().max())
    assert dt < 1e-3, dt


@pytest.fixture
def regimes(monkeypatch):
    """The regime of every frame that ran an update (1: compact)."""
    seen = []
    resolve = pl.PlannerDriver._resolve_one

    def spy(drv):
        rec = resolve(drv)
        if rec[pl.R_RAN]:
            seen.append(int(rec[pl.R_SMALL]))
        return rec

    monkeypatch.setattr(pl.PlannerDriver, "_resolve_one", spy)
    return seen


def test_planner_matches_classic(oracle, regimes):
    """Keyframe threshold 0: every keyframe stays; the compact regime
    runs on the first frames, the full-width one once the edges pass
    EB_S."""
    plan = run_mode(True, 0.0)
    classic = run_mode(False, 0.0)
    assert_same_decisions(plan, classic)
    assert plan["n_removed"] == 0
    assert set(regimes) == {0, 1}


def test_planner_keyframe_removal_matches_classic(oracle, regimes,
                                                  monkeypatch):
    """A keyframe threshold that removes keyframes exercises phase A
    (video rows shifted, edges and the distance matrix remapped) against
    the classic deferred removal, in the full-width regime (forced)."""
    monkeypatch.setattr(pl, "FORCE_LARGE", True)
    plan = run_mode(True, 2.0)
    classic = run_mode(False, 2.0)
    assert plan["n_removed"] >= 1
    assert_same_decisions(plan, classic)
    assert regimes and set(regimes) == {0}


def test_overflow_disengages_and_backs_off(oracle, monkeypatch, caplog):
    """MAXACC=1 saturates the greedy accept after one pair
    (F_PROX_OVF): PlannerDriver disengages to the classic path, backs off,
    and the stream completes there."""
    monkeypatch.setattr(pl, "MAXACC", 1)
    with caplog.at_level(logging.WARNING, logger="pvo_tpu_torch.planner"):
        plan = run_mode(True, 0.0)
    drv = plan["sys"].planner
    assert drv.n_overflows >= 1 and drv.overflow & pl.F_PROX_OVF
    assert not drv.engaged and drv.cooldown > 0
    assert any("PROX_OVF" in r.message for r in caplog.records)
    # engaged, then back on the classic path for the rest of the stream
    k = plan["engaged"].index(True)
    assert not plan["engaged"][-1] and any(plan["engaged"][k:])
    assert plan["counter"] > 5 and torch.isfinite(plan["traj"]).all()
    traj = plan["sys"].terminate(backend_steps=())
    assert np.isfinite(traj).all()


class _NoHostRead(graph_capture.Eager):
    """Runs every branch without reading its predicate, as a capture
    does."""

    def cond(self, pred, fn, name):
        fn()


def test_frame_program_reads_nothing_back(oracle, monkeypatch):
    """Capture fails on a host read; here every way a tensor reaches the
    host raises while one frame program runs."""
    drv = run_mode(True, 0.0, frames=8)["sys"].planner
    drv.engage()
    drv._upload(*next(stream(9))[1:3], None)

    def host_read(*a, **kw):
        raise AssertionError("host read inside the frame program")

    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    monkeypatch.setattr(torch, "bincount", host_read)
    monkeypatch.setattr(torch, "nonzero", host_read)
    drv.program(_NoHostRead())
    monkeypatch.undo()


# ------------------------------------------------------------ 4. the switch

def bench_protocol(pipeline, n=16):
    """bench.py's configuration and stream at 64x96 (tests/
    test_torch_port_bench.py holds the stream equal to bench.py's)."""
    from pvo_tpu_torch.scripts.bench_track import synth_stream
    return (VOConfig(image_size=(64, 96), buffer=32, filter_thresh=0.01,
                     keyframe_thresh=0.0, warmup=12, segm_filter=True,
                     pipeline=pipeline, yuv420_upload=False),
            list(synth_stream(n, 64, 96)))


def engage_frame(sysm, frames):
    for k, img, intr, segm in frames:
        sysm.track(k, img, intr, segments=segm)
        if sysm.planner.engaged:
            return k
    return None


@pytest.mark.slow
def test_pipeline_engages_at_the_jax_frame():
    from pvo_tpu.utils.config import VOConfig as JaxConfig
    from pvo_tpu.vo import system as jsys
    from pvo_tpu_torch.utils.convert import droidnet_from_jax

    cfg, frames = bench_protocol(True)
    params = jsys.init_params(jsys.make_modules(), image_size=(64, 96))
    jx = jsys.VOSystem(JaxConfig(**vars(cfg)), params=params)
    pt = VOSystem(cfg, net=droidnet_from_jax(jax.tree.map(np.asarray,
                                                          params)),
                  device="cpu")
    want = engage_frame(jx, frames)
    assert want == 13
    assert engage_frame(pt, frames) == want


def test_pipeline_engages_at_frame_13_and_false_keeps_classic():
    """The port's half of the case above, fast: bench.py's protocol at
    64x96 engages at frame 13 (the JAX package's frame there), and
    ``pipeline=False`` never engages."""
    for pipeline, want in ((True, 13), (False, None)):
        cfg, frames = bench_protocol(pipeline, n=14)
        assert engage_frame(VOSystem(cfg, device="cpu"), frames) == want
