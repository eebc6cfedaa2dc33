"""The planner's wide-stream correlation route (``vo/planner.py``
``corr_route`` and ``PlannerProgram._invariants``'s indexed branch) and
its keyframe removal, on the CPU.

On the card a stream whose features are wider than 120 a side
(``cuda_corr.volume_cache_ok``; 376x1248 gives 47x156) takes the
"indexed" route: the program gathers the update's 2E frames, pools their
pyramid once (``cuda_corr.lookup_pyramid``) and calls K3
(``cuda_corr.corr_lookup_indexed``) on every step. On the CPU the route
is "plain" (the chunked lookup), so nothing here runs the indexed branch
unless a test forces it:

(a) ``corr_route`` on the card's shapes, and ``trace_track``'s route,
    which must agree with it.
(b) the planner on bench.py's stream at 64x96 with the route forced to
    "indexed" and the real f32 update core, against the same run on
    "plain": the same decisions. The two lookups differ only in how the
    pyramid's levels 1-3 are pooled: the plain lookup widens the bf16
    features to f32 and pools in f32 (the JAX package's XLA path), the
    kernels' pyramid rounds each pooled level to bf16 (its Pallas path).
    With the pyramid pooled in f32 the indexed run equals the plain one
    (within 1e-5; it shows 0); with the kernels' bf16 levels the poses
    part by the rounding, 6.5e-4 on this stream (held within 2e-3).
(c) the indexed ``corr_fn`` that ``_invariants`` builds on an engaged
    planner's state against the JAX package's ``pallas_corr_lookup`` (in
    interpret mode, as ``tests/test_pallas_corr.py`` runs it) on the same
    frames, edges and coordinates: within 1e-4.
(d) keyframe removal in the regime the engaged planner picks itself (the
    compact one here; ``test_torch_port_planner.py`` forces the full one)
    against the classic path under the oracle update core.
(e) ``chip_smoke.lookup_plain``, the plain K3 that ``chip_smoke.py``
    holds the backend's 256-edge chunk at 47x156 against, run on slices
    of the edges: the whole call's values, but for the order of the
    volumes' f32 sums (the product's blocking follows the batch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vo.net.pallas_corr import pallas_corr_lookup
from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.scripts import kbench, trace_track
from pvo_tpu_torch.scripts.bench_track import synth_stream, tame_net
from pvo_tpu_torch.utils.config import VOConfig
from pvo_tpu_torch.vo import factor_graph as fg
from pvo_tpu_torch.vo import planner as pl
from pvo_tpu_torch.vo.net import cuda_corr
from pvo_tpu_torch.vo.system import VOSystem

import chip_smoke
import test_torch_port_planner as tp
from torch_one_thread import one_thread  # noqa: F401

H, W, FRAMES = 64, 96, 16


# ------------------------------------------------------------ (a) the route

@pytest.mark.parametrize("hw, route", [
    ((47, 156), "indexed"),     # 376x1248: the wide stream
    ((30, 101), "volume"),      # 240x808: bench.py's
    ((128, 40), "indexed"),     # tall
    ((15, 121), "indexed"),     # one level past 120
    ((120, 120), "volume"),
])
def test_card_route_and_trace_track_agree(hw, route):
    assert pl.corr_route("cuda", *hw) == route
    assert pl.corr_route("cuda:0", *hw) == route
    assert pl.corr_route("cpu", *hw) == "plain"
    assert trace_track._card_route("cpu", *hw) == route


def test_trace_track_route_survives_its_own_patch(monkeypatch):
    """``count_frame`` puts ``_card_route`` in place of
    ``planner.corr_route``; the card's rule must still be the one it
    reads."""
    monkeypatch.setattr(pl, "corr_route", trace_track._card_route)
    assert trace_track._card_route("cpu", 47, 156) == "indexed"
    assert trace_track._card_route("cpu", 30, 101) == "volume"


def test_lookup_route_pairs_are_the_kernels_grids():
    """The (block, level) pairs one K3 launch adds to the route counters:
    the bf16 kernel's 8 x 16-pixel blocks take every level, the f32
    kernel's 8 x 8 ones one level each."""
    assert cuda_corr.lookup_route_pairs(48, 47, 156, True) == 48 * 6 * 10 * 4
    assert cuda_corr.lookup_route_pairs(24, 47, 156, True) == 24 * 6 * 10 * 4
    assert cuda_corr.lookup_route_pairs(1, 47, 156, False) == 6 * 20 * 4
    assert cuda_corr.lookup_route_pairs(48, 30, 101, True, 3) == \
        48 * 4 * 7 * 3


# ------------------------------------------------------- (b), (c) the stream

def f32_pyramid(fmaps, num_levels=4):
    """The pyramid pooled as the plain lookup pools it: f32 levels of the
    features widened to f32."""
    return cuda_corr.pool_pyramid(fmaps.float(), num_levels, torch.float32)


def track(route, pyramid=None, probe=None):
    """bench.py's protocol at 64x96 (the planner engages at frame 13) with
    f32 hidden state, the planner's correlation route forced to
    ``route``, K3's pyramid pooled by ``pyramid`` (the kernels' by
    default). ``probe(sysm)`` runs on the engaged planner after the last
    frame. Returns the run's decisions and state."""
    saved = pl.corr_route, cuda_corr.lookup_pyramid
    pl.corr_route = lambda device, h, w: route
    if pyramid is not None:
        cuda_corr.lookup_pyramid = pyramid
    try:
        cfg = VOConfig(image_size=(H, W), buffer=32, filter_thresh=0.01,
                       keyframe_thresh=0.0, warmup=12, segm_filter=True)
        sysm = VOSystem(cfg, net=tame_net(0), device="cpu",
                        net_dtype=torch.float32)
        engaged_at = None
        for t, img, intr, segm in synth_stream(FRAMES, H, W):
            sysm.track(t, img, intr, segments=segm)
            if engaged_at is None and sysm.planner.engaged:
                engaged_at = t
        out = {"probe": probe(sysm) if probe else None}
    finally:
        pl.corr_route, cuda_corr.lookup_pyramid = saved
    sysm.planner.disengage()
    g, v = sysm.frontend.graph, sysm.video
    out.update(engaged_at=engaged_at, counter=v.counter, t1=sysm.frontend.t1,
               edges=sorted(zip(g.ii.tolist(), g.jj.tolist(),
                                g.age.tolist())),
               tstamp=v.tstamp[:v.counter].tolist(),
               poses=v.poses[:v.counter].clone())
    return out


def lookup_operands(sysm):
    """On the engaged planner: the indexed ``corr_fn`` that
    ``_invariants`` builds for the program's edges (the valid ones), the
    reprojected coordinates an update step gives it, and its output."""
    st, v = sysm.planner.st, sysm.video
    n = int(st.topo_n[0])
    ii, jj = st.ii[:n], st.jj[:n]
    inv = sysm.planner.program._invariants(ii, jj)
    coords, _ = projective.projective_transform(
        v.poses[None], v.disps[None],
        v.intrinsics[0].expand(1, v.poses.shape[0], 4), ii, jj)
    coords = coords[0].contiguous()
    return {"f1": v.fmaps[ii].float().numpy(),
            "f2": v.fmaps[jj].float().numpy(), "coords": coords.numpy(),
            "corr": inv["corr_fn"](coords).numpy()}


@pytest.fixture(scope="module")
def runs():
    return {"plain": track("plain"),
            "f32": track("indexed", pyramid=f32_pyramid),
            "bf16": track("indexed", probe=lookup_operands)}


def test_indexed_route_is_exercised(runs):
    r = runs["bf16"]
    assert r["engaged_at"] == 13 and r["counter"] == FRAMES
    # the planner ran update frames on the route: the operands are those
    # of a full edge set
    assert r["probe"]["corr"].shape[0] > 8


@pytest.mark.parametrize("levels, tol", [("f32", 1e-5), ("bf16", 2e-3)])
def test_indexed_route_matches_plain(runs, levels, tol):
    got, want = runs[levels], runs["plain"]
    for key in ("engaged_at", "counter", "t1", "edges", "tstamp"):
        assert got[key] == want[key], key
    diff = float((got["poses"] - want["poses"]).abs().max())
    assert diff <= tol, diff
    if levels == "f32":
        # nothing else differs between the two routes
        assert diff == 0.0


def test_indexed_lookup_matches_pallas(runs):
    """The planner's indexed lookup on its own operands against the JAX
    package's fused Pallas lookup (bf16 features pooled to bf16 levels,
    as the kernels pool them)."""
    p = runs["bf16"]["probe"]
    want = pallas_corr_lookup(
        jnp.asarray(p["f1"], jnp.bfloat16), jnp.asarray(p["f2"], jnp.bfloat16),
        jnp.asarray(p["coords"]), num_levels=4, blk=32, interpret=True)
    np.testing.assert_allclose(p["corr"], np.asarray(want), rtol=0,
                               atol=1e-4)


# ------------------------------------------------------------ (d) removal

@pytest.fixture
def oracle(monkeypatch):
    monkeypatch.setattr(fg, "update_core", tp.oracle_core(*tp.gt_scene()))


def test_keyframe_removal_in_the_planners_own_regime(oracle, monkeypatch):
    """Phase A's removal in the regime the planner picks (compact: the
    edges fit EB_S), against the classic deferred removal under the
    oracle core. The oracle's frames are 0.33 apart (frame_distance), so
    a threshold of 0.5 removes the newest keyframe on every update."""
    records = []
    resolve = pl.PlannerDriver._resolve_one

    def spy(drv):
        rec = resolve(drv)
        records.append(rec.copy())
        return rec

    monkeypatch.setattr(pl.PlannerDriver, "_resolve_one", spy)
    assert not pl.FORCE_LARGE
    plan = tp.run_mode(True, 0.5)
    classic = tp.run_mode(False, 0.5)
    tp.assert_same_decisions(plan, classic)
    removed = [r for r in records if r[pl.R_RAN] and r[pl.R_REMOVED]]
    # (run_mode reads n_removed before its disengage resolves the last
    # two records)
    assert plan["sys"].planner.n_removed == len(removed) >= 2
    assert all(r[pl.R_SMALL] == 1 for r in removed)


# ------------------------------------------------------------ (e) slices

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_lookup_on_slices_equals_the_whole_call(dtype, monkeypatch):
    """With the volumes' budget at two edges' bytes, ``lookup_plain``
    runs 5 edges as slices of 2, 2 and 1 and gives the whole call's
    values within 1e-6 (it shows 6e-8 on values up to 2.1: the order of
    the volumes' f32 sums), against K3's 1e-4."""
    E, h, w = 5, 9, 13
    rng = np.random.RandomState(3)
    f1, f2 = (torch.from_numpy(rng.randn(E, h, w, 128).astype(np.float32))
              .to(dtype) for _ in range(2))
    coords = torch.from_numpy(
        kbench.lookup_coords("scattered", E, h, w, seed=1))
    per_edge = 4 * h * w * sum(a * b for a, b in
                               cuda_corr.level_shapes(h, w, 4))
    monkeypatch.setattr(chip_smoke, "PLAIN_VOLUME_BYTES", 2 * per_edge + 1)
    calls = []
    plain = cuda_corr.corr_lookup_plain

    def counted(a, b, c):
        calls.append(c.shape[0])
        return plain(a, b, c)

    monkeypatch.setattr(cuda_corr, "corr_lookup_plain", counted)
    got = chip_smoke.lookup_plain(f1, f2, coords)
    assert calls == [2, 2, 1]
    assert kbench.lookup_err(got, plain(f1, f2, coords)) <= 1e-6
