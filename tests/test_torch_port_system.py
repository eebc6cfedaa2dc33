"""Slice-level tests of the port: VO tracking + terminate.

(a) Decision trace: the port's Frontend + FactorGraph host logic, device
    stubbed, against tests/ref_host_logic.RefHostOracle (the harness of
    tests/test_decision_trace.py), exact match.
(b) Numeric run: JAX VOSystem vs port VOSystem on the same weights and
    stream (64x96, 8 frames, segment filter on) and terminate, with the
    backend's edges whole or in 8-edge chunks, and with the trajectory
    filler (terminate(image_stream)); counters
    and edge sets exact, poses within 1e-3 abs, disparities within 1e-2
    relative (plus 1e-4 abs next to the 0.001 disparity floor), and
    get_depth / get_flow against the JAX accessors.
(c) The port runs 3 frames on the CPU without importing JAX, and never
    picks the CPU by itself.

On (b)'s weights: with unscaled random weights the tracker is chaotic.
Measured on this CPU at this configuration: perturbing the port's own
disparities by 1e-6 (relative) before initialization gives disparity
differences of 3e-4, 4e-2 and 1.1 after 1, 2 and 3 updates, and
targets thousands of pixels apart after 6. From identical inputs one
port update agrees with the JAX update to 7e-5 in targets and 2e-4 in
disparities. So no tolerance is meaningful there. With the last convs
of the delta, delta_dy and delta_mask heads scaled by 0.01 (same scaled
weights on both sides), the same 1e-6 perturbation stays below 6e-5
over 20 updates, and the stated tolerances hold.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.utils.config import VOConfig
from pvo_tpu.vo import system as jsys
from pvo_tpu_torch.utils.convert import droidnet_from_jax
from pvo_tpu_torch.vo.factor_graph import FactorGraph
from pvo_tpu_torch.vo.frontend import Frontend
from pvo_tpu_torch.vo.system import VOSystem

from ref_host_logic import RefHostOracle
from test_decision_trace import _streams, dist_f

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------ (a) decision trace

class FakeVideo:
    """Host-only DepthVideo stand-in: frame-id bookkeeping + injected
    distances; tiny poses/disps for Frontend._initialize."""

    def __init__(self, buffer=256, hw=(4, 4)):
        self.counter = 0
        self.frames = []
        self.h, self.w = hw
        self.device = torch.device("cpu")
        self.poses = torch.zeros((buffer, 7))
        self.poses[:, 6] = 1.0
        self.disps = torch.ones((buffer,) + hw)
        self.ready = False

    def append(self, fid):
        if self.counter < len(self.frames):
            self.frames[self.counter] = fid
        else:
            self.frames.append(fid)
        self.counter += 1

    def remove_frame(self, off):
        if off + 1 < len(self.frames):
            self.frames[off] = self.frames[off + 1]

    def distance(self, ii, jj, beta=0.6):
        return np.array([dist_f(self.frames[int(i)], self.frames[int(j)])
                         for i, j in zip(np.ravel(ii), np.ravel(jj))])


class TraceGraph(FactorGraph):
    """The port's FactorGraph host logic with the update stubbed: it only
    ages edges, consumes the fresh marks and fabricates the packet
    (probe + window distance matrix) from the injected distances."""

    def __init__(self, video, max_factors=48, max_edges=2048,
                 max_inactive=2048, beta=0.6):
        self.video = video
        self.beta = beta
        self.max_edges = max_edges
        self.max_inactive = max_inactive
        self.max_factors = max_factors
        self.net_dtype = torch.float32
        self._init_edges()
        self.events = []

    def _pairs(self, ii, jj):
        fr = self.video.frames
        return [(fr[int(i)], fr[int(j)]) for i, j in zip(ii, jj)]

    def add_factors(self, ii, jj, remove=False):
        eset = self._existing()
        ai = np.asarray(ii, np.int64).reshape(-1)
        aj = np.asarray(jj, np.int64).reshape(-1)
        keep = [k for k in range(len(ai))
                if (int(ai[k]), int(aj[k])) not in eset]
        super().add_factors(ii, jj, remove)
        if keep:
            self.events.append(
                ("add", sorted(self._pairs(ai[keep], aj[keep]))))

    def rm_factors(self, mask, store=False):
        mask = np.asarray(mask, bool)
        if mask.sum():
            self.events.append(
                ("rm", sorted(self._pairs(self.ii[mask], self.jj[mask])),
                 bool(store)))
        super().rm_factors(mask, store)

    def update(self, t0=None, t1=None, itrs=2, use_inactive=False,
               EP=1e-7, motion_only=False, steps=1, dist_pair=None,
               steps2=0, kf_thresh=0.0, seed_ix=None, dmat_window=0):
        if self.n_edges == 0:
            return None, 0
        self.fresh[:] = False
        v = self.video
        d0 = max(0, int(v.counter) + 1 - dmat_window) if dmat_window else 0
        self._last_d0 = d0
        probe = np.inf
        if dist_pair is not None and dist_pair != (0, 0):
            fa, fb = v.frames[dist_pair[0]], v.frames[dist_pair[1]]
            probe = 0.5 * (dist_f(fa, fb) + dist_f(fb, fa))
        packet = [probe]
        if dmat_window:
            # slot ``counter`` is the seeded next-keyframe pose (a copy
            # of its predecessor), as in the real update
            W = dmat_window
            dm = np.full((W, W), np.inf)
            hi = min(d0 + W, int(v.counter) + 1)

            def fid(k):
                return v.frames[min(k, int(v.counter) - 1)]

            for a in range(d0, hi):
                for b in range(d0, hi):
                    if a != b:
                        dm[a - d0, b - d0] = dist_f(fid(a), fid(b))
            packet = np.concatenate([packet, dm.ravel()])
        self.age += steps
        return np.asarray(packet, np.float64), d0


class TraceFrontend(Frontend):
    def rm_keyframe_deferred(self, ix):
        self.graph.events.append(("rm_kf", self.video.frames[ix]))
        super().rm_keyframe_deferred(ix)


def test_port_decision_trace_matches_reference():
    cfg = VOConfig(image_size=(32, 32), warmup=12)
    video = FakeVideo()
    graph = TraceGraph(video, max_factors=48, beta=cfg.beta)
    fe = TraceFrontend(graph, video, cfg)
    oracle = RefHostOracle(
        dist_f, warmup=cfg.warmup, iters1=cfg.frontend_iters1,
        iters2=cfg.frontend_iters2, max_age=cfg.max_age,
        window=cfg.frontend_window, radius=cfg.frontend_radius,
        nms=cfg.frontend_nms, thresh=cfg.frontend_thresh,
        kf_thresh=cfg.keyframe_thresh, max_factors=48)

    for t in range(60):
        video.append(t)
        fe()
        oracle.track(t)
    fe.flush()

    got, want = _streams(graph.events), _streams(oracle.events)
    assert got["rm_kf"] == want["rm_kf"]
    assert len(got["rm_kf"]) >= 3, "synthetic run must exercise removal"
    assert got["add"] == want["add"]
    assert got["rm_store"] == want["rm_store"]
    assert got["rm_drop"] == want["rm_drop"]
    fr, ofr = video.frames, oracle.frames
    assert sorted((fr[i], fr[j]) for i, j in zip(graph.ii, graph.jj)) == \
        sorted((ofr[i], ofr[j]) for i, j in zip(oracle.ii, oracle.jj))
    np.testing.assert_array_equal(np.sort(graph.age), np.sort(oracle.age))
    # edge-state rows follow the host topology through every retirement
    assert graph.target.shape[0] == graph.n_edges
    assert graph.target_inac.shape[0] == len(graph.ii_inac)


def test_port_filter_edges_drops_weak_longrange():
    """The case of tests/test_segment_filter.py for the JAX graph: long-
    range (|i-j| > 2) edges with mean confidence below 1e-3 are dropped
    and remembered as bad; the weight rows follow the compaction."""
    video = FakeVideo()
    video.frames = list(range(10))
    graph = TraceGraph(video)
    ii = np.arange(4)
    graph.add_factors(ii, ii + np.array([1, 5, 6, 2]))
    graph.weight[:] = torch.tensor([1.0, 1.0, 1e-5, 1e-5])[:, None, None,
                                                             None]
    graph.filter_edges()
    assert edge_set(graph) == [(0, 1), (1, 6), (3, 5)]
    assert (graph.ii_bad.tolist(), graph.jj_bad.tolist()) == ([2], [8])
    row = {(i, j): float(graph.weight[r].mean())
           for r, (i, j) in enumerate(zip(graph.ii, graph.jj))}
    assert row == {(0, 1): 1.0, (1, 6): 1.0, (3, 5): pytest.approx(1e-5)}


# ------------------------------------------------ (b) numeric run

H, W = 64, 96


def synth_stream(n, seed=0):
    """Moving textured pattern with a non-zero, moving segment map."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (H * 2, W * 2, 3), np.uint8)
    intr = np.array([40.0, 40.0, W / 2, H / 2], np.float32)
    h, w = H // 8, W // 8
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for t in range(n):
        dy, dx = 2 * t % H, 3 * t % W
        segm = ((((yy + t) // 2) * 7 + (xx + t) // 3) % 9 + 1) * 1000
        yield t, base[dy:dy + H, dx:dx + W], intr, segm.astype(np.int32)


def tame_params(params, scale=0.01):
    """JAX params with the last conv of the flow/mask heads scaled (see
    the module docstring)."""
    params = jax.tree.map(np.array, jax.device_get(params))
    for head in ("delta", "delta_dy", "delta_mask"):
        conv = params["update"]["params"][head]["conv1"]["Conv_0"]
        conv["kernel"] = conv["kernel"] * np.float32(scale)
        conv["bias"] = conv["bias"] * np.float32(scale)
    return params


def edge_set(g):
    return sorted(zip(g.ii.tolist(), g.jj.tolist()))


@pytest.mark.parametrize("backend_chunk, fill", [(None, False), (8, False),
                                                 (None, True)],
                         ids=["backend-whole", "backend-chunked",
                              "backend-whole-filler"])
def test_port_system_matches_jax(monkeypatch, backend_chunk, fill):
    """``backend-chunked`` streams terminate's global updates over 8-edge
    chunks on both sides (``_update_core_chunked``, the path of graphs
    beyond 256 edges). ``filler`` passes the stream to terminate, which
    then returns every frame's pose from the trajectory filler (8 frames
    staged as one batch padded to 16, 32 edges, 6 motion-only
    updates)."""
    monkeypatch.setattr(jsys, "NET_STORE_DTYPE", jnp.float32)
    cfg = VOConfig(image_size=(H, W), warmup=5, filter_thresh=-1.0,
                   keyframe_thresh=0.0, segm_filter=True, pipeline=False,
                   yuv420_upload=False, max_edges=48, frontend_window=8)
    params = tame_params(jsys.init_params(jsys.make_modules(),
                                          image_size=(H, W), seed=0))
    jx = jsys.VOSystem(cfg, params=jax.tree.map(jnp.asarray, params))
    pt = VOSystem(cfg, net=droidnet_from_jax(params), device="cpu",
                  net_dtype=torch.float32)

    frames = list(synth_stream(8))
    for t, img, intr, segm in frames:
        jx.track(t, img, intr, segments=segm)
        pt.track(t, img, intr, segments=segm)
        assert pt.video.counter == jx.video.counter
        gj, gp = jx.frontend.graph, pt.frontend.graph
        assert edge_set(gp) == edge_set(gj)
        assert sorted(zip(gp.ii_inac.tolist(), gp.jj_inac.tolist())) == \
            sorted(zip(gj.ii_inac.tolist(), gj.jj_inac.tolist()))
    assert pt.frontend.is_initialized and pt.video.counter == 7
    np.testing.assert_allclose(pt.get_traj(), jx.get_traj(), rtol=0,
                               atol=1e-3)

    if backend_chunk:
        jx.backend.edge_chunk = pt.backend.edge_chunk = backend_chunk
    chunked = []
    core = FactorGraph._update_core_chunked
    monkeypatch.setattr(FactorGraph, "_update_core_chunked",
                        lambda g, **kw: chunked.append(kw["chunk"]) or
                        core(g, **kw))
    stream = (lambda: iter(frames)) if fill else (lambda: None)
    traj_j = jx.terminate(stream(), backend_steps=(2,))
    traj_p = pt.terminate(stream(), backend_steps=(2,))
    assert chunked == ([backend_chunk] * 2 if backend_chunk else [])
    # the filler ran: its graph exists and was cleared after the batch
    assert (pt.traj_filler._graph is not None) == fill
    assert pt.video.counter == jx.video.counter == 8
    assert traj_p.shape == traj_j.shape == (8, 7)
    np.testing.assert_allclose(traj_p, traj_j, rtol=0, atol=1e-3)
    n = pt.video.counter
    dj = np.asarray(jx.video.disps[:n])
    dp = pt.video.disps[:n].numpy()
    # atol: 2 of 768 pixels end next to the DBA's 0.001 disparity floor
    # (0.0012 and 0.0021, median 0.94), where the measured 7e-5 abs
    # difference is 6% relative
    np.testing.assert_allclose(dp, dj, rtol=1e-2, atol=1e-4)
    # the accessors: disparities upsampled x8 (bilinear, end points on
    # end points) at the disparities' tolerance, and the upsampled
    # full_flow buffer (ones x 8 on both sides)
    depth, flow = pt.get_depth(), pt.get_flow()
    assert depth.shape == (n, H, W) and flow.shape == (n, H, W, 2)
    np.testing.assert_allclose(depth, jx.get_depth(), rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(flow, jx.get_flow(), rtol=0, atol=1e-6)


# ------------------------------------------------ (c) no JAX

NO_JAX = r"""
import importlib, pkgutil, sys
import numpy as np
import pvo_tpu_torch
for m in pkgutil.walk_packages(pvo_tpu_torch.__path__, "pvo_tpu_torch."):
    importlib.import_module(m.name)
from pvo_tpu.utils.config import VOConfig
from pvo_tpu_torch.vo.system import VOSystem
cfg = VOConfig(image_size=(64, 96), warmup=3, filter_thresh=-1.0,
               segm_filter=True, pipeline=False, yuv420_upload=False)
s = VOSystem(cfg, device="cpu")
rng = np.random.RandomState(0)
intr = np.array([40.0, 40.0, 48.0, 32.0], np.float32)
for t in range(3):
    s.track(t, rng.randint(0, 255, (64, 96, 3), np.uint8), intr,
            segments=rng.randint(0, 5, (8, 12)))
traj = s.terminate(backend_steps=(1,))
assert traj.shape == (3, 7) and np.isfinite(traj).all(), traj
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_never_picks_the_cpu_by_itself():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VOSystem(VOConfig(image_size=(64, 96)))


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
