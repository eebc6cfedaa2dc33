"""The DBA's kernels (``vo/net/cuda_dba.py``, ``csrc/dba.cu``): their plain
versions against the JAX package, their counts and bounds; on the card
the kernels against their plain versions.

On the CPU, on numpy inputs from a seed (4x6 and 6x10 scenes, padded
edges and pair slots, ``t0``/``w0`` as 0-d tensors), within 1e-5:
``linearize_plain`` against ``pvo_tpu.geom.ba._edge_blocks`` times the
valid mask; ``schur_plain`` and ``backsub_plain`` against the JAX DBA's
own contractions (``pvo_tpu/vo/dba.py``: the Schur einsums, the pair
einsum, the rhs correction; the retraction, the edge-term segment sum
and the back-substitution);
``dba.dba`` with 0-d window tensors against ``jdba.dba``. Also: each
kernel's FLOP formula (``kbench.dba_bound``) equal to what
``FlopCounterMode`` counts in its plain version, and ``KernelFlops``
reading the same DBA call as the plain counter; the bounds at the
planner's shape; the wrappers' refusals on ``meta`` tensors (under grad,
wrong shapes); the counters' wiring; the index lists built once a call;
the import walk over ``cuda_dba.py``.

On the card (``cuda`` marker, skipped here): ``dba_probe.check`` at
each of its shapes (30x101 with E=144, K=P=32 and 2048 slots; E=48;
47x156; 128x40; E=1; motion-only; E=48 at 47x155; the backend's
recorded call, E=1008 over K=100 frames; crowded, E=958 over 32
frames): each kernel within 1e-4 of its plain version relative to the output's largest magnitude, bit-equal
twice, a CUDA-graph replay equal to the eager call, and ``dba.dba``'s
poses and disparities after 2 iterations within 1e-4 abs/rel of the
plain versions'. The JAX tests import JAX inside and skip without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_dba_kernels.py -q -m cuda
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pvo_tpu_torch.scripts import dba_probe, kbench, trace_track
from pvo_tpu_torch.vo import dba as tdba
from pvo_tpu_torch.vo import graph_capture
from pvo_tpu_torch.vo.net import cuda_dba, cuda_segsum

from torch_one_thread import one_thread  # noqa: F401

SCENES = [(4, 6), (6, 10)]
TOL = 1e-5


def scene(h, w, E=16, F=8, K=7, pad=3, n_pairs=120, seed=0):
    """DBA arguments (numpy): F frames, E edges between nearby frames of
    [0, K) (the last ``pad`` invalid), targets near the projections,
    random weights, the edge pairs in ``n_pairs`` slots."""
    rng = np.random.RandomState(seed)
    poses = np.zeros((F, 7), np.float32)
    q = np.concatenate([0.02 * rng.randn(F, 3), np.ones((F, 1))], 1)
    poses[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    poses[:, :3] = 0.1 * rng.randn(F, 3)
    disps = (0.8 + 0.2 * rng.rand(F, h, w)).astype(np.float32)
    intr = np.array([10.0, 10.0, w / 2.0, h / 2.0], np.float32)
    ii = rng.randint(0, K, E)
    jj = (ii + 1 + rng.randint(0, 2, E)) % K
    valid = np.arange(E) < E - pad
    target = (np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None] +
              rng.randn(E, h, w, 2)).astype(np.float32)
    weight = (rng.rand(E, h, w, 2) * valid[:, None, None, None]).astype(
        np.float32)
    eta = (1e-2 * np.ones((K, h, w))).astype(np.float32)
    pa, pb, pv = tdba.build_edge_pairs(ii, valid, n_pairs)
    return (poses, disps, intr, target, weight, eta, ii.astype(np.int64),
            jj.astype(np.int64), valid, pa, pb, pv)


def torch_args(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def depth_terms(h, w, E=16, K=7, n_pairs=120, P=6, F=8, seed=1):
    """Seeded inputs of the Schur terms and the back-substitution."""
    rng = np.random.RandomState(seed)
    HW = h * w
    Ei_m = rng.randn(K, 6, HW).astype(np.float32)
    Ej = rng.randn(E, 6, HW).astype(np.float32)
    Ej[-3:] = 0.0                                  # padded edges
    C = (1.0 + rng.rand(K, HW)).astype(np.float32)
    eta = (1e-2 * np.ones((K, HW))).astype(np.float32)
    w_m = rng.randn(K, HW).astype(np.float32)
    m = rng.randint(0, K, E).astype(np.int64)
    valid = np.arange(E) < E - 3
    pa, pb, pv = tdba.build_edge_pairs(m, valid, n_pairs)
    dx = (0.1 * rng.randn(P, 6)).astype(np.float32)
    pj_sel = np.where(rng.rand(E) < 0.8, rng.randint(0, P, E), -1)
    pm_sel = np.where(rng.rand(K) < 0.8, rng.randint(0, P, K), -1)
    t_edge = rng.randn(K, HW).astype(np.float32)
    disps = (0.5 + rng.rand(F, h, w)).astype(np.float32)
    frame_k = np.where(np.arange(F) < K, np.arange(F) - 1, -1)
    # the retraction's poses and rows, and each edge's depth frame as the
    # back-substitution sums it (K: masked; the padded edges and a tenth)
    q = np.concatenate([0.1 * rng.randn(F, 3), np.ones((F, 1))], 1)
    poses = np.concatenate([0.5 * rng.randn(F, 3),
                            q / np.linalg.norm(q, axis=1, keepdims=True)],
                           1).astype(np.float32)
    frame_row = np.where(rng.rand(F) < 0.75, rng.randint(0, P, F), -1)
    m_k = np.where(valid & (rng.rand(E) < 0.9), m, K)
    return dict(Ei_m=Ei_m, Ej=Ej, C=C, eta=eta, w_m=w_m, m=m, pa=pa, pb=pb,
                pv=pv, dx=dx, pj_sel=pj_sel.astype(np.int64),
                pm_sel=pm_sel.astype(np.int64), t_edge=t_edge, disps=disps,
                frame_k=frame_k.astype(np.int64), poses=poses,
                frame_row=frame_row.astype(np.int64),
                m_k=m_k.astype(np.int64))


def backsub_args(d, motion_only=False):
    """:func:`cuda_dba.backsub`'s arguments from :func:`depth_terms`."""
    names = ("poses", "dx", "frame_row", "disps") + (() if motion_only else (
        "Ej", "pj_sel", "m_k", "Ei_m", "pm_sel", "C", "eta", "w_m",
        "frame_k"))
    return [torch.as_tensor(d[k]) for k in names]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------- against the JAX DBA

@pytest.mark.parametrize("hw", SCENES)
def test_linearize_plain_is_the_jax_edge_blocks(hw):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pvo_tpu.geom.ba import _edge_blocks
    args = scene(*hw)
    poses, disps, intr, target, weight, _, ii, jj, valid = args[:9]
    F = poses.shape[0]
    want = _edge_blocks(jnp.asarray(target)[None], jnp.asarray(weight)[None],
                        jnp.asarray(poses)[None], jnp.asarray(disps)[None],
                        jnp.broadcast_to(jnp.asarray(intr), (1, F, 4)), ii, jj)
    vmask = valid.astype(np.float32)
    T = torch_args(args)
    got = cuda_dba.linearize_plain(*T[:5], T[6], T[7], T[8])
    for g, wnt in zip(got, want):
        m = vmask.reshape((-1,) + (1,) * (wnt.ndim - 2))
        close(g.numpy(), np.asarray(wnt[0]) * m)
    motion = cuda_dba.linearize_plain(*T[:5], T[6], T[7], T[8],
                                      motion_only=True)
    assert motion[2:] == (None,) * 4
    assert all(torch.equal(a, b) for a, b in zip(motion[:2], got[:2]))


@pytest.mark.parametrize("hw", SCENES)
def test_schur_plain_is_the_jax_contractions(hw):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    d = depth_terms(*hw)
    K, E = d["Ei_m"].shape[0], d["Ej"].shape[0]
    J = {k: jnp.asarray(v) for k, v in d.items()}
    # pvo_tpu/vo/dba.py: Q, the (a)+(b) einsum, the pair einsum, the rhs
    Q = 1.0 / (J["C"] + J["eta"])
    mc = jnp.clip(J["m"], 0, K - 1)
    SS = jnp.einsum("xdh,xh,xeh->xde",
                    jnp.concatenate([J["Ei_m"], J["Ei_m"][mc]]),
                    jnp.concatenate([Q, Q[mc]]),
                    jnp.concatenate([J["Ei_m"], J["Ej"]]))
    SSc = jnp.einsum("pdh,ph,peh->pde", J["Ej"][J["pa"]], Q[mc][J["pa"]],
                     J["Ej"][J["pb"]])
    rows = jnp.concatenate([SS[:K], SS[K:], jnp.swapaxes(SS[K:], -1, -2),
                            SSc * J["pv"][:, None, None]])
    rc = jnp.einsum("xdh,xh,xh->xd", jnp.concatenate([J["Ei_m"], J["Ej"]]),
                    jnp.concatenate([Q, Q[mc]]),
                    jnp.concatenate([J["w_m"], J["w_m"][mc]]))
    T = {k: torch.from_numpy(v) for k, v in d.items()}
    for chunk in (2048, 7):
        got_rows, got_rc = cuda_dba.schur_plain(
            T["Ei_m"], T["Ej"], T["C"], T["eta"], T["w_m"],
            T["m"].clamp(0, K - 1), T["pa"], T["pb"], T["pv"], chunk)
        assert got_rows.shape == (K + 2 * E + len(d["pa"]), 6, 6)
        close(got_rows.numpy(), rows)
        close(got_rc.numpy(), rc)
        assert not got_rows[K + 2 * E:][~T["pv"]].any()


@pytest.mark.parametrize("hw", SCENES)
def test_backsub_plain_is_the_jax_back_substitution(hw):
    """The fused entry's plain version (poses and disparities) against the
    JAX DBA's retraction, edge-term segment sum and back-substitution;
    its motion-only form retracts alone."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from pvo_tpu.lie import se3 as jse3
    d = depth_terms(*hw)
    K, E, P = d["Ei_m"].shape[0], d["Ej"].shape[0], d["dx"].shape[0]
    F = d["disps"].shape[0]
    J = {k: jnp.asarray(v) for k, v in d.items()}
    dx_f = jnp.where((J["frame_row"] >= 0)[:, None],
                     J["dx"][jnp.clip(J["frame_row"], 0, P - 1)], 0.0)
    poses = jse3.retr(J["poses"], dx_f)
    dx_pj = jnp.where((J["pj_sel"] >= 0)[:, None],
                      J["dx"][jnp.clip(J["pj_sel"], 0, P - 1)], 0.0)
    t_edge = jax.ops.segment_sum(jnp.einsum("edh,ed->eh", J["Ej"], dx_pj),
                                 J["m_k"], num_segments=K + 1)[:K]
    dx_pm = jnp.where((J["pm_sel"] >= 0)[:, None],
                      J["dx"][jnp.clip(J["pm_sel"], 0, P - 1)], 0.0)
    t_self = jnp.einsum("kdh,kd->kh", J["Ei_m"], dx_pm)
    Q = 1.0 / (J["C"] + J["eta"])
    dz = Q * (J["w_m"] - t_self - t_edge)
    rows = jnp.where(J["frame_k"] >= 0, jnp.arange(F), F)
    src = jnp.clip(J["frame_k"], 0, K - 1)
    dz_full = jnp.zeros((F + 1, dz.shape[1])).at[rows].set(dz[src])[:F]
    new = jnp.maximum(J["disps"] + dz_full.reshape(J["disps"].shape), 0.001)
    got_p, got_d = cuda_dba.backsub_plain(*backsub_args(d))
    close(got_p.numpy(), jax.device_get(poses))
    close(got_d.numpy(), jax.device_get(new))
    motion = cuda_dba.backsub_plain(*backsub_args(d, motion_only=True))
    assert torch.equal(motion[0], got_p)
    assert torch.equal(motion[1], torch.from_numpy(d["disps"]))


@pytest.mark.parametrize("hw", SCENES)
@pytest.mark.parametrize("case", [
    dict(t0=1, t1=8, w0=0, P=7, K=7, iters=2),
    dict(t0=1, t1=7, w0=1, P=6, K=7, iters=2, motion_only=True),
])
def test_dba_with_device_windows_matches_jax(hw, case):
    """``dba.dba`` with t0, t1, w0 as 0-d tensors (the planner's) against
    the JAX DBA with the same windows as ints."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pvo_tpu.vo import dba as jdba
    args = scene(*hw, F=8, K=case["K"])
    opts = {k: v for k, v in case.items() if k not in ("t0", "t1", "w0")}
    pj, dj = jdba.dba(*[jnp.asarray(a) for a in args], case["t0"],
                      case["t1"], case["w0"], **opts)
    pt, dt = tdba.dba(*torch_args(args), torch.tensor(case["t0"]),
                      torch.tensor(case["t1"]), torch.tensor(case["w0"]),
                      **opts)
    close(pt.numpy(), pj)
    close(dt.numpy(), dj)


# ------------------------------------------------- counts, bounds, wiring

@pytest.mark.parametrize("hw", SCENES)
def test_flop_formulas_are_the_plain_versions_counts(hw):
    h, w = hw
    HW = h * w
    args = torch_args(scene(h, w))
    poses, disps, intr, target, weight, _, ii, jj, valid = args[:9]
    d = {k: torch.from_numpy(v) for k, v in depth_terms(h, w).items()}
    K, E, NP = d["Ei_m"].shape[0], d["Ej"].shape[0], d["pa"].shape[0]
    calls = [
        (lambda: cuda_dba.linearize_plain(poses, disps, intr, target, weight,
                                          ii, jj, valid),
         kbench.dba_bound("dba_linearize", target.shape[0], 0, HW)),
        (lambda: cuda_dba.schur_plain(d["Ei_m"], d["Ej"], d["C"], d["eta"],
                                      d["w_m"], d["m"], d["pa"], d["pb"],
                                      d["pv"], 7),
         kbench.dba_bound("dba_schur", E, K, HW, NP=NP)),
        (lambda: cuda_dba.backsub_plain(*backsub_args(d)),
         kbench.dba_bound("dba_backsub", E, K, HW, F=d["disps"].shape[0])),
        (lambda: cuda_dba.backsub_plain(*backsub_args(d, motion_only=True)),
         kbench.dba_bound("dba_backsub", E, K, HW, F=d["disps"].shape[0],
                          motion_only=True)),
    ]
    for fn, bound in calls:
        with FlopCounterMode(display=False) as c:
            fn()
        assert c.get_total_flops() == bound["flops"]


def test_kernel_flops_read_the_plain_count_of_a_dba_call():
    """trace_track's shims count a whole DBA call as the counter counts
    its plain versions, the segment sums' adds apart (the counter does
    not count index_add_)."""
    args = torch_args(scene(4, 6))
    with FlopCounterMode(display=False) as plain:
        tdba.dba(*args, 1, 8, 0, P=7, K=7, iters=2)
    counter = trace_track.KernelFlops()
    with counter():
        tdba.dba(*args, 1, 8, 0, P=7, K=7, iters=2)
    assert counter.kernels["dba_linearize"][0] == 2
    assert counter.kernels["dba_schur"][0] == 2
    assert counter.kernels["dba_backsub"][0] == 2
    assert counter.kernels["dba_solve"] == [
        2, 2 * kbench.dba_bound("dba_solve", P=7)["flops"]]
    # the counter sees neither the segment sums' adds nor the solve's
    # factorization and triangular solves
    assert counter.total - counter.kernels["segsum"][1] - \
        counter.kernels["dba_solve"][1] == plain.get_total_flops()


def test_bounds_at_the_planners_shape():
    """E=144, K=32, HW=30x101, 2048 slots: the linearization moves 33.3
    MB (8.7 read), 8.8 MB motion-only, where its products bound it;
    bytes bound the others but the Schur terms with every slot valid."""
    E, K, HW = 144, 32, 30 * 101
    lin = kbench.dba_bound("dba_linearize", E, K, HW)
    assert round(lin["bytes"] / 1e6, 1) == 33.3
    mo = kbench.dba_bound("dba_linearize", E, K, HW, motion_only=True)
    assert round(mo["bytes"] / 1e6, 1) == 8.8
    assert (lin["bound_by"], mo["bound_by"]) == ("bytes", "operations")
    full = kbench.dba_bound("dba_schur", E, K, HW, NP=2048)
    real = kbench.dba_bound("dba_schur", E, K, HW, NP=2048, valid_pairs=600)
    assert full["bytes"] == real["bytes"] and full["flops"] > real["flops"]
    assert full["bound_by"] == "operations" and real["bound_by"] == "bytes"
    back = kbench.dba_bound("dba_backsub", E, K, HW, F=40, P=32)
    assert back["bound_by"] == "bytes" and 14e6 < back["bytes"] < 18e6
    with pytest.raises(ValueError):
        kbench.dba_bound("dba_nothing", E, K, HW)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_refuse_grad_and_shapes_off_the_cpu():
    """Off the CPU (``meta`` tensors reach the checks without a card): an
    input under grad raises, as does a wrong shape, before any launch."""
    idx = meta(5, dtype=torch.int64)
    lin = [meta(8, 7), meta(8, 4, 6), meta(4), meta(5, 4, 6, 2),
           meta(5, 4, 6, 2), idx, idx, meta(5, dtype=torch.bool)]
    lin[0].requires_grad_()
    Ei_m, Ej, plane = meta(3, 6, 24), meta(5, 6, 24), meta(3, 24)
    slots = meta(9, dtype=torch.int64)
    calls = {
        "linearize": lin,
        "schur": [Ei_m.requires_grad_(), Ej, plane, plane, plane, idx,
                  slots, slots, meta(9, dtype=torch.bool)],
        "backsub": [meta(8, 7), meta(4, 6), meta(8, dtype=torch.int64),
                    meta(8, 4, 6).requires_grad_(), Ej, idx, idx,
                    meta(3, 6, 24), meta(3, dtype=torch.int64), plane,
                    plane, plane, meta(8, dtype=torch.int64)],
    }
    before = dict(cuda_dba.LAUNCHES)
    for name, args in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            getattr(cuda_dba, name)(*args)
        args = [a.detach() for a in args]
        args[0] = args[0][:-1]
        with pytest.raises(ValueError):
            getattr(cuda_dba, name)(*args)
    assert cuda_dba.LAUNCHES == before


def test_counters_are_wired():
    assert cuda_dba.KERNELS == ("dba_linearize", "dba_schur", "dba_backsub",
                                "dba_solve")
    assert set(cuda_dba.LAUNCHES) == {*cuda_dba.KERNELS, "dba_solve_grid"}
    assert cuda_dba.LAUNCHES in graph_capture.COUNTERS
    counts = kbench.launch_counts()
    assert all(k in counts for k in cuda_dba.KERNELS)
    shimmed = {(mod, name) for mod, name, _, _ in trace_track.WRAPPERS}
    # one shim counts the solve's wrapper, whichever kernel it launches
    assert not any(hasattr(cuda_dba, k) for k in ("solve_library",
                                                   "solve_route"))
    for name in ("linearize", "schur", "backsub", "solve"):
        assert (cuda_dba, name) in shimmed
        assert callable(getattr(cuda_dba, name + "_plain"))


    class Graph:
        def per_replay(self, ran):
            return {"segsum": 30, "dba_linearize": 12, "dba_schur": 12,
                    "dba_backsub": 12, "dba_solve": 12,
                    "dba_solve_grid": 0}

    class Planner:
        frame_graph = Graph()

        def sections(self, rec):
            return ()
    counted = trace_track.replay_counted(Planner(), [None, None])
    assert counted["dba_backsub"] == 24 and counted["segsum"] == 60
    assert counted["dba_solve"] == 24 and counted["dba_solve_grid"] == 0


def test_indices_are_built_once_a_call(monkeypatch):
    built = []
    real = tdba._indices

    def counted(*a, **kw):
        built.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tdba, "_indices", counted)
    tdba.dba(*torch_args(scene(4, 6)), 1, 8, 0, P=7, K=7, iters=3)
    assert built == [1]


def test_the_import_walk_reads_cuda_dba():
    from test_torch_kernel_bounds import port_sources, imported_modules
    root = Path(__file__).resolve().parents[1] / "pvo_tpu_torch"
    for rel in ("vo/net/cuda_dba.py", "scripts/dba_probe.py", "vo/dba.py"):
        assert root / rel in port_sources()
        assert not [m for m in imported_modules(root / rel)
                    if m.split(".")[0] in ("jax", "jaxlib", "pvo_tpu")]


def test_probe_stages_on_the_cpu():
    """dba_probe's inputs and stages at a small shape: each wrapper on
    the CPU is its plain version, and ``plain()`` swaps and restores."""
    a = dba_probe.inputs(6, 4, 4, 6, 24, "cpu")
    st = dba_probe.stages(a)
    for k, args in st.items():
        got = getattr(cuda_dba, k)(*args)
        want = getattr(cuda_dba, k + "_plain")(*args)
        for g, w in zip(dba_probe._outs(got), dba_probe._outs(want)):
            assert torch.equal(g, w)
    saved = cuda_dba.linearize
    with dba_probe.plain():
        assert cuda_dba.linearize is cuda_dba.linearize_plain
        p1, d1 = dba_probe.call_dba(a)
    assert cuda_dba.linearize is saved
    p2, d2 = dba_probe.call_dba(a)
    assert torch.equal(p1, p2) and torch.equal(d1, d2)
    assert torch.isfinite(p1).all() and torch.isfinite(d1).all()


# ------------------------------------------------------------ the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(dba_probe.SHAPES))
def test_kernels_against_plain_on_the_card(dev, name):
    cuda_dba.reset_launches()
    res = dba_probe.check(name)
    assert not dba_probe.failures(res), res
    assert cuda_dba.LAUNCHES["dba_linearize"] > 0


@pytest.mark.cuda
def test_segment_sums_unchanged_a_full_iteration(dev):
    """Two segment-sum launches a full iteration and, with the kernels,
    one linearization, one Schur launch, one solve and one
    back-substitution (the update after the solve: no edge-term sum, no
    eager retraction)."""
    a = dba_probe.inputs(48, 32, 30, 101, 512, dev)
    cuda_segsum.reset_launches()
    cuda_dba.reset_launches()
    dba_probe.call_dba(a, iters=2)
    assert cuda_segsum.LAUNCHES["segsum"] == 4
    assert cuda_dba.LAUNCHES == {"dba_linearize": 2, "dba_schur": 2,
                                 "dba_backsub": 2, "dba_solve": 2,
                                 "dba_solve_grid": 0}
