"""The DBA iteration's update after the solve (``cuda_dba.backsub``,
kernel ``dba_backsub`` in ``csrc/dba.cu``): the pose retraction, the edge
terms summed per depth frame, dz and the disparities in one launch.

On the CPU, on numpy inputs from a seed:
- the plain version bit-equal to the composition ``vo/dba.py`` ran
  before (the dx scatter by ``pose_rows`` and ``se3.retr``, the edge
  terms, their zero-start segment sum, the depth pass) at 4x6, 6x10,
  the planner's shape (E=144, K=P=32, 30x101) and the backend's recorded
  call (``scripts/dba_backend_call.json``: E=1008 over K=100, P=99);
- the plain version against the JAX DBA's own tail
  (``pvo_tpu/vo/dba.py:250-277``: the retraction, the back-substitution),
  full and motion-only, within 1e-5 abs/rel (f32 sums in other orders);
- an emulation of the kernel (each depth frame's edge list built from
  ``m_k`` a chunk of threads at a time, the terms added in ascending edge
  order from +0.0): its order of sums bit-equal to the CPU's
  ``index_add_`` into zeros (which the card's segment sum equals), and
  its disparities within 1e-6 of the plain version's, where edges are
  masked, have no pose row, point outside the depth window, frames lie
  outside the window or past t1, and a depth frame has no edges;
- the kernel's scalar retraction (each f32 operation as the device code
  rounds it) against ``pvo_tpu_torch.lie.se3.retr`` and the JAX
  ``se3.retr`` in both small-angle branches, within 1e-6 abs/rel, and a
  zero tangent retracting exactly (the kernel copies such a pose);
- ``_indices``' ``frame_row`` against the ``pose_rows`` it replaces;
- the wrapper's refusals on ``meta`` tensors.
The card's checks are ``dba_probe`` (phase 3 of ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.scripts import dba_probe
from pvo_tpu_torch.vo import dba as tdba
from pvo_tpu_torch.vo.net import cuda_dba, cuda_segsum

from torch_one_thread import one_thread  # noqa: F401

TOL = 1e-5
# the emulation's fmaf chains are formed in f64 and rounded once to f32,
# the plain version's einsum in its own order
EMU_TOL = 1e-6
# the scalar retraction against se3.retr: the same f32 operations but for
# the 3x3 products' order
RETR_TOL = 1e-6


def graph(E, K, F, seed):
    """Edges (ii, jj, valid) over F frames: ii partly outside [0, K), a
    tenth and the last invalid, frame 2 the source of none."""
    rng = np.random.RandomState(seed)
    ii = rng.randint(0, min(F, K + 3), E)
    ii[ii == 2] = 3
    jj = np.minimum(ii + 1 + rng.randint(0, 3, E), F - 1)
    valid = rng.rand(E) > 0.1
    valid[-1] = False
    return ii.astype(np.int64), jj.astype(np.int64), valid


def update_case(h, w, E=16, K=7, P=6, F=10, t0=1, t1=8, w0=0, seed=0,
                edges=None):
    """The update's inputs after a solve: seeded planes, dx, poses and
    disparities, the index lists of ``dba._indices`` over ``edges`` (ii,
    jj, valid) or :func:`graph`'s, and the windows."""
    rng = np.random.RandomState(seed)
    ii, jj, valid = edges if edges is not None else graph(E, K, F, seed)
    E, HW = len(ii), h * w
    q = np.concatenate([0.1 * rng.randn(F, 3), np.ones((F, 1))], 1)
    poses = np.concatenate([0.5 * rng.randn(F, 3),
                            q / np.linalg.norm(q, axis=1, keepdims=True)], 1)
    d = dict(
        poses=poses.astype(np.float32),
        dx=(0.05 * rng.randn(P, 6)).astype(np.float32),
        disps=(0.02 + rng.rand(F, h, w)).astype(np.float32),
        Ej=rng.standard_normal((E, 6, HW)).astype(np.float32),
        Ei_m=rng.standard_normal((K, 6, HW)).astype(np.float32),
        C=(1.0 + rng.rand(K, HW)).astype(np.float32),
        eta=(1e-2 * np.ones((K, HW))).astype(np.float32),
        w_m=rng.standard_normal((K, HW)).astype(np.float32))
    T = {k: torch.from_numpy(v) for k, v in d.items()}
    ix = tdba._indices(*(torch.from_numpy(a) for a in (ii, jj, valid)),
                       torch.zeros(1, dtype=torch.int64),
                       torch.zeros(1, dtype=torch.int64),
                       torch.zeros(1, dtype=torch.bool),
                       torch.tensor(t0), torch.tensor(t1), torch.tensor(w0),
                       P, K, F)
    return T, ix, dict(ii=ii, jj=jj, valid=valid, t0=t0, t1=t1, w0=w0, P=P,
                       K=K, F=F)


def fused_args(T, ix, motion_only=False):
    head = (T["poses"], T["dx"], ix.frame_row, T["disps"])
    if motion_only:
        return head
    return head + (T["Ej"], ix.pj_sel, ix.m_k, T["Ei_m"], ix.pm_sel, T["C"],
                   T["eta"], T["w_m"], ix.frame_k)


def pose_rows(P, F, t0, t1):
    """The (P,) frame of each pose row, F past t1: the list ``vo/dba.py``
    scattered dx by before ``frame_row``."""
    rows = torch.arange(P) + t0
    return torch.where(rows < t1, rows, torch.full_like(rows, F))


def earlier_update(T, ix, w, motion_only=False):
    """The composition ``vo/dba.py`` ran after the solve before the fused
    launch, on the CPU: the dx scatter, ``se3.retr``, the edge terms, their
    segment sum and the depth pass (kept here as it was)."""
    dx, F = T["dx"], T["poses"].shape[0]
    dx_full = dx.new_zeros((F + 1, 6))
    dx_full[pose_rows(w["P"], F, w["t0"], w["t1"])] = dx
    new_poses = se3.retr(T["poses"], dx_full[:F])
    if motion_only:
        return new_poses, T["disps"]
    K = T["Ei_m"].shape[0]
    te = torch.einsum("edh,ed->eh", T["Ej"], cuda_dba._dx_rows(dx, ix.pj_sel))
    t_edge, = cuda_segsum.sums([cuda_segsum.zero_sum(te, ix.m_k, K)])
    Q = 1.0 / (T["C"] + T["eta"])
    t_self = torch.einsum("kdh,kd->kh", T["Ei_m"],
                          cuda_dba._dx_rows(dx, ix.pm_sel))
    dz = Q * (T["w_m"] - t_self - t_edge)
    ok = (ix.frame_k >= 0)[:, None]
    dz_full = torch.where(ok, dz[ix.frame_k.clamp(0, K - 1)], 0.0)
    new = T["disps"] + dz_full.reshape(T["disps"].shape)
    return new_poses, torch.clamp(new, min=0.001)


def backend_case(h, w):
    call = dba_probe.backend_call()
    E = len(call["ii"])
    edges = (np.asarray(call["ii"], np.int64), np.asarray(call["jj"], np.int64),
             np.ones(E, bool))
    return update_case(h, w, K=call["K"], P=call["P"], F=call["F"],
                       t0=call["t0"], t1=call["t1"], w0=call["w0"], seed=3,
                       edges=edges)


CASES = {
    "4x6": lambda: update_case(4, 6),
    "6x10": lambda: update_case(6, 10, t0=0, t1=9, w0=1, seed=1),
    "planner": lambda: update_case(30, 101, E=144, K=32, P=32, F=40, t0=1,
                                   t1=32, w0=0, seed=2),
    "backend": lambda: backend_case(30, 101),
}


@pytest.mark.parametrize("motion_only", [False, True],
                         ids=["full", "motion_only"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_is_the_earlier_composition_bit_for_bit(name, motion_only):
    T, ix, w = CASES[name]()
    got = cuda_dba.backsub_plain(*fused_args(T, ix, motion_only))
    want = earlier_update(T, ix, w, motion_only)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # through the wrapper, which takes the plain version on the CPU
    again = cuda_dba.backsub(*fused_args(T, ix, motion_only))
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def jax_tail(T, w, motion_only):
    """``pvo_tpu/vo/dba.py:250-277`` (the JAX DBA's one_iteration after its
    solve) on the same dx, poses and depth terms, with Q = 1 / (C + eta)."""
    import jax
    import jax.numpy as jnp
    from pvo_tpu.lie import se3 as jse3
    J = {k: jnp.asarray(v.numpy()) for k, v in T.items()}
    ii, jj, valid = (jnp.asarray(w[k]) for k in ("ii", "jj", "valid"))
    t0, t1, w0, P, K, F = (w[k] for k in ("t0", "t1", "w0", "P", "K", "F"))
    dx, poses, disps = J["dx"], J["poses"], J["disps"]
    h, wd = disps.shape[-2:]
    HW, D = h * wd, 6
    pj, m = jj - t0, ii - w0
    ok_j = valid & (pj >= 0) & (pj < P)
    ok_m = valid & (m >= 0) & (m < K)
    pm = jnp.arange(K) + w0 - t0
    ok_pm = (pm >= 0) & (pm < P)
    Q = 1.0 / (J["C"] + J["eta"])

    def seg(x, idx, ok, n):
        idx = jnp.where(ok, idx, n)
        return jax.ops.segment_sum(x, idx, num_segments=n + 1)[:n]

    rows = jnp.arange(P, dtype=jnp.int32) + t0
    ok_rows = rows < t1
    dx_full = jnp.zeros((F + 1, D), poses.dtype).at[
        jnp.where(ok_rows, rows, F)].set(dx)[:F]
    new_poses = jse3.retr(poses, dx_full)
    if motion_only:
        return new_poses, disps
    dx_pm = jnp.where(ok_pm[:, None], dx[jnp.clip(pm, 0, P - 1)], 0.0)
    t_self = jnp.einsum("kdh,kd->kh", J["Ei_m"], dx_pm)
    dx_pj = jnp.where(ok_j[:, None], dx[jnp.clip(pj, 0, P - 1)], 0.0)
    t_edge = seg(jnp.einsum("edh,ed->eh", J["Ej"], dx_pj), m, ok_m, K)
    dz = Q * (J["w_m"] - t_self - t_edge)
    krows = jnp.arange(K, dtype=jnp.int32) + w0
    ok_k = krows < t1
    dz = jnp.where(ok_k[:, None], dz, 0.0)
    new_disps = jnp.reshape(
        disps.reshape(F, HW) + jnp.zeros((F + 1, HW), disps.dtype).at[
            jnp.where(ok_k, krows, F)].set(dz.astype(disps.dtype))[:F],
        (F, h, wd))
    return new_poses, jnp.maximum(new_disps, 0.001)


@pytest.mark.parametrize("motion_only", [False, True],
                         ids=["full", "motion_only"])
@pytest.mark.parametrize("name", ["4x6", "6x10"])
def test_plain_is_the_jax_tail(name, motion_only):
    pytest.importorskip("jax")
    T, ix, w = CASES[name]()
    want = jax_tail(T, w, motion_only)
    got = cuda_dba.backsub_plain(*fused_args(T, ix, motion_only))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=TOL,
                                   atol=TOL)


# ----------------------------------------------- the kernel's arithmetic

def fmaf(a, b, c):
    """fmaf on f32 arrays: the product exact in f64, one rounding (but
    for a double rounding in rare halfway cases)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate(poses, dx, frame_row, disps, Ej, pj_sel, m_k, Ei_m, pm_sel, C,
            eta, w_m, frame_k, threads=256):
    """``dba_backsub_kernel``'s depth blocks on the CPU (a frame's pixels
    at once), in numpy: for a frame of depth frame k >= 0, k's edges from
    m_k a chunk of ``threads`` at a time in edge order, their dx rows
    (zeros without one), each term the fmaf chain over d, the terms added
    from +0.0 in that order; then dz, z + dz, the clamp. Returns the
    disparities and t_edge for each depth frame a frame reached."""
    n = lambda t: t.numpy()  # noqa: E731
    Ej, Ei_m, C, eta, w_m, dx = map(n, (Ej, Ei_m, C, eta, w_m, dx))
    pj_sel, m_k, pm_sel, frame_k = map(n, (pj_sel, m_k, pm_sel, frame_k))
    F, HW = disps.shape[0], Ej.shape[-1]
    z = n(disps).reshape(F, HW).copy()
    zero = np.zeros(6, np.float32)

    def row_dot(planes, dxr):
        s = np.zeros(HW, np.float32)
        for d in range(6):
            s = fmaf(planes[d], dxr[d], s)
        return s
    sums = {}
    for f in range(F):
        k = frame_k[f]
        if k >= 0:
            te = np.zeros(HW, np.float32)
            for base in range(0, len(m_k), threads):
                for e in np.flatnonzero(m_k[base:base + threads] == k) + base:
                    s = pj_sel[e]
                    te = te + row_dot(Ej[e], dx[s] if s >= 0 else zero)
            sums[k] = te
            Q = np.float32(1) / (C[k] + eta[k])
            dxs = dx[pm_sel[k]] if pm_sel[k] >= 0 else zero
            z[f] = fmaf(Q, w_m[k] - row_dot(Ei_m[k], dxs) - te, z[f])
        z[f] = np.where(z[f] < np.float32(0.001), np.float32(0.001), z[f])
    return torch.from_numpy(z.reshape(disps.shape)), sums


@pytest.mark.parametrize("threads", [256, 4])
def test_emulated_kernel_covers_the_windows(threads):
    """The cases the kernel's lists meet, each present in the data; with
    4 threads the edges are compacted in several chunks."""
    T, ix, w = update_case(6, 10, E=24, K=7, P=5, F=12, t0=2, t1=7, w0=1,
                           seed=4)
    m_k, K = ix.m_k, w["K"]
    valid = torch.from_numpy(w["valid"])
    m = torch.from_numpy(w["ii"]) - w["w0"]
    assert ((m_k == K) & ~valid).any()                  # masked edges
    assert ((m_k == K) & valid & ((m < 0) | (m >= K))).any()  # outside [0, K)
    assert ((ix.pj_sel == -1) & (m_k < K)).any()        # summed, no pose row
    f = torch.arange(w["F"])
    assert ((f < w["w0"]) & (ix.frame_k == -1)).any()   # before the window
    assert ((f >= w["w0"] + K) & (ix.frame_k == -1)).any()  # past it
    assert ((f >= w["t1"]) & (f < w["w0"] + K)).any()   # in it, past t1
    empty = [k for k in range(K) if not (m_k == k).any()
             and (ix.frame_k == k).any()]
    assert empty                                        # no edges, updated
    got, sums = emulate(*fused_args(T, ix), threads=threads)
    want = cuda_dba.backsub_plain(*fused_args(T, ix))[1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=EMU_TOL,
                               atol=EMU_TOL)
    assert all(not s.any() for k, s in sums.items() if k in empty)
    # frames without a depth frame are only clamped
    off = ix.frame_k < 0
    assert torch.equal(got[off], T["disps"][off].clamp(min=0.001))


def test_emulated_order_is_the_zero_start_sum():
    """The kernel's order of the edge terms' sums (each depth frame's
    edges in ascending e, from +0.0, one f32 add each) is the CPU's
    index_add_ into zeros, bit for bit, on the same terms."""
    T, ix, w = CASES["planner"]()
    te = torch.einsum("edh,ed->eh", T["Ej"],
                      cuda_dba._dx_rows(T["dx"], ix.pj_sel))
    K = w["K"]
    want = cuda_segsum.index_add_plain(te.new_zeros((K, te.shape[1])),
                                       ix.m_k, te)
    for k in range(K):
        acc = torch.zeros(te.shape[1])
        for e in torch.nonzero(ix.m_k == k).flatten().tolist():
            acc = acc + te[e]
        assert torch.equal(acc, want[k])


# ------------------------------------------------------- the retraction

def retract_scalar(g, xi):
    """The device code's retraction of one pose (``retract`` in
    ``csrc/dba.cu``), every operation rounded to f32 as it is there."""
    f = np.float32
    g, xi = np.asarray(g, f), np.asarray(xi, f)
    rho, phi = xi[:3], xi[3:]
    ts = f(f(phi[0] * phi[0]) + f(phi[1] * phi[1])) + f(phi[2] * phi[2])
    small = ts < f(1e-6)
    th = np.sqrt(f(1) if small else ts)
    half = f(0.5) * th
    imag = f(0.5) - ts / f(48) if small else np.sin(half) / th
    real = f(1) - ts / f(8) if small else np.cos(half)
    v1 = imag * phi
    th2 = th * th
    c1 = f(0.5) - ts / f(24) if small else (f(1) - np.cos(th)) / th2
    c2 = (f(1) / f(6) - ts / f(120) if small else
          (th - np.sin(th)) / (th2 * th))
    Phi = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]],
                    [-phi[1], phi[0], 0]], f)
    t1 = np.zeros(3, f)
    for i in range(3):
        s = f(0)
        for j in range(3):
            pp = f(0)
            for l_ in range(3):
                pp = pp + Phi[i, l_] * Phi[l_, j]
            J = (f(1 if i == j else 0) + c1 * Phi[i, j]) + c2 * pp
            s = s + J * rho[j]
        t1[i] = s
    t2, v2, w2 = g[:3], g[3:6], g[6]
    out = np.zeros(7, f)
    out[6] = real * w2 - ((v1[0] * v2[0] + v1[1] * v2[1]) + v1[2] * v2[2])
    cross = lambda a, b: np.array([a[1] * b[2] - a[2] * b[1],  # noqa: E731
                                   a[2] * b[0] - a[0] * b[2],
                                   a[0] * b[1] - a[1] * b[0]], f)
    out[3:6] = (real * v2 + w2 * v1) + cross(v1, v2)
    uv = cross(v1, t2)
    uuv = cross(v1, uv)
    out[:3] = t1 + (t2 + f(2) * (real * uv + uuv))
    return out


def tangents():
    """Tangents in both branches of the closed forms: theta^2 well below,
    just below and just above 1e-6, and large."""
    rng = np.random.RandomState(7)
    out = []
    for theta in (1e-5, 0.9e-3, 1.1e-3, 0.02, 0.7, 2.5):
        axis = rng.randn(3)
        out.append(np.concatenate([0.3 * rng.randn(3),
                                   theta * axis / np.linalg.norm(axis)]))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("branch", ["small", "large"])
def test_scalar_retraction_is_se3_retr(branch):
    xi = tangents()
    theta_sq = (xi[:, 3:].astype(np.float64) ** 2).sum(1)
    xi = xi[theta_sq < 1e-6] if branch == "small" else xi[theta_sq >= 1e-6]
    assert len(xi) >= 2
    rng = np.random.RandomState(8)
    q = rng.randn(len(xi), 4)
    g = np.concatenate([rng.randn(len(xi), 3),
                        q / np.linalg.norm(q, axis=1, keepdims=True)],
                       1).astype(np.float32)
    got = np.stack([retract_scalar(a, b) for a, b in zip(g, xi)])
    want = se3.retr(torch.from_numpy(g), torch.from_numpy(xi)).numpy()
    assert np.max(np.abs(got - want) / (1 + np.abs(want))) <= RETR_TOL
    jax = pytest.importorskip("jax")
    from pvo_tpu.lie import se3 as jse3
    want_j = np.asarray(jax.device_get(jse3.retr(g, xi)))
    assert np.max(np.abs(got - want_j) / (1 + np.abs(want_j))) <= RETR_TOL
    # a zero tangent retracts exactly: the kernel copies the pose
    assert torch.equal(se3.retr(torch.from_numpy(g),
                                torch.zeros(len(xi), 6)),
                       torch.from_numpy(g))


# ------------------------------------------------------- the index lists

@pytest.mark.parametrize("window", [(0, 6, 6, 8), (1, 8, 7, 8),
                                    (3, 7, 6, 12), (2, 12, 10, 12)])
def test_frame_row_is_pose_rows(window):
    """frame_row[f] is the pose row p whose frame pose_rows[p] is f, and
    -1 for a frame no row reaches."""
    t0, t1, P, F = window
    ii = torch.tensor([0, 1]), torch.tensor([1, 2])
    ix = tdba._indices(*ii, torch.ones(2, dtype=torch.bool),
                       torch.zeros(1, dtype=torch.int64),
                       torch.zeros(1, dtype=torch.int64),
                       torch.zeros(1, dtype=torch.bool), torch.tensor(t0),
                       torch.tensor(t1), torch.tensor(0), P, 4, F)
    want = torch.full((F,), -1)
    rows = pose_rows(P, F, t0, t1)
    for p, f in enumerate(rows.tolist()):
        if f < F:
            want[f] = p
    assert torch.equal(ix.frame_row, want)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrapper_refuses_partial_depth_terms_off_the_cpu():
    """Off the CPU (``meta`` tensors reach the checks without a card):
    depth terms given in part, and a dx of the wrong width, raise before
    any launch."""
    i64 = dict(dtype=torch.int64)
    head = [meta(8, 7), meta(4, 6), meta(8, **i64), meta(8, 4, 6)]
    before = dict(cuda_dba.LAUNCHES)
    with pytest.raises(ValueError, match="all given or none"):
        cuda_dba.backsub(*head, meta(5, 6, 24))
    with pytest.raises(ValueError):
        cuda_dba.backsub(head[0], meta(4, 5), *head[2:])
    assert cuda_dba.LAUNCHES == before
    assert math.isfinite(dba_probe.POSE_TOL)
