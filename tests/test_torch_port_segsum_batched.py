"""The segment sum's zero start and batched entry (``vo/net/cuda_segsum.py``,
``csrc/segsum.cu``) and the launches the tracker makes of them.

On the CPU: the zero-start and batched plain entries bit-equal to
sequential ``Tensor.index_add_`` at every ``SITES`` shape of
``test_torch_port_segsum.py``, about a tenth of the rows out of range;
the groups ``vo/dba.py`` forms (three launches a full iteration, one a
motion-only one; E=12, P=K=8, h, w = 4, 6), each equal to its jobs one by
one; ``dba.dba`` bit-equal to a copy, kept here, of its earlier sequence
of nine sums an iteration; the wrapper's refusals before any launch (on
``meta`` tensors); the bounds of both modes and of a batch.

On the card (``cuda`` marker, skipped here): every entry and mode
bit-equal to the CPU's at the ``SITES`` shapes, at 5000 rows, one output
row, D=1, D=6, D not divisible by 4 and on misaligned views, one job and
a batch; the probe's planner-width cases and groups.

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_segsum_batched.py -q
"""

import numpy as np
import pytest
import torch

from pvo_tpu_torch.geom.ba import _edge_blocks
from pvo_tpu_torch.geom.chol import solve_psd
from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.vo import dba as dba_mod
from pvo_tpu_torch.vo.net import cuda_segsum
from pvo_tpu_torch.vo.net.cuda_segsum import Sum, index_add_plain

from test_torch_port_segsum import SITES
from torch_one_thread import one_thread  # noqa: F401

PAIR_CHUNK = dba_mod.PAIR_CHUNK


def inputs(shape_or_name, seed=0, device="cpu", drop=0.1):
    """(out, idx, x): numpy normals, idx uniform over the output rows with
    about ``drop`` of the rows sent out of range (-1 or n_out)."""
    n, n_out, shape = (SITES[shape_or_name] if isinstance(shape_or_name, str)
                       else shape_or_name)
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n,) + tuple(shape)).astype(np.float32)
    idx = rng.randint(0, max(n_out, 1), n)
    out_of_range = rng.rand(n) < drop
    idx[out_of_range] = np.where(rng.rand(int(out_of_range.sum())) < 0.5,
                                 -1, n_out)
    out = rng.standard_normal((n_out,) + tuple(shape)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (out, idx, x))


def sequential(out, idx, x, zero):
    """The CPU's index_add_ on the in-range rows, from zeros or out."""
    ok = (idx >= 0) & (idx < out.shape[0])
    start = torch.zeros_like(out) if zero else out.clone()
    return start.index_add_(0, idx[ok], x[ok])


@pytest.mark.parametrize("name", sorted(SITES))
def test_zero_start_plain_is_index_add_into_zeros(name):
    out, idx, x = inputs(name, seed=1)
    want = sequential(out, idx, x, True)
    # the buffer's values are not read
    got, = cuda_segsum.sums([Sum(torch.full_like(out, float("nan")), idx,
                                 x, True)])
    assert torch.equal(got, want)
    assert torch.equal(cuda_segsum.segment_sum(x, idx, out.shape[0]), want)


@pytest.mark.parametrize("name", sorted(SITES))
def test_batched_plain_is_the_jobs_in_order(name):
    """A batch of the site's job in both modes and of two other sites;
    and two jobs into one output, which the plain version runs in
    order."""
    others = sorted(SITES)
    names = [name, others[(others.index(name) + 3) % len(others)],
             others[(others.index(name) + 7) % len(others)]]
    cases = [inputs(n, seed=k) for k, n in enumerate(names)]
    jobs = [Sum(o.clone(), i, x, k % 2 == 1)
            for k, (o, i, x) in enumerate(cases)]
    jobs.append(Sum(cases[0][0].clone(), cases[0][1], cases[0][2], True))
    want = [sequential(o, i, x, z) for o, i, x, z in jobs]
    got = cuda_segsum.sums(jobs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out, idx, x = cases[0]
    half = x.shape[0] // 2
    acc = out.clone()
    cuda_segsum.sums([(acc, idx[:half], x[:half]), (acc, idx[half:], x[half:])])
    assert torch.equal(acc, sequential(out, idx, x, False))


def dba_case(E=12, P=8, K=8, F=10, h=4, w=6, seed=0, pad=2):
    """DBA arguments from numpy at a small size: poses near the
    identity, disparities about 1, E edges (the last ``pad`` invalid)
    between nearby frames, random targets and weights."""
    rng = np.random.RandomState(seed)
    poses = np.zeros((F, 7), np.float32)
    poses[:, 6] = 1.0
    poses[:, :3] = 0.05 * rng.standard_normal((F, 3))
    disps = (1.0 + 0.1 * rng.rand(F, h, w)).astype(np.float32)
    intr = np.array([10.0, 10.0, w / 2.0, h / 2.0], np.float32)
    ii = rng.randint(0, F - 2, E)
    jj = ii + 1 + rng.randint(0, 2, E)
    valid = np.arange(E) < E - pad
    target = (rng.rand(E, h, w, 2) * np.array([w, h])).astype(np.float32)
    weight = rng.rand(E, h, w, 2).astype(np.float32)
    eta = 1e-3 * np.ones((K, h, w), np.float32)
    pa, pb, pv = dba_mod.build_edge_pairs(ii, valid, 4 * E * E)
    return tuple(torch.from_numpy(np.asarray(a)) for a in
                 (poses, disps, intr, target, weight, eta, ii, jj, valid,
                  pa, pb, pv))


DBA_CASES = [
    dict(t0=1, t1=9, w0=0, P=8, K=8, iters=2),
    dict(t0=0, t1=7, w0=1, P=8, K=8, iters=1),
    dict(t0=2, t1=10, w0=2, P=8, K=8, iters=2, motion_only=True),
]


@pytest.mark.parametrize("case", DBA_CASES)
def test_dba_launches_three_groups(monkeypatch, case):
    """The sums dba.dba makes: (H, v, C, w, Ei), (the Schur sum, the rhs
    correction), (the edge term) a full iteration, (H, v) a motion-only
    one; every job zero-start; each call equal to its jobs one by one."""
    calls = []
    plain = cuda_segsum.sums

    def record(jobs):
        jobs = [Sum(*j) for j in jobs]
        want = [sequential(o, i, x, z) for o, i, x, z in jobs]
        got = plain(jobs)
        calls.append([tuple(j.out.shape) for j in jobs])
        assert all(j.zero for j in jobs)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return got
    monkeypatch.setattr(cuda_segsum, "sums", record)
    dba_mod.dba(*dba_case(), **case)
    P, K, D, HW = case["P"], case["K"], 6, 24
    if case.get("motion_only"):
        per_iter = [[(P * P, D, D), (P, D)]]
    else:
        per_iter = [[(P * P, D, D), (P, D), (K, HW), (K, HW), (K, D, HW)],
                    [(P * P, D, D), (P, D)], [(K, HW)]]
    assert calls == per_iter * case["iters"]


@pytest.mark.parametrize("chunk", [PAIR_CHUNK, 7])
@pytest.mark.parametrize("case", DBA_CASES)
def test_dba_equals_nine_call_sequence(monkeypatch, case, chunk):
    """dba.dba on the CPU bit-equal to its earlier form (below), which
    made nine sums a full iteration, each into a buffer with an overflow
    row, the pair chunks one by one; with one pair chunk and with
    several."""
    monkeypatch.setattr(dba_mod, "PAIR_CHUNK", chunk)
    monkeypatch.setitem(globals(), "PAIR_CHUNK", chunk)
    args = dba_case(seed=3)
    p1, d1 = dba_mod.dba(*args, **case)
    p2, d2 = nine_call_dba(*args, **case)
    assert torch.isfinite(p1).all() and torch.isfinite(d1).all()
    assert torch.equal(p1, p2)
    assert torch.equal(d1, d2)


def test_fault_probe_swaps_every_sum(monkeypatch):
    """fault_probe's scatter_sums reaches the batched sums too: every job
    of the DBA's three launches a full iteration runs through the chosen
    variant, which gives the same sums here; the entry comes back
    after."""
    from pvo_tpu_torch.scripts import fault_probe
    seen = []

    def add(out, idx, x):
        seen.append(tuple(out.shape))
        return index_add_plain(out, idx, x)
    monkeypatch.setitem(fault_probe.SUMS, "atomic", add)
    entry = cuda_segsum.sums
    args = dba_case(seed=5)
    want = dba_mod.dba(*args, **DBA_CASES[0])
    with fault_probe.scatter_sums("atomic"):
        got = dba_mod.dba(*args, **DBA_CASES[0])
    assert cuda_segsum.sums is entry
    assert len(seen) == DBA_CASES[0]["iters"] * (5 + 2 + 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_refusals_before_any_launch():
    """Off the CPU (``meta`` tensors reach the checks without a card):
    more than MAX_JOBS jobs, and an input under grad, raise."""
    out = torch.empty(4, 3, device="meta")
    idx = torch.zeros(5, dtype=torch.int64, device="meta")
    x = torch.empty(5, 3, device="meta")
    with pytest.raises(ValueError, match="at most"):
        cuda_segsum.sums([Sum(out, idx, x)] * (cuda_segsum.MAX_JOBS + 1))
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_segsum.sums([Sum(out, idx, x.requires_grad_())])


def test_bounds_of_both_modes_and_a_batch():
    """A zero-start sum does not read out; a batch's bound is its jobs'
    bytes and adds summed."""
    acc = kbench.segsum_bound(40, 48, 32, 100)
    zero = kbench.segsum_bound(40, 48, 32, 100, zero=True)
    assert acc["bytes"] - zero["bytes"] == 32 * 100 * 4
    assert zero["bytes"] == 40 * 100 * 4 + 48 * 8 + 32 * 100 * 4
    assert zero["flops"] == acc["flops"] == 40 * 100
    jobs = [Sum(*inputs(n, seed=k), zero=bool(k % 2))
            for k, n in enumerate(("graph_agg", "dba_pairs"))]
    both = kbench.segsum_jobs_bound(jobs)
    one = [kbench.segsum_jobs_bound([j]) for j in jobs]
    assert both["bytes"] == sum(b["bytes"] for b in one)
    assert both["flops"] == sum(b["flops"] for b in one)
    out, idx, x = jobs[1][:3]
    ok = int(((idx >= 0) & (idx < out.shape[0])).sum())
    assert one[1] == kbench.segsum_bound(ok, idx.shape[0], out.shape[0],
                                         36, True)


def test_probe_groups_fit_one_launch():
    from pvo_tpu_torch.scripts import segsum_probe
    for names in segsum_probe.GROUPS.values():
        assert set(names) <= set(segsum_probe.CASES)
        assert len(names) <= cuda_segsum.MAX_JOBS
    out, idx, x = segsum_probe.case_inputs("dba_rhs")
    dropped = float(((idx < 0) | (idx >= out.shape[0])).float().mean())
    assert 0.03 < dropped < 0.2


# ------------------------------------------------------------ the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


# (rows, output rows, row shape) beyond SITES: many rows (two windows of
# the kernel's sort), one output row, D = 1, 6, 3030 (not a multiple of
# 4) and a row of a multiple of 4 wider than one cluster's tile
EDGES = {
    "rows_5000": (5000, 64, (6, 6)),
    "one_output_row": (300, 1, (24,)),
    "one_output_row_5000": (5000, 1, (8,)),
    "d1": (700, 2000, ()),
    "d6": (288, 33, (6,)),
    "d3030": (144, 32, (3030,)),
    "wide": (12, 5, (17000, 4)),
    "no_rows": (0, 7, (6,)),
}


def _misaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("zero", [False, True], ids=["accumulate", "zero"])
@pytest.mark.parametrize("name", sorted(SITES) + sorted(EDGES))
def test_kernel_is_the_cpu_in_both_modes(dev, name, zero):
    shape = EDGES.get(name, name)
    out, idx, x = inputs(shape, seed=5)
    want = sequential(out, idx, x, zero)
    n = cuda_segsum.LAUNCHES["segsum"]
    got, = cuda_segsum.sums([Sum(out.to(dev), idx.to(dev), x.to(dev), zero)])
    assert cuda_segsum.LAUNCHES["segsum"] == n + 1
    assert torch.equal(got.cpu(), want)
    # misaligned x and out take the scalar loads
    o2, x2 = _misaligned(out.to(dev)), _misaligned(x.to(dev))
    got, = cuda_segsum.sums([Sum(o2, idx.to(dev), x2, zero)])
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("names", [
    ("graph_agg", "graph_agg_counts"),
    ("dba_hessian", "dba_gradient", "dba_depth", "dba_ei", "dba_pairs"),
    ("rows_5000", "one_output_row", "d1", "d6", "d3030", "wide",
     "no_rows", "dba_rhs"),
])
def test_batched_kernel_is_the_cpu(dev, names):
    cases = [inputs(EDGES.get(n, n), seed=k) for k, n in enumerate(names)]
    jobs = [Sum(o, i, x, k % 2 == 0) for k, (o, i, x) in enumerate(cases)]
    want = [sequential(o, i, x, z) for o, i, x, z in jobs]
    n = cuda_segsum.LAUNCHES["segsum"]
    got = cuda_segsum.sums([Sum(o.to(dev), i.to(dev), x.to(dev), z)
                            for o, i, x, z in jobs])
    assert cuda_segsum.LAUNCHES["segsum"] == n + 1
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_probe_cases_and_groups(dev):
    """The planner-width cases in both modes and the tracker's groups,
    bit-equal to the CPU (segsum_probe.measure)."""
    from pvo_tpu_torch.scripts import segsum_probe
    for name in segsum_probe.CASES:
        for zero in (False, True):
            r = segsum_probe.measure((name,), zero, reps=2)
            assert r["bit_equal_cpu"], (name, zero)
    for names in segsum_probe.GROUPS.values():
        assert segsum_probe.measure(names, True, reps=2)["bit_equal_cpu"]


# ------------------------------------------------- the earlier DBA, kept

def _old_seg(x, idx, ok, n):
    idx = torch.where(ok, idx, torch.full_like(idx, n))
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=torch.float32)
    return index_add_plain(out, idx, x)


def nine_call_dba(poses, disps, intrinsics, target, weight, eta, ii, jj, valid,
        pairs_a, pairs_b, pairs_valid, t0, t1, w0, P, K, iters=2,
        motion_only=False, ep=0.1, lm=1e-4):
    """``vo/dba.py``'s ``dba`` with its nine sums a full iteration."""
    dev = poses.device
    F = poses.shape[0]
    h, w = disps.shape[-2:]
    HW = h * w
    D = 6
    as_long = (lambda a: torch.as_tensor(a, device=dev).long())
    ii, jj = as_long(ii), as_long(jj)
    valid = torch.as_tensor(valid, device=dev).bool()
    pairs_a, pairs_b = as_long(pairs_a), as_long(pairs_b)
    pairs_valid = torch.as_tensor(pairs_valid, device=dev).bool()
    vmask = valid.float()
    intr_b = intrinsics.expand(1, F, 4)
    eta_flat = eta.reshape(K, HW)

    pi, pj, m = ii - t0, jj - t0, ii - w0
    ok_i = valid & (pi >= 0) & (pi < P)
    ok_j = valid & (pj >= 0) & (pj < P)
    ok_m = valid & (m >= 0) & (m < K)
    m_c = m.clamp(0, K - 1)
    pm = torch.arange(K, device=dev) + w0 - t0
    ok_pm = (pm >= 0) & (pm < P)

    def sidx(rows, cols, ok):
        return torch.where(ok, rows * P + cols, torch.full_like(rows, P * P))

    def one_iteration(poses, disps):
        Hblk, vblk, Ei, Ej, Ck, wk = _edge_blocks(
            target[None], weight[None], poses[None], disps[None],
            intr_b, ii, jj)
        Hblk = Hblk[0] * vmask[:, None, None]
        vblk = vblk[0] * vmask[:, None]
        Ei = Ei[0] * vmask[:, None, None]
        Ej = Ej[0] * vmask[:, None, None]
        Ck = Ck[0] * vmask[:, None]
        wk = wk[0] * vmask[:, None]

        # pose-pose Hessian (P,P,6,6): one scatter of the 4E blocks
        hidx = torch.cat([sidx(pi, pi, ok_i), sidx(pi, pj, ok_i & ok_j),
                          sidx(pj, pi, ok_i & ok_j), sidx(pj, pj, ok_j)])
        Hs = Hblk.new_zeros((P * P + 1, D, D))
        index_add_plain(Hs, hidx, torch.cat([
            Hblk[:, :6, :6], Hblk[:, :6, 6:], Hblk[:, 6:, :6],
            Hblk[:, 6:, 6:]]))
        H = Hs[:P * P]
        vidx = torch.cat([torch.where(ok_i, pi, torch.full_like(pi, P)),
                          torch.where(ok_j, pj, torch.full_like(pj, P))])
        v = vblk.new_zeros((P + 1, D))
        index_add_plain(v, vidx, torch.cat([vblk[:, :6],
                                                  vblk[:, 6:]]))
        v = v[:P]

        if motion_only:
            S, rhs = H, v
        else:
            C = _old_seg(Ck, m, ok_m, K) + eta_flat           # (K, HW)
            w_m = _old_seg(wk, m, ok_m, K)                     # (K, HW)
            Q = 1.0 / C
            Ei_m = _old_seg(Ei, m, ok_m & ok_i, K)             # (K, 6, HW)

            # (a) self x self per depth frame, (b) self x edge
            Ei_e = Ei_m[m_c]
            Q_e = Q[m_c]
            SS = torch.einsum("xdh,xh,xeh->xde",
                              torch.cat([Ei_m, Ei_e]), torch.cat([Q, Q_e]),
                              torch.cat([Ei_m, Ej]))
            SSa, SSb = SS[:K], SS[K:]
            ok_bm = ok_i & ok_j & ok_m
            S_sum = SS.new_zeros((P * P + 1, D, D))
            index_add_plain(S_sum, torch.cat([
                sidx(pm, pm, ok_pm), sidx(pi, pj, ok_bm),
                sidx(pj, pi, ok_bm)]),
                torch.cat([SSa, SSb, SSb.transpose(-1, -2)]))

            # (c) edge x edge over same-source pairs, in chunks: the
            # gathered (pairs, 6, HW) operands grow with the square of
            # the edges per frame at backend scale
            for o in range(0, pairs_a.shape[0], PAIR_CHUNK):
                pa_c = pairs_a[o:o + PAIR_CHUNK]
                pb_c = pairs_b[o:o + PAIR_CHUNK]
                SSc = torch.einsum("pdh,ph,peh->pde", Ej[pa_c], Q_e[pa_c],
                                   Ej[pb_c])
                pj_a, pj_b = pj[pa_c], pj[pb_c]
                ok_c = (pairs_valid[o:o + PAIR_CHUNK] & (pj_a >= 0) &
                        (pj_a < P) & (pj_b >= 0) & (pj_b < P))
                index_add_plain(S_sum, sidx(pj_a, pj_b, ok_c), SSc)

            S = H - S_sum[:P * P]

            # rhs correction: v - E Q w (self + edge terms)
            rc = torch.einsum("xdh,xh,xh->xd", torch.cat([Ei_m, Ej]),
                              torch.cat([Q, Q_e]),
                              torch.cat([w_m, w_m[m_c]]))
            ridx = torch.cat([
                torch.where(ok_pm, pm, torch.full_like(pm, P)),
                torch.where(ok_j & ok_m, pj, torch.full_like(pj, P))])
            corr_v = rc.new_zeros((P + 1, D))
            index_add_plain(corr_v, ridx, rc)
            rhs = v - corr_v[:P]

        # damped dense solve
        Sd = S.reshape(P, P, D, D).permute(0, 2, 1, 3).reshape(P * D, P * D)
        Sd = Sd + torch.diag(ep + lm * torch.diagonal(Sd))
        dx = solve_psd(Sd[None], rhs.reshape(1, P * D, 1)).reshape(P, D)

        # pose retraction over [t0, t1)
        rows = torch.arange(P, device=dev) + t0
        rows = torch.where(rows < t1, rows, torch.full_like(rows, F))
        dx_full = dx.new_zeros((F + 1, D))
        dx_full[rows] = dx
        new_poses = se3.retr(poses, dx_full[:F])
        if motion_only:
            return new_poses, disps

        # depth back-substitution
        dx_pm = torch.where(ok_pm[:, None], dx[pm.clamp(0, P - 1)], 0.0)
        t_self = torch.einsum("kdh,kd->kh", Ei_m, dx_pm)
        dx_pj = torch.where(ok_j[:, None], dx[pj.clamp(0, P - 1)], 0.0)
        t_edge = _old_seg(torch.einsum("edh,ed->eh", Ej, dx_pj), m, ok_m, K)
        dz = Q * (w_m - t_self - t_edge)
        krows = torch.arange(K, device=dev) + w0
        dz = torch.where((krows < t1)[:, None], dz, 0.0)
        krows = torch.where(krows < t1, krows, torch.full_like(krows, F))
        dz_full = dz.new_zeros((F + 1, HW))
        dz_full[krows] = dz.to(disps.dtype)
        new_disps = disps + dz_full[:F].reshape(F, h, w)
        return new_poses, torch.clamp(new_disps, min=0.001)

    for _ in range(iters):
        poses, disps = one_iteration(poses, disps)
    return poses, disps
