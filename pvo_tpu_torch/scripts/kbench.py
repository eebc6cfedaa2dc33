"""Kernel timing on one NVIDIA GPU.

    from pvo_tpu_torch.scripts.kbench import device_time_ms
    ms = device_time_ms(lambda: kernel(x))

``device_time_ms`` records CUDA events around ``reps`` calls after one
warm-up call and returns the mean device time per call, as
``scripts/kbench.py`` times kernels for the JAX package on the TPU; with
``queued=True`` the calls wait behind a busy card and run back to back,
which takes the host's enqueue rate out of a short kernel's time. The
events are for times; a ``torch.profiler`` trace is for breakdowns:
``trace_totals`` runs a function under one and ``device_op_totals``
sums its kernel rows by name, ``print_top`` prints the costliest, as the
JAX script's ``device_time_ms(fn, top=)`` does from its trace.
``peak_flops`` is the card's bf16 dense peak, the denominator of MFU.
``gpu_line`` is the card's name and power limit, to stand beside every
time kept. ``kernel_bound`` is the least time the card could take for a
kernel's work at a shape, from the bytes it must move and the operations
it does: the one place that counts them, for ``chip_smoke.py``, the
table in ``PERF.md`` and the tests. For the two extractions it also
gives, on given coordinates, a second figure that counts the volume's
32-byte sectors their taps lie in (``touched_sectors``), not the taps'
bytes.

    python -m pvo_tpu_torch.scripts.kbench

prints the bounds at the main path's shapes and, on a card, the
fingerprints of K2's and P2's outputs on :func:`saved_extract_case`.
"""

from __future__ import annotations

import hashlib
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pvo_tpu_torch.utils.device import open_device

# published peaks of the H100 SXM (NVIDIA's data sheet, dense rates)
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"bf16": 989e12, "f32": 67e12}
# the cards whose peaks PEAK_FLOP_S holds, by the name nvidia-smi gives
CARD_PEAK_FLOP_S = {"NVIDIA H100 80GB HBM3": PEAK_FLOP_S}
# the profiler ranges of the port (``vo.*``, ``vps.*``), whose annotation
# rows on the device are not kernels
RANGE_PREFIXES = ("vo.", "vps.")
PATCH_TAPS = 64   # the 8x8 integer patch under a 7x7 bilinear window
WINDOW_TAPS = 49

# sha256 of corr_extract's f32 output bytes on saved_extract_case(), as
# the one-warp-per-pixel kernel this one replaced gave it on an NVIDIA
# H100 80GB HBM3: the redesign may not change one bit of the blend
SAVED_EXTRACT_SHA256 = (
    "fe4cad5740376226523fc9c1342274884e07aaa28baac3fee9d486d5c6168d83")
# sha256 of corr_extract_packed's output bytes (full, f32 weights) on
# the same case, as the 2-byte-load kernel this one replaced gave it on
# the same card
SAVED_EXTRACT_PACKED_SHA256 = (
    "cfadb2d9100eed20b63a5b62ce9bcabb36c77f2f13e7ad0a3ee959d4db9a7b10")
SECTOR = 32       # bytes the memory moves at the least
# what graph_time_ms writes before each call to clear the card's L2 (the
# H100's is 50 MB) of the call's inputs
L2_FLUSH_BYTES = 256 << 20


def require_cuda():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")


def gpu_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# cycles the card is kept busy ahead of a queued timing (about 10 ms)
QUEUE_CYCLES = 20_000_000


def device_time_ms(fn, reps=10, queued=False):
    """Mean device time of ``fn()`` in ms over ``reps`` calls (CUDA
    events), after one warm-up call. The events see the host as well
    where it enqueues slower than the card runs (a wrapper's checks and
    its launch take some 40 us: the floor of a short kernel's time).
    ``queued`` keeps the card busy while the calls are enqueued, so they
    run back to back and the time is the card's alone; ``reps`` calls
    must be enqueued within the 10 ms."""
    require_cuda()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps=20, replays=5, flush=False):
    """Mean device time of ``fn()`` in ms: ``reps`` calls captured in one
    CUDA graph (after one warm-up call outside it), the graph replayed
    once, then ``replays`` times between CUDA events. The card runs the
    calls back to back, so a kernel shorter than its wrapper's host cost
    is timed as a kernel, not as an enqueue. Back to back, a call whose
    inputs and outputs fit the L2 finds them there; with ``flush`` each
    call follows a write of ``L2_FLUSH_BYTES`` in the graph, and the mean
    time of those writes alone (a graph of their own, timed the same
    way) is taken off: the call with its data in the card's memory, as a
    bound from the memory's rate assumes."""
    require_cuda()
    buf = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
           if flush else None)

    def timed(body):
        body()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                body()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        del graph
        return start.elapsed_time(end) / (replays * reps)

    if not flush:
        return timed(fn)

    def flushed():
        buf.zero_()
        return fn()
    return timed(flushed) - timed(buf.zero_)


def peak_flops(card=None):
    """The bf16 dense peak in FLOP/s of the card named ``card`` (as
    :func:`gpu_line` gives it; the attached card's when None), the
    denominator of MFU. A card whose peak this module does not hold
    raises: no figure of another card stands in for it."""
    if card is None:
        card = gpu_line().split(",")[0].strip()
    if card not in CARD_PEAK_FLOP_S:
        raise KeyError(f"no published peak for {card!r}; known: "
                       f"{sorted(CARD_PEAK_FLOP_S)}")
    return CARD_PEAK_FLOP_S[card]["bf16"]


def averages(prof):
    """``prof.key_averages()`` of a finished ``torch.profiler`` run,
    computed at the first call and kept on ``prof``: each call of
    ``key_averages`` walks every event again, and several helpers read
    one run's rows."""
    rows = getattr(prof, "_pvo_key_averages", None)
    if rows is None:
        rows = prof._pvo_key_averages = prof.key_averages()
    return rows


def device_op_totals(prof):
    """{kernel name: (total us, launches)} over the kernel rows of a
    finished ``torch.profiler`` run (its CUDA rows, the ranges'
    annotation rows left out; the ctypes-launched kernels and those a
    CUDA graph replays included)."""
    out = {}
    for r in averages(prof):
        if r.device_type != torch.autograd.DeviceType.CUDA or \
                r.key.startswith(RANGE_PREFIXES):
            continue
        us, n = out.get(r.key, (0.0, 0))
        out[r.key] = (us + r.self_device_time_total, n + r.count)
    return out


def print_top(totals, n):
    """Print the ``n`` costliest rows of :func:`device_op_totals`, as the
    JAX script does: ms, launches, name. Returns the rows printed, as
    (name, us, launches), costliest first (ties by name)."""
    rows = sorted(((k, us, c) for k, (us, c) in totals.items()),
                  key=lambda r: (-r[1], r[0]))[:n]
    for name, us, c in rows:
        print(f"    {us / 1e3:9.3f} ms {c:5d}x  {name[:84]}")
    return rows


def profiled():
    """``torch.profiler`` over CPU and CUDA activity."""
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def trace_totals(fn, warm=True):
    """:func:`device_op_totals` of one call of ``fn()`` under
    ``torch.profiler`` on the card, ended by a synchronize (after one
    untraced warm-up call unless ``warm`` is False). Raises without a
    card."""
    open_device("cuda")
    if warm:
        fn()
        torch.cuda.synchronize()
    with profiled() as prof:
        fn()
        torch.cuda.synchronize()
    return device_op_totals(prof)


def total_ms(totals):
    """The device ms of all the rows of :func:`device_op_totals`."""
    return sum(us for us, _ in totals.values()) / 1e3


def host_ms(fn, device, reps=5):
    """Mean ms of ``reps`` calls of ``fn()`` on the host clock, ending in
    a synchronize of ``device`` when it is a card, after one warm-up call
    (the JAX scripts' ``timeit``)."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / reps


def breakdown(fn, device, top=0, reps=5):
    """``fn()`` measured as the JAX micro-benches measure it:
    {"host_ms": :func:`host_ms`, and on the card "device_ms" (the
    kernels of one traced call), "launches", "events_ms"
    (:func:`device_time_ms`) and "top" (the ``top`` costliest kernels,
    printed); on the CPU those are None}."""
    out = {"host_ms": host_ms(fn, device, reps), "device_ms": None,
           "launches": None, "events_ms": None, "top": None}
    if torch.device(device).type == "cuda":
        totals = trace_totals(fn)
        out.update(device_ms=total_ms(totals),
                   launches=sum(n for _, n in totals.values()),
                   events_ms=device_time_ms(fn, reps))
        if top:
            out["top"] = [[k, us / 1e3, n]
                          for k, us, n in print_top(totals, top)]
    return out


def launch_counts():
    """The hand-written kernels' launches counted in this process (their
    wrappers' counters), by the rows of ``chip_smoke.py``'s kernels line:
    K1 and K3 split by feature type (``build_volumes_f32``,
    ``corr_lookup_f32``), K2, P1, P2, the segment sum and the DBA's
    kernels."""
    from pvo_tpu_torch.vo.net import (cuda_corr, cuda_corr_exp, cuda_dba,
                                      cuda_segsum)
    out = dict(cuda_corr.LAUNCHES)
    for k in cuda_corr.F32_KERNELS:
        out[f"{k}_f32"] = cuda_corr.F32_LAUNCHES[k]
        out[k] -= cuda_corr.F32_LAUNCHES[k]
    out.update(cuda_corr_exp.LAUNCHES)
    out.update(cuda_segsum.LAUNCHES)
    out.update(cuda_dba.LAUNCHES)
    return out


def level_sizes(H, W, levels):
    """H_l * W_l of each pyramid level (floor-halving pools)."""
    sizes = []
    for _ in range(levels):
        sizes.append(H * W)
        H, W = H // 2, W // 2
    return sizes


def touched_sectors(coords, H, W, levels=4):
    """The 32-byte sectors of K1's volume that an extraction on
    ``coords`` (E, H, W, 2; level-0 [x, y]) touches: per pixel, the
    distinct sectors of its row of the volume (which starts on a sector)
    that hold a tap of one of its 8x8 patches inside a level, summed
    over the pixels. A patch row is 8 bf16 taps, 16 bytes at any 2-byte
    offset: one sector or two; at the small levels neighbouring patch
    rows share sectors. From numpy, in f32 as the kernels take the
    window's origin."""
    c = np.asarray(coords, dtype=np.float32).reshape(-1, 2)
    per = SECTOR // 2                 # bf16 values in a sector
    ids, off = [], 0
    with np.errstate(invalid="ignore", over="ignore"):
        for lvl in range(levels):
            hl, wl = H >> lvl, W >> lvl
            s = np.float32(1.0 / 2 ** lvl)
            bx = np.floor(c[:, 0] * s) - np.float32(3)
            by = np.floor(c[:, 1] * s) - np.float32(3)
            cols = (bx + 7 >= 0) & (bx < wl)
            c0 = np.where(cols, np.maximum(bx, 0), 0).astype(np.int64)
            c1 = np.where(cols, np.minimum(bx + 7, wl - 1), 0).astype(
                np.int64)
            for r in range(8):
                yy = by + np.float32(r)
                ok = cols & (yy >= 0) & (yy < hl)
                row = off + np.where(ok, yy, 0).astype(np.int64) * wl
                ids.append(np.where(ok, (row + c0) // per, -1))
                ids.append(np.where(ok, (row + c1) // per, -1))
            off += hl * wl
    ids = np.sort(np.stack(ids, 1), axis=1)
    fresh = np.diff(ids, axis=1, prepend=-1) != 0
    return int((fresh & (ids >= 0)).sum())


def kernel_bound(name, E, H, W, C=128, levels=4, features="bf16",
                 coords=None):
    """The roofline bound of kernel ``name`` on E edges of H x W
    features with C channels: every input read once and every output
    written once over the memory rate, against the operations over the
    peak rate of their type (bf16 tensor-core products for bf16
    features, f32 otherwise). Out-of-range taps are counted as products:
    the bounds here are set by the bytes, which do not depend on the
    coordinates.

    Returns {"bytes_in", "bytes_out", "bytes", "flops", "bytes_ms",
    "ops_ms", "ms", "bound_by"}; for ``corr_extract`` and
    ``corr_extract_packed`` with ``coords`` (E, H, W, 2) also "sectors"
    (:func:`touched_sectors`) and "sector_ms", the time of the output,
    the coords and those whole sectors in place of the taps' bytes."""
    px = E * H * W
    feat = 2 if features == "bf16" else 4
    n2 = sum(level_sizes(H, W, levels))
    n2p = -(-n2 // 64) * 64
    coords_bytes = px * 2 * 4
    fmaps = 2 * px * C * feat
    lookup_flops = px * levels * PATCH_TAPS * C * 2
    # the blend: 4 products and 3 sums per window tap
    blend_flops = px * levels * WINDOW_TAPS * 7
    taps = px * levels * PATCH_TAPS * 2   # bf16 volume entries read
    packed = px * levels * PATCH_TAPS * 2  # (E, H, W, 256) bf16
    if name == "build_volumes":
        b_in, b_out = fmaps, px * n2p * 2
        flops, kind = E * H * W * n2 * C * 2, features
    elif name == "corr_extract":
        b_in, b_out = taps + coords_bytes, px * levels * WINDOW_TAPS * 4
        flops, kind = blend_flops, "f32"
    elif name == "corr_lookup":
        b_in, b_out = fmaps + coords_bytes, px * levels * WINDOW_TAPS * 4
        flops, kind = lookup_flops, features
    elif name == "corr_lookup_packed":
        b_in, b_out = fmaps + coords_bytes, packed
        flops, kind = lookup_flops, features
    elif name == "corr_extract_packed":
        b_in, b_out = taps + coords_bytes, packed
        flops, kind = blend_flops, "f32"
    else:
        raise ValueError(f"no kernel named {name!r}")
    bytes_ms = 1e3 * (b_in + b_out) / HBM_BYTES_S
    ops_ms = 1e3 * flops / PEAK_FLOP_S[kind]
    res = {"bytes_in": b_in, "bytes_out": b_out, "bytes": b_in + b_out,
           "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
           "ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    if coords is not None and name in ("corr_extract",
                                       "corr_extract_packed"):
        res["sectors"] = touched_sectors(coords, H, W, levels)
        res["sector_ms"] = 1e3 * (res["sectors"] * SECTOR + coords_bytes +
                                  b_out) / HBM_BYTES_S
    return res


def segsum_bound(n_in_range, n_rows, n_out, D, zero=False):
    """The roofline bound of the segment sum (``csrc/segsum.cu``) adding
    ``n_in_range`` of ``n_rows`` f32 rows of D values into ``n_out``
    rows: the rows it adds, the int64 index and (unless it starts from
    zero, ``zero``) the output read once, the output written once,
    against one f32 add a value. Rows out of range are not read."""
    b_in = n_in_range * D * 4 + n_rows * 8 + (0 if zero else n_out * D * 4)
    return _f32_bound(b_in + n_out * D * 4, n_in_range * D)


def segsum_jobs_bound(jobs):
    """:func:`segsum_bound` of a batch of ``cuda_segsum`` jobs (out, idx,
    x, zero) in one launch: their bytes and adds summed."""
    b = f = 0
    for out, idx, x, zero in jobs:
        n = out.shape[0]
        ok = int(((idx >= 0) & (idx < n)).sum())
        one = segsum_bound(ok, idx.shape[0], n,
                           out[0].numel() if n else 0, zero)
        b, f = b + one["bytes"], f + one["flops"]
    return _f32_bound(b, f)


def dba_bound(name, E=0, K=0, HW=0, F=0, NP=0, valid_pairs=None,
              valid_edges=None, motion_only=False, P=0):
    """The roofline bound of one launch of the DBA's kernels
    (``csrc/dba.cu``) at E edges, K depth frames, HW pixels a frame, F
    frames of poses and disparities, NP pair slots and P pose rows of dx:
    every input read once and every output written once, f32 (indices
    int64, masks one byte), against the f32 peak.

    ``dba_linearize`` reads target, weight and disps[ii] of the
    ``valid_edges`` valid edges (all by default; an invalid one reads
    nothing) and writes Hblk, vblk and, unless ``motion_only``, Ei, Ej,
    Ck, wk; ``dba_schur`` reads Ei_m, Ej, C, eta, w_m and the pair slots
    and writes K + 2E + NP rows of 36 and K + E of 6; ``dba_backsub``
    reads dx, F poses and their rows and writes F poses, and, unless
    ``motion_only``, reads Ej of the ``valid_edges`` edges it sums (all by
    default), Ei_m, C, eta, w_m, F frames of disparities and the index
    lists, and writes F frames. The operations are the products
    ``FlopCounterMode`` counts in the plain versions (the einsums, and
    the retraction's 3x3 products, 72 a frame; ``trace_track.KernelFlops``
    counts these): for the Schur terms over ``valid_pairs`` of the NP
    slots (all by default, as the plain version computes them; an
    invalid slot reads nothing). ``dba_solve`` (M = 6P) reads the lower
    triangles of H and, unless ``motion_only``, S_sum (M (M + 1) / 2
    values each: a Cholesky factorization reads no more), v and corr_v,
    and writes dx; its operations are the factorization's M^3/3, the two
    triangular solves' 2 M^2 and the damping's M, which
    ``FlopCounterMode`` does not count in the plain version (cuSOLVER's
    potrf and trsv)."""
    f = 4
    if name == "dba_linearize":
        ve = E if valid_edges is None else valid_edges
        b_in = ve * (5 * HW + 14) * f + E * 17
        b_out = E * 156 * f + (0 if motion_only else E * 14 * HW * f)
        flops = E * (816 * HW + 54)
    elif name == "dba_schur":
        vp = NP if valid_pairs is None else valid_pairs
        b_in = ((K + E) * 6 + 3 * K) * HW * f + E * 8 + NP * 17
        b_out = ((K + 2 * E + NP) * 36 + (K + E) * 6) * f
        flops = (72 * (K + E + vp) + 12 * (K + E)) * HW
    elif name == "dba_backsub":
        b_in, b_out, flops = P * 6 * f + F * (7 * f + 8), F * 7 * f, 72 * F
        if not motion_only:
            ve = E if valid_edges is None else valid_edges
            b_in += (ve * 6 * HW + K * 9 * HW + F * HW) * f + \
                (2 * E + K + F) * 8
            b_out += F * HW * f
            flops += 12 * (E + K) * HW
    elif name == "dba_solve":
        M, terms = 6 * P, 1 if motion_only else 2
        b_in = terms * (M * (M + 1) // 2 + M) * f
        b_out = M * f
        flops = M ** 3 // 3 + 2 * M * M + M
    else:
        raise ValueError(f"no DBA kernel named {name!r}")
    return _f32_bound(b_in + b_out, flops)


def _f32_bound(nbytes, flops):
    bytes_ms = 1e3 * nbytes / HBM_BYTES_S
    ops_ms = 1e3 * flops / PEAK_FLOP_S["f32"]
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def saved_extract_case(E=2, H=30, W=101, seed=1234):
    """K2's fingerprint inputs, from numpy alone: a bf16 volume of
    K1's layout (pad columns 0) and finite coords with windows over
    every border, as CPU tensors."""
    rng = np.random.RandomState(seed)
    n2 = sum(level_sizes(H, W, 4))
    n2p = -(-n2 // 64) * 64
    vol = np.zeros((E, H * W, n2p), np.float32)
    vol[..., :n2] = rng.standard_normal((E, H * W, n2))
    cx = rng.uniform(-6.0, W + 5.0, (E, H, W))
    cy = rng.uniform(-6.0, H + 5.0, (E, H, W))
    coords = np.stack([cx, cy], -1).astype(np.float32)
    return (torch.from_numpy(vol).to(torch.bfloat16),
            torch.from_numpy(coords))


LOOKUP_COORDS = ("smooth", "scattered", "mixed", "wild", "band_x", "band_y")


def lookup_coords(kind, E, H, W, seed=0):
    """(E, H, W, 2) f32 level-0 [x, y] lookup coordinates, from numpy:

    smooth     the pixel grid plus a small smooth flow (reprojected
               coordinates, the main path's case);
    scattered  uniform over the image and 2 pixels around it;
    mixed      smooth in the left half of the image, scattered in the
               right: neighbouring pixel tiles of K3 take different
               routes;
    wild       smooth, with 5% of the values NaN, +-inf, +-1e30 or 3e9;
    band_x, band_y  scattered, the lower half of the rows in a band
               that straddles the right (bottom) border."""
    rng = np.random.RandomState(seed)
    gy, gx = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    ph = rng.uniform(0.0, 6.0, (E, 1, 1))
    smooth = np.stack([gx + 3.0 * np.sin(gy / 7.0 + ph) + 1.5 * ph - 4.0,
                       gy + 2.0 * np.cos(gx / 11.0 + ph) - 0.7], -1)
    scattered = np.stack([rng.uniform(-2.0, W + 1.0, (E, H, W)),
                          rng.uniform(-2.0, H + 1.0, (E, H, W))], -1)
    if kind == "smooth":
        c = smooth
    elif kind == "scattered":
        c = scattered
    elif kind == "mixed":
        c = np.where((gx >= W // 2)[None, ..., None], scattered, smooth)
    elif kind == "wild":
        c = smooth.copy()
        bad = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 3e9])
        hit = rng.rand(E, H, W, 2) < 0.05
        c[hit] = bad[rng.randint(0, len(bad), int(hit.sum()))]
    elif kind in ("band_x", "band_y"):
        c = scattered
        axis, n = (0, W) if kind == "band_x" else (1, H)
        c[:, H // 2:, :, axis] = rng.uniform(n - 6.0, n + 4.0,
                                             (E, H - H // 2, W))
    else:
        raise ValueError(f"no coordinates named {kind!r}")
    return c.astype(np.float32)


def lookup_err(out, ref):
    """max |out - ref| over the entries that are not NaN in both; NaN if
    one is NaN where the other is not."""
    d = (out - ref).abs()
    d = d[~(out.isnan() & ref.isnan())]
    if d.isnan().any():
        return float("nan")
    return d.max().item() if d.numel() else 0.0


def fingerprint(t):
    """sha256 of a tensor's bytes."""
    return hashlib.sha256(
        t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
    ).hexdigest()


def main():
    shapes = (("build_volumes", 48), ("corr_extract", 48),
              ("corr_lookup", 1), ("corr_lookup", 256),
              ("corr_lookup_packed", 64), ("corr_extract_packed", 32))
    for name, E in shapes:
        b = kernel_bound(name, E, 30, 101)
        print(f"{name} E={E} 30x101 C=128: {b['bytes'] / 1e9:.4f} GB, "
              f"{b['flops'] / 1e9:.2f} GFLOP, bound {b['ms']:.4f} ms "
              f"({b['bound_by']})")
    for name, E in (("corr_extract", 48), ("corr_extract_packed", 32)):
        for kind in ("smooth", "scattered"):
            b = kernel_bound(name, E, 30, 101,
                             coords=lookup_coords(kind, E, 30, 101))
            print(f"{name} E={E} 30x101, {kind} coords: "
                  f"{b['sectors'] / (E * 3030):.2f} sectors a pixel, bound "
                  f"{b['sector_ms']:.4f} ms by sectors, {b['ms']:.4f} by "
                  f"bytes")
    # the DBA's kernels at the planner's full regime (E=144, K=32, 2048
    # pair slots, 30x101; the update after the solve over 40 frames)
    E, K, HW = 144, 32, 30 * 101
    for name, b in (
            ("dba_linearize", dba_bound("dba_linearize", E, K, HW)),
            ("dba_schur", dba_bound("dba_schur", E, K, HW, NP=2048)),
            ("dba_backsub", dba_bound("dba_backsub", E, K, HW, F=40,
                                      P=32)),
            ("dba_solve", dba_bound("dba_solve", P=32))):
        print(f"{name} E={E} K={K} 30x101: {b['bytes'] / 1e9:.4f} GB, "
              f"{b['flops'] / 1e9:.3f} GFLOP, bound {b['ms']:.4f} ms "
              f"({b['bound_by']})")
    if torch.cuda.is_available():
        from pvo_tpu_torch.vo.net import cuda_corr, cuda_corr_exp
        vol, coords = (t.cuda() for t in saved_extract_case())
        print(gpu_line())
        print("corr_extract saved case sha256",
              fingerprint(cuda_corr.corr_extract(vol, coords)))
        print("corr_extract_packed saved case sha256",
              fingerprint(cuda_corr_exp.corr_extract_packed(vol, coords)))


if __name__ == "__main__":
    main()
