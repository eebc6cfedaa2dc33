"""Kernel timing on one NVIDIA GPU.

    from pvo_tpu_torch.scripts.kbench import device_time_ms
    ms = device_time_ms(lambda: kernel(x))

``device_time_ms`` records CUDA events around ``reps`` calls after one
warm-up call and returns the mean device time per call, as
``scripts/kbench.py`` times kernels for the JAX package on the TPU; with
``queued=True`` the calls wait behind a busy card and run back to back,
which takes the host's enqueue rate out of a short kernel's time.
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

import numpy as np
import torch

# published peaks of the H100 SXM (NVIDIA's data sheet, dense rates)
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"bf16": 989e12, "f32": 67e12}
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
