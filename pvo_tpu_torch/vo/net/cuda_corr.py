"""The three correlation kernels of the tracking path, hand-written in
CUDA for Hopper (``pvo_tpu_torch/csrc/corr.cu``), with their plain
PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version only for tensors on the CPU; it never falls back. The library
is built with ``nvcc`` for ``sm_90a`` at first use into ``csrc/build/``
and loaded with ctypes. ``LAUNCHES`` counts kernel launches per kernel,
``F32_LAUNCHES`` those of them that were K1's and K3's f32 kernels.

K1 ``build_volumes`` replaces ``pallas_build_volumes``
  (pvo_tpu/vo/net/pallas_corr.py:381, body ``_build_kernel`` :349).
  E=48 edges at 30x101 is a (3030 x 128) x (128 x 3991) product per
  edge, 149 GFLOP, against a 1.17 GB bf16 store. Bound: the store (0.35
  ms at 3.35 TB/s; the products take 0.15 ms at the bf16 tensor-core
  peak). Design, for bf16 features: a block keeps one edge's 128 f1 rows
  in shared memory and walks 16 tiles of 128 pyramid rows, loaded by
  cp.async into a 2-stage ring so the next tile's load overlaps this
  one's products and epilogue; wgmma.m64n128k16 with bf16 operands and
  f32 accumulators, as ``_build_kernel``'s bf16 ``dot_general`` with
  f32 accumulation; the epilogue rounds to bf16 through shared memory
  and stores 16-byte row vectors. The volume's row stride is padded to
  N2p (a multiple of 64: 128 bytes, a cache line) with zero pad
  columns, as ``_build_kernel`` zeroes its pad rows, so that every row
  starts on a line and no store covers part of a sector. The bf16
  operand is a bf16 pyramid: f1 / 16 is exact in bf16 and every pooled
  level is a bf16 value (:func:`pool_pyramid`), so the products are
  those of the plain version and only the order of the f32 sums
  differs (:func:`within_one_ulp`). Besides the store, every pyramid
  tile is read from L2 once per 128-row f1 tile (24 times per edge at
  30x101, 1.2 GB at E=48), which costs about as much as the store
  (PERF.md); sharing each tile between more f1 rows is the next step.
  f32 features (the flow/depth export's narrow route passes them; the
  video stores bf16 ones) are bound by operations: E=2 at 30x101 is 6.19
  GFLOP, 0.092 ms at the f32 SIMT peak, against 0.015 ms for the store.
  They take the same skeleton on the tensor cores in three TF32 passes
  (:func:`tf32_split`): each operand is split into hi = tf32(x) and lo =
  tf32(x - hi) when its tile is staged into shared memory, and the
  product is lo.hi + hi.lo + hi.hi with f32 accumulation
  (wgmma.m64n64k8). The dropped lo.lo term is 2^-22 of a product, far
  below the volume's bf16 rounding; one TF32 pass alone would flip a
  fifth of the bf16 outputs. C must be a multiple of 8, at most 128
  (both parts of a 128-row f1 tile and a 64-row pyramid tile fill the
  block's shared memory).
K2 ``corr_extract`` replaces ``pallas_corr_extract`` (:461, body
  ``_extract_kernel`` :265). Bound: memory (E=48 at 30x101: 190 MB, 0.057
  ms at 3.35 TB/s): a pixel reads 4 x 8x8 bf16 taps and writes 196 f32,
  and nothing is reused, so the design is about whole memory
  transactions. One warp per pixel, a lane per (level, patch row), 8
  pixels per block. A lane's 8 taps are 16 contiguous bytes at any
  2-byte offset of the pixel's volume row: it loads the two aligned
  16-byte vectors that cover them and picks its taps out of its own
  slot of shared memory; the lower patch row comes from the next lane
  by a shuffle. The windows are staged in shared memory in the
  reference dx-major order and the block stores its 8 pixels' 8 x 784
  contiguous bytes as 16-byte vectors, a warp on consecutive addresses.
  The blend's arithmetic is that of the one-warp, 2-byte-load kernel it
  replaced, bit for bit (``kbench.SAVED_EXTRACT_SHA256``). No one-hot
  selectors, no padding, no packed layout.
K3 ``corr_lookup`` replaces ``pallas_corr_lookup`` (:565, body
  ``_kernel`` :164). Bound: memory, mostly the f32 output (a backend
  chunk of E=256 at 30x101 moves 1.01 GB, 0.30 ms, against 51 GFLOP,
  0.05 ms at the bf16 tensor-core peak), so products are cheap and
  re-reading pooled rows is not. Design for bf16 features (the video's):
  a block owns 8 x 16 neighbouring pixels of one edge, f1 rows in shared
  memory in K1's wgmma layout; per level it takes the bounding box of
  its pixels' 8x8 patches (15 x 23 positions at level 0 where the
  coordinates are smooth, as reprojected ones are), streams the box's
  pooled bf16 rows through a 2-stage cp.async ring, 64 at a time, and
  forms tile x box^T with wgmma.m64n64k16 (bf16 in, f32 accumulators, as
  ``_kernel``'s bf16 ``dot_general``): a pooled row is read once per 128
  pixels, not once per tap, at about 6 times the products the taps
  need. The f32 products pass through shared memory, where two threads
  per pixel pick their taps, blend, and stage the level's windows for
  coalesced stores. A level whose box exceeds 1536 positions (scattered
  or non-finite coordinates) takes per-pixel dot products against the
  bf16 pyramid inside the same kernel; :func:`routes` counts the (block,
  level) pairs on each route. f32 features (the export's step at wide
  sizes, the motion filter's probe), or bf16 ones whose C is no multiple
  of 16, take the same design on an f32 pyramid with the three TF32
  passes of K1: bound by operations (E=2 at 47x156: 0.96 GFLOP of tap
  products, 0.014 ms at the f32 SIMT peak), and so small a launch that
  blocks in flight matter most: a block is 8 x 8 pixels at one level
  (the level is on the grid: 960 blocks at E=2, 47x156, 208 for the
  probe, two to an SM), the box's rows stream 32 at a time through
  registers, where they are split, into wgmma.m64n32k8; boxes above 768
  positions take per-pixel f32 dot products. The products differ from
  the plain version's by a few 1e-7 (:func:`tf32_split`), inside the
  1e-4 the f32 path is held to; a single TF32 pass (3.5e-4) is not. C
  must be a multiple of 8, at most 128. Edges index frames here too, so
  nothing is gathered for
  them. The pyramid is pooled by the caller's
  entry: :func:`corr_lookup` pools the edges' f2, and
  :func:`corr_lookup_indexed` takes the frames' features and their
  pyramid (:func:`lookup_pyramid`, pooled once per update call) with
  the edges' frame indices, so nothing is gathered or pooled per step.

K1 and K3 take a pooled f2 pyramid (:func:`pool_pyramid`): each level's 2x2 mean is taken in f32 and
rounded to the feature dtype, and the next level is pooled from the
rounded one, as ``pallas_corr.build_padded_pyramid`` pools bf16 maps.

K1's cached volume is for narrow streams only, as on the JAX package's
accelerator path (:func:`volume_cache_ok`); wider ones take K3 on every
update step.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from . import corr as corr_ops

RADIUS = 3
TAPS = (2 * RADIUS + 1) ** 2
SCALE = 1.0 / 16.0
# volume row stride alignment, in bf16 values: 128 bytes, so that every
# row starts on a cache line (K1 stores 16-byte vectors: at least 8)
VOL_ALIGN = 64
# widest level side of the cached volume: pallas_corr.corr_level_shapes
# gives a level one x (y) tile iff W_l (H_l) <= LANE - PATCH = 128 - 8
CACHE_MAX_SIDE = 120
# magnitude below which K1's check against its plain version takes one
# bf16 ulp at this value (:func:`within_one_ulp`)
ULP_FLOOR = 2.0 ** -6

KERNELS = ("build_volumes", "corr_extract", "corr_lookup")
LAUNCHES = dict.fromkeys(KERNELS, 0)
# of LAUNCHES, those of the f32 kernels of K1 and K3 (f32 pyramid)
F32_KERNELS = ("build_volumes", "corr_lookup")
F32_LAUNCHES = dict.fromkeys(F32_KERNELS, 0)

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "corr.cu"
BUILD_DIR = SOURCE.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def reset_launches():
    for k in KERNELS:
        LAUNCHES[k] = 0
    for k in F32_KERNELS:
        F32_LAUNCHES[k] = 0


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(source=SOURCE):
    """Compile the CUDA source ``source`` (default ``corr.cu``) into
    ``csrc/build/`` unless a library built from the same source, the
    headers beside it and the same flags is already there; returns its
    path."""
    source = Path(source)
    text = b"".join(f.read_bytes() for f in
                    [source, *sorted(source.parent.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    path = BUILD_DIR / f"libpvo_{source.stem}-{digest}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)
    return path


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ip = ctypes.POINTER(ctypes.c_int)
        lib.pvo_build_volumes.argtypes = [p, p, p, i, i, i, i, i, i, f, p]
        lib.pvo_corr_extract.argtypes = [p, p, p, i, i, i, ip, p]
        lib.pvo_corr_lookup.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                        i, f, i, ip, p]
        for fn in (lib.pvo_build_volumes, lib.pvo_corr_extract,
                   lib.pvo_corr_lookup):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_rc(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def level_shapes(H, W, num_levels=4):
    """(H_l, W_l) of each pyramid level (floor-halving pools)."""
    shapes = []
    for _ in range(num_levels):
        shapes.append((H, W))
        H, W = H // 2, W // 2
    return shapes


def level_array(shapes):
    if not 1 <= len(shapes) <= 4:
        raise ValueError(f"the kernels take 1 to 4 levels, not "
                         f"{len(shapes)}")
    flat = [v for hw in shapes for v in hw]
    return (ctypes.c_int * len(flat))(*flat)


def volume_cache_ok(h, w, num_levels=4):
    """Whether the update builds K1's volume once per call (True) or
    takes K3 on every step: every level at most CACHE_MAX_SIDE on both
    sides, the ``n_t == 1 and m_t == 1`` test of the JAX accelerator
    path (pvo_tpu/vo/factor_graph.py, ``corr_level_shapes``)."""
    return all(hl <= CACHE_MAX_SIDE and wl <= CACHE_MAX_SIDE
               for hl, wl in level_shapes(h, w, num_levels))


def padded_n2(n2):
    """K1's volume row stride for ``n2`` pyramid columns."""
    return -(-n2 // VOL_ALIGN) * VOL_ALIGN


def pool_pyramid(f2, num_levels=4, dtype=torch.float32):
    """(E, H, W, C) -> the levels of :func:`corr.pool_features`, stacked
    (E, sum H_l W_l, C) in ``dtype`` (bf16 features give bf16 values, so
    a bf16 pyramid holds them exactly)."""
    E, C = f2.shape[0], f2.shape[-1]
    return torch.cat([f.reshape(E, -1, C) for f in
                      corr_ops.pool_features(f2, num_levels, dtype)], dim=1)


def check_tensor(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


FEATS = (torch.float32, torch.bfloat16)
# widest f32 features of the three-pass TF32 kernels (K1 and K3)
F32_MAX_C = 128


def check_f32_width(C):
    if C % 8 or C > F32_MAX_C:
        raise ValueError(f"the f32 kernels need C a multiple of 8 and at "
                         f"most {F32_MAX_C}, not {C}")


# ------------------------------------------------- f32 operands, 3 x TF32

def tf32_round(x):
    """f32 ``x`` rounded to TF32 (10 mantissa bits; nearest, ties away
    from zero) as ``cvt.rna.tf32.f32`` rounds: half a TF32 ulp added to
    the magnitude's bits, the 13 low bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi): the two parts in
    which the f32 kernels hand an operand to the tensor cores. x - hi is
    exact in f32; |x - hi - lo| <= 2^-23 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_matmul_plain(a, b, passes=3):
    """a @ b^T (a: (..., M, C), b: (..., N, C), f32) as the f32 kernels
    form it: lo.hi + hi.lo + hi.hi over :func:`tf32_split` operands with
    ``passes=3`` (the lo.lo term, 2^-22 of a product, is dropped), hi.hi
    alone with ``passes=1``. Each pass is an f32 product here; the
    tensor cores differ only in the order of the sums."""
    if passes not in (1, 3):
        raise ValueError(f"passes={passes!r}: 1 or 3")
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    bh, bl = bh.transpose(-1, -2), bl.transpose(-1, -2)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


# ---------------------------------------------------------------- K1

def build_volumes_plain(f1, f2, num_levels=4):
    E, H, W, C = f1.shape
    pyr = pool_pyramid(f2, num_levels)
    pad = padded_n2(pyr.shape[1]) - pyr.shape[1]
    vol = torch.bmm(f1.reshape(E, H * W, C).float() * SCALE,
                    F.pad(pyr, (0, 0, 0, pad)).transpose(1, 2))
    return vol.to(torch.bfloat16)


def build_volumes(f1, f2, num_levels=4):
    """All-pairs correlation volumes of edges (f1[e], f2[e]).

    f1, f2: (E, H, W, C), both f32 or both bf16. Returns (E, H*W, N2p)
    bf16: level l (f2 pooled l times) at column offset
    sum_{k<l} H_k W_k, values f1 . f2_l / 16 accumulated in f32, and
    columns from N2 = sum_l H_l W_l to N2p = :func:`padded_n2` (N2) zero.
    bf16 features need C a multiple of 16 and at most 256, f32 ones
    (three TF32 passes) a multiple of 8 and at most 128."""
    if f1.device.type == "cpu":
        return build_volumes_plain(f1, f2, num_levels)
    check_tensor("f2", f2, f1.shape, (f1.dtype,), f1.device)
    with torch.cuda.device(f1.device):
        pyr = pool_pyramid(f2, num_levels, f1.dtype)
    return build_volumes_pooled(f1, pyr, num_levels)


def build_volumes_pooled(f1, pyr, num_levels=4):
    """K1 on an already pooled pyramid ``pyr`` = :func:`pool_pyramid`
    (f2, num_levels, f1.dtype): :func:`build_volumes` without its
    pooling."""
    E, H, W, C = f1.shape
    shapes = level_shapes(H, W, num_levels)
    level_array(shapes)
    N2 = sum(h * w for h, w in shapes)
    check_tensor("f1", f1, (E, H, W, C), FEATS, f1.device)
    check_tensor("pyr", pyr, (E, N2, C), (f1.dtype,), f1.device)
    bf16 = f1.dtype == torch.bfloat16
    if bf16 and (C % 16 or C > 256):
        raise ValueError(f"bf16 features need C a multiple of 16 and at "
                         f"most 256, not {C}")
    if not bf16:
        check_f32_width(C)
    N2p = padded_n2(N2)
    vol = torch.empty((E, H * W, N2p), dtype=torch.bfloat16,
                      device=f1.device)
    with torch.cuda.device(f1.device):
        rc = _library().pvo_build_volumes(
            f1.data_ptr(), pyr.data_ptr(), vol.data_ptr(), int(bf16), E,
            H * W, N2, N2p, C, SCALE,
            torch.cuda.current_stream().cuda_stream)
    check_rc(rc, "build_volumes")
    LAUNCHES["build_volumes"] += 1
    F32_LAUNCHES["build_volumes"] += not bf16
    return vol


def within_one_ulp(a, b):
    """Elementwise: |a - b| is at most one bf16 ulp of max(|a|, |b|,
    ULP_FLOOR). K1 and its plain version form the same products (f32
    features: up to the 2^-22 of :func:`tf32_split`) and sum them in
    another f32 order, so an entry differs by one bf16 rounding step at
    most; where the sum cancels to below ULP_FLOOR, the f32
    order difference (about C * 2^-24 * sum |f1 f2| / 16, 4e-5 for
    unit-variance features at C=128) may exceed the tiny value's own
    ulp, and one ulp at ULP_FLOOR (2^-13) bounds it."""
    a, b = a.float(), b.float()
    m = torch.maximum(torch.maximum(a.abs(), b.abs()),
                      torch.full_like(a, ULP_FLOOR))
    # m in [2^(e-1), 2^e) has a bf16 ulp (8 significant bits) of 2^(e-8)
    return (a - b).abs() <= torch.ldexp(torch.ones_like(m),
                                        torch.frexp(m).exponent - 8)


def volume_agreement(vol, ref, n2, chunk=8):
    """A K1 volume against its plain version ``ref`` (both (E, HW, N2p)
    bf16, ``n2`` real columns), ``chunk`` edges at a time (to bound the
    f32 copies: the volume at E=48 is 1.17 GB): (max |d|,
    share of entries bit-equal, whether every entry is
    :func:`within_one_ulp`, max |pad column|)."""
    err = pad = 0.0
    equal, ulp_ok = 0, True
    for e in range(0, vol.shape[0], chunk):
        a, b = vol[e:e + chunk], ref[e:e + chunk]
        err = max(err, (a.float() - b.float()).abs().max().item())
        equal += int((a == b).sum())
        ulp_ok = ulp_ok and bool(within_one_ulp(a, b).all())
        if a.shape[-1] > n2:
            pad = max(pad, a[..., n2:].float().abs().max().item())
    return err, equal / vol.numel(), ulp_ok, pad


# ---------------------------------------------------------------- K2

def corr_extract_plain(vol, coords, num_levels=4):
    E, H, W, _ = coords.shape
    c = coords.reshape(E, H * W, 2).float()
    outs, off = [], 0
    for lvl, (h, w) in enumerate(level_shapes(H, W, num_levels)):
        v = vol[:, :, off:off + h * w].float().reshape(E, H * W, h, w)
        outs.append(corr_ops._lookup_level(v, c / (2 ** lvl), RADIUS))
        off += h * w
    return torch.cat(outs, dim=-1).reshape(E, H, W, -1)


def corr_extract(vol, coords, num_levels=4):
    """Windowed lookup from :func:`build_volumes` volumes.

    vol: (E, H*W, N2p) bf16 (the plain version also reads an unpadded
    (E, H*W, N2)); coords: (E, H, W, 2) f32 level-0 [x, y]. Returns
    (E, H, W, num_levels*49) f32, dx-major taps."""
    if vol.device.type == "cpu":
        return corr_extract_plain(vol, coords, num_levels)
    E, H, W, _ = coords.shape
    shapes = level_shapes(H, W, num_levels)
    N2p = padded_n2(sum(h * w for h, w in shapes))
    check_tensor("vol", vol, (E, H * W, N2p), (torch.bfloat16,),
                 vol.device)
    check_tensor("coords", coords, (E, H, W, 2), (torch.float32,),
                 vol.device)
    out = torch.empty((E, H, W, num_levels * TAPS), dtype=torch.float32,
                      device=vol.device)
    with torch.cuda.device(vol.device):
        rc = _library().pvo_corr_extract(
            vol.data_ptr(), coords.data_ptr(), out.data_ptr(), E * H * W,
            N2p, num_levels, level_array(shapes),
            torch.cuda.current_stream().cuda_stream)
    check_rc(rc, "corr_extract")
    LAUNCHES["corr_extract"] += 1
    return out


# ---------------------------------------------------------------- K3

class RouteCounter:
    """Per card, two 64-bit counters that a lookup kernel adds to: the
    (block, level) pairs whose bounding box was within the kernel's cap
    (the tensor cores, from a table of the box's rows) and those above
    it."""

    def __init__(self):
        self._counts = {}

    def tensor(self, device):
        """The counters of ``device``, made at its first use. Not under a
        CUDA graph's capture: the zeroing would be captured with it and
        rerun at every replay (:class:`graph_capture.FrameGraph` makes
        them before it captures)."""
        if device not in self._counts:
            if torch.device(device).type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError("K3's route counters made under "
                                   "capture would reset at every replay")
            self._counts[device] = torch.zeros(2, dtype=torch.int64,
                                               device=device)
        return self._counts[device]

    def read(self):
        """(within the cap, above it), summed over the cards; reading
        them waits for the card."""
        tot = sum(c.cpu() for c in self._counts.values()) \
            if self._counts else [0, 0]
        return int(tot[0]), int(tot[1])

    def reset(self):
        for c in self._counts.values():
            c.zero_()


# K3's kernels (bf16 and f32): [tensor-core route, per-pixel route]
_routes = RouteCounter()


def routes():
    """(block, level) pairs that K3 (either feature type) has run on the
    tensor cores and on its per-pixel route since :func:`reset_routes`,
    summed over the cards; reading them waits for the card."""
    return _routes.read()


def reset_routes():
    _routes.reset()


def route_counter(device):
    """K3's route counters on ``device`` (made if they are not yet)."""
    return _routes.tensor(device)


def lookup_route_pairs(E, H, W, bf16, num_levels=4):
    """The (block, level) pairs that one K3 launch on E edges of H x W
    features adds to :func:`routes`: a block of the bf16 kernel is 8 x 16
    pixels of an edge and takes every level, one of the f32 kernel 8 x 8
    pixels at one level (``csrc/corr.cu``'s grids)."""
    return E * -(-H // 8) * -(-W // (16 if bf16 else 8)) * num_levels


def lookup_dtype(feats):
    """The pyramid dtype K3 takes for features ``feats`` (..., C): bf16
    (the bf16 kernel) for bf16 features with C a multiple of 16 up to
    256, else f32 (the three-pass TF32 kernel)."""
    C = feats.shape[-1]
    tensor = feats.dtype == torch.bfloat16 and C % 16 == 0 and C <= 256
    return torch.bfloat16 if tensor else torch.float32


def lookup_pyramid(fmaps, num_levels=4):
    """The pooled pyramid (F, sum H_l W_l, C) of frames ``fmaps``
    (F, H, W, C) that :func:`corr_lookup_indexed` takes."""
    return pool_pyramid(fmaps, num_levels, lookup_dtype(fmaps))


def corr_lookup_plain(f1, f2, coords, num_levels=4):
    return corr_ops.corr_and_lookup(f1, f2, coords, num_levels, RADIUS)


def corr_lookup_indexed_plain(fmaps, pyr, ii, jj, coords, num_levels=4):
    """:func:`corr_lookup_plain` (fmaps[ii], fmaps[jj], coords), from
    the frames' pooled pyramid ``pyr``: the same values exactly."""
    E, H, W, _ = coords.shape
    ii, jj = ii.long(), jj.long()
    f1 = fmaps[ii]
    c = coords.reshape(E, H * W, 2).float()
    outs, off = [], 0
    for lvl, (h, w) in enumerate(level_shapes(H, W, num_levels)):
        f2 = pyr[jj, off:off + h * w].reshape(E, h, w, pyr.shape[-1])
        outs.append(corr_ops._lookup_level(corr_ops.corr_volume(f1, f2),
                                           c / (2 ** lvl), RADIUS))
        off += h * w
    return torch.cat(outs, dim=-1).reshape(E, H, W, -1)


def _launch_lookup(f1, pyr, ii, jj, coords, num_levels):
    """K3 on frames ``f1`` (F, H, W, C) and their pyramid ``pyr``
    (F, N2, C); edge e reads frames ii[e] and jj[e] (int32 tensors), or
    frame e of both where they are None."""
    E = coords.shape[0]
    F_, H, W, C = f1.shape
    dev = f1.device
    shapes = level_shapes(H, W, num_levels)
    N2 = sum(h * w for h, w in shapes)
    check_tensor("f1", f1, (F_, H, W, C), FEATS, dev)
    check_tensor("pyr", pyr, (F_, N2, C), (lookup_dtype(f1),), dev)
    check_tensor("coords", coords, (E, H, W, 2), (torch.float32,), dev)
    for name, idx in (("ii", ii), ("jj", jj)):
        if idx is not None:
            check_tensor(name, idx, (E,), (torch.int32,), dev)
    if pyr.dtype == torch.bfloat16:
        kind = 2
    else:
        kind = int(f1.dtype == torch.bfloat16)
        check_f32_width(C)
    out = torch.empty((E, H, W, num_levels * TAPS), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        rc = _library().pvo_corr_lookup(
            f1.data_ptr(), pyr.data_ptr(),
            None if ii is None else ii.data_ptr(),
            None if jj is None else jj.data_ptr(), coords.data_ptr(),
            out.data_ptr(), _routes.tensor(dev).data_ptr(), kind, E, H, W,
            N2, C, SCALE, num_levels, level_array(shapes),
            torch.cuda.current_stream().cuda_stream)
    check_rc(rc, "corr_lookup")
    LAUNCHES["corr_lookup"] += 1
    F32_LAUNCHES["corr_lookup"] += kind != 2
    return out


def corr_lookup(f1, f2, coords, num_levels=4):
    """Fused correlation + windowed lookup without a stored volume.

    f1, f2: (E, H, W, C), both f32 or both bf16; coords: (E, H, W, 2)
    f32. Returns (E, H, W, num_levels*49) f32, dx-major taps."""
    if f1.device.type == "cpu":
        return corr_lookup_plain(f1, f2, coords, num_levels)
    check_tensor("f2", f2, f1.shape, (f1.dtype,), f1.device)
    return _launch_lookup(f1, lookup_pyramid(f2, num_levels), None, None,
                          coords, num_levels)


def corr_lookup_indexed(fmaps, pyr, ii, jj, coords, num_levels=4):
    """:func:`corr_lookup` (fmaps[ii], fmaps[jj], coords) without the
    gathers and without pooling: fmaps (F, H, W, C) are the frames'
    features, ``pyr`` = :func:`lookup_pyramid` (fmaps) their pyramid,
    pooled once for many calls, and ii, jj (E,) integer tensors the
    edges' frames (in range: the kernel does not check them)."""
    if fmaps.device.type == "cpu":
        return corr_lookup_indexed_plain(fmaps, pyr, ii, jj, coords,
                                         num_levels)
    return _launch_lookup(fmaps, pyr, ii.int().contiguous(),
                          jj.int().contiguous(), coords, num_levels)
