"""The packed-layout correlation kernels P1 and P2, hand-written in CUDA
for Hopper (``pvo_tpu_torch/csrc/corr_exp.cu``), with their plain
PyTorch versions: the counterparts of the JAX package's corr experiment
harnesses ``scripts/corr_exp{,2,3,4,5}.py`` (X1-X5).

The packed layout is the corr operand of the JAX package's TPU path: per
pixel and pyramid level the 8x8 integer-tap patch of the radius-3
window, bilinearly blended, in bf16, 4 levels x 64 = 256 channels. Tap
(dy, dx) of level l sits at (floor(y_l) - 3 + dy, floor(x_l) - 3 + dx);
pad taps (dy == 7 or dx == 7) are exactly 0, and so are taps out of the
level. Channels are level-major, l*64 + dy*8 + dx, or (P1 only)
dy-major, dy*32 + l*8 + dx. The blend runs rows first, as the harnesses'
one-hot products do: t = wy0*p[dy] + wy1*p[dy+1], then
out = wx0*t[dx] + wx1*t[dx+1].

Each wrapper launches its kernel for CUDA tensors and takes the plain
version only for tensors on the CPU; it never falls back. The library is
built with ``nvcc`` for ``sm_90a`` at first use (``cuda_corr.build``).
``LAUNCHES`` counts kernel launches per kernel.

P1 ``corr_lookup_packed`` replaces X1, ``scripts/corr_exp.py`` ``run``
  (:142, ``pallas_call`` :172, body ``_kernel`` :38). Correlation
  against the pooled f2 pyramid of :func:`cuda_corr.pool_pyramid` with
  no stored volume. ``seldt="bf16"`` rounds the correlation, the
  bilinear weights and the row blend to bf16 (``_kernel`` :54-61, :96,
  :106); ``"f32"`` keeps f32 throughout. X1's ``merge`` and ``blk``
  knobs are TPU selector and tiling choices and change no result.
  Bound: on-chip reads. At E=64, 30x101 each pixel takes 4 x 64
  length-128 dot products (12.7 GFLOP in all) against 512-byte pooled
  f2 rows that neighbouring pixels share through L1. Design: K3's (4
  pixels x 64 taps per block, f1 in shared memory, one dot product per
  thread), with the blend and the bf16 packed store per thread.
P2 ``corr_extract_packed`` replaces X2-X5: ``corr_exp2.py`` ``extract_v``
  (:93, :116), ``corr_exp3.py`` ``run_mode`` (:98, :118),
  ``corr_exp4.py`` ``extract_v2`` (:90, :112) and ``corr_exp5.py``
  ``extract_v3`` (:112, :125). It reads K1's volume (E, H*W, N2) as it
  is. X2's rounding variants are ``weights`` and ``round_mid``
  (:data:`X2_VARIANTS`); X3's modes are ``mode``; X4 and X5 are the
  ``full`` f32 extraction (they differ from X2 only in TPU store and
  pipelining mechanics). Bound: memory. At E=32, 30x101 it writes 50 MB
  of bf16 and reads 4 x 8 rows of 8 bf16 taps per pixel (50 MB, up to
  twice that in 32-byte sectors). Design: K2's (one warp per pixel, a
  lane per level and patch row, the lower row by shuffle), with each
  lane's 8 packed taps written as one 16-byte store.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import corr as corr_ops
from . import cuda_corr
from .cuda_corr import (FEATS, RADIUS, SCALE, check_rc, check_tensor,
                        level_array, level_shapes)

KERNELS = ("corr_lookup_packed", "corr_extract_packed")
LAUNCHES = dict.fromkeys(KERNELS, 0)

SOURCE = cuda_corr.SOURCE.parent / "corr_exp.cu"

PATCH = 2 * RADIUS + 2          # 8
PTAPS = PATCH * PATCH           # 64 packed taps per level
LANE = 128                      # lane width of X3's novab/dma modes
SHIFT = PATCH                   # pallas_corr.SHIFT

ORDERS = ("level", "dy")
SELDT = ("f32", "bf16")
# bilinear weight rounding: none, both weights rounded to bf16 (f32
# selectors cast to bf16), or f rounded first and 1 - f after (bf16
# selectors); the index is the kernel's WeightMode
WEIGHTS = ("f32", "round", "bf16")
MODES = ("full", "nostore", "novab", "dma")
# X2 (corr_exp2.py :62-81): (cast_vol, sel_dtype) -> (weights, round_mid)
X2_VARIANTS = {
    (True, "f32"): ("f32", False),
    (True, "bf16"): ("bf16", False),
    (False, "f32"): ("round", True),
    (False, "bf16"): ("bf16", True),
}

_lib = None


def reset_launches():
    for k in KERNELS:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_corr.build(SOURCE)))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ip = ctypes.POINTER(ctypes.c_int)
        lib.pvo_corr_lookup_packed.argtypes = [p, i, p, p, p, i, i, i, i, f,
                                               i, ip, i, i, p]
        lib.pvo_corr_extract_packed.argtypes = [p, p, p, i, i, i, ip, i, i,
                                                i, p]
        for fn in (lib.pvo_corr_lookup_packed, lib.pvo_corr_extract_packed):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _choice(name, value, allowed):
    if value not in allowed:
        raise ValueError(f"{name}={value!r}, expected one of {allowed}")


def _round(t):
    return t.to(torch.bfloat16).float()


def _weights(f, weights):
    """(w0, w1) = (1 - f, f), rounded as ``weights`` says."""
    if weights == "bf16":
        w1 = _round(f)
        return _round(1.0 - w1), w1
    if weights == "round":
        return _round(1.0 - f), _round(f)
    return 1.0 - f, f


def _blend_packed(patch, fx, fy, weights, round_mid):
    """(E, HW, 8, 8) integer taps [dy, dx] -> (E, HW, 8, 8) f32 packed
    window, rows first; pad taps 0."""
    wy0, wy1 = (w[..., None, None] for w in _weights(fy, weights))
    wx0, wx1 = (w[..., None, None] for w in _weights(fx, weights))
    t = wy0 * patch[..., :-1, :] + wy1 * patch[..., 1:, :]
    if round_mid:
        t = _round(t)
    return F.pad(wx0 * t[..., :-1] + wx1 * t[..., 1:], (0, 1, 0, 1))


# ---------------------------------------------------------------- P1

def corr_lookup_packed_plain(f1, f2, coords, num_levels=4, order="level",
                             seldt="f32"):
    E, H, W, C = f1.shape
    bf16 = seldt == "bf16"
    a = f1.reshape(E, H * W, C).float() * SCALE
    c = coords.reshape(E, H * W, 2).float()
    outs = []
    for lvl, f2l in enumerate(corr_ops.pool_features(f2, num_levels)):
        h, w = f2l.shape[1:3]
        vol = torch.bmm(a, f2l.reshape(E, h * w, C).transpose(1, 2))
        if bf16:
            vol = _round(vol)
        patch, fx, fy = corr_ops.gather_patch(
            vol.reshape(E, H * W, h, w), c / (2 ** lvl), RADIUS)
        outs.append(_blend_packed(patch, fx, fy,
                                  "bf16" if bf16 else "f32", bf16))
    out = torch.stack(outs, dim=2)                   # (E, HW, L, dy, dx)
    if order == "dy":
        out = out.transpose(2, 3)
    return out.reshape(E, H, W, -1).to(torch.bfloat16)


def corr_lookup_packed(f1, f2, coords, num_levels=4, order="level",
                       seldt="f32"):
    """Fused correlation + packed windowed lookup (X1).

    f1, f2: (E, H, W, C) f32 or bf16; coords: (E, H, W, 2) f32 level-0
    [x, y]. Returns (E, H, W, num_levels*64) bf16 in ``order``
    ("level": l*64 + dy*8 + dx, "dy": dy*(8L) + l*8 + dx), with f32 or
    bf16 (``seldt``) intermediates."""
    _choice("order", order, ORDERS)
    _choice("seldt", seldt, SELDT)
    if f1.device.type == "cpu":
        return corr_lookup_packed_plain(f1, f2, coords, num_levels, order,
                                        seldt)
    E, H, W, C = f1.shape
    check_tensor("f1", f1, (E, H, W, C), FEATS, f1.device)
    check_tensor("f2", f2, (E, H, W, C), FEATS, f1.device)
    check_tensor("coords", coords, (E, H, W, 2), (torch.float32,),
                 f1.device)
    shapes = level_shapes(H, W, num_levels)
    levels = level_array(shapes)
    N2 = sum(h * w for h, w in shapes)
    out = torch.empty((E, H, W, num_levels * PTAPS), dtype=torch.bfloat16,
                      device=f1.device)
    with torch.cuda.device(f1.device):
        pyr = cuda_corr.pool_pyramid(f2, num_levels)
        rc = _library().pvo_corr_lookup_packed(
            f1.data_ptr(), int(f1.dtype == torch.bfloat16), pyr.data_ptr(),
            coords.data_ptr(), out.data_ptr(), H * W, E * H * W, N2, C,
            SCALE, num_levels, levels, int(order == "dy"),
            int(seldt == "bf16"), torch.cuda.current_stream().cuda_stream)
    check_rc(rc, "corr_lookup_packed")
    LAUNCHES["corr_lookup_packed"] += 1
    return out


# ---------------------------------------------------------------- P2

def corr_extract_packed_plain(vol, coords, num_levels=4, mode="full",
                              weights="f32", round_mid=False):
    E, H, W, _ = coords.shape
    c = coords.reshape(E, H * W, 2).float()
    shapes = level_shapes(H, W, num_levels)
    offs = [sum(h * w for h, w in shapes[:lvl]) for lvl in range(len(shapes))]

    def level(lvl):
        (h, w), o = shapes[lvl], offs[lvl]
        return vol[:, :, o:o + h * w].float().reshape(E, H * W, h, w)

    if mode in ("full", "nostore"):
        outs = []
        for lvl in range(num_levels):
            patch, fx, fy = corr_ops.gather_patch(level(lvl),
                                                  c / (2 ** lvl), RADIUS)
            o = _blend_packed(patch, fx, fy, weights, round_mid)
            if mode == "nostore":
                o[..., 1:, :] = 0.0
            outs.append(o)
        return torch.stack(outs, dim=2).reshape(E, H, W, -1).to(
            torch.bfloat16)

    # novab / dma: channels 0-127 from the last level, the rest 0
    lvl = num_levels - 1
    v = level(lvl)
    n = min(v.shape[-1], LANE)
    out = torch.zeros((E, H * W, num_levels * PTAPS), device=vol.device)
    if mode == "dma":
        out[..., :n] = v.sum(dim=2)[..., :n]
    else:
        cl = c / (2 ** lvl)
        x0, y0 = torch.floor(cl[..., 0]), torch.floor(cl[..., 1])
        wx0, wx1 = _weights(cl[..., 0] - x0, weights)
        wy0, wy1 = _weights(cl[..., 1] - y0, weights)
        px, py = x0 - RADIUS + SHIFT, y0 - RADIUS + SHIFT
        # dx = 0 selector row: lane j reads two-hot lane (j + 8) mod 128
        i = ((torch.arange(LANE, device=vol.device) + SHIFT) % LANE).float()
        bx = (torch.where(i == px[..., None], wx0[..., None], 0.0) +
              torch.where(i == px[..., None] + 1, wx1[..., None], 0.0))
        ay = (torch.where(py == SHIFT, wy0, 0.0) +
              torch.where(py + 1 == SHIFT, wy1, 0.0))
        row0 = torch.zeros((E, H * W, LANE), device=vol.device)
        if v.shape[2] > 0:
            row0[..., :n] = v[:, :, 0, :n]
        out[..., :LANE] = (bx + ay[..., None]) + row0
    return out.reshape(E, H, W, -1).to(torch.bfloat16)


def corr_extract_packed(vol, coords, num_levels=4, mode="full",
                        weights="f32", round_mid=False):
    """Packed windowed lookup from :func:`cuda_corr.build_volumes`
    volumes (X2-X5).

    vol: (E, H*W, N2) bf16; coords: (E, H, W, 2) f32 level-0 [x, y].
    Returns (E, H, W, num_levels*64) bf16, level-major. ``weights`` and
    ``round_mid`` select X2's rounding (:data:`X2_VARIANTS`); ``mode``
    X3's diagnostic outputs, whose unwritten channels are 0:
    ``nostore`` keeps the dy = 0 row of each level; ``novab`` writes
    channels 0-127 as the last level's dx = 0 selector row (with the
    TPU shift bank's lane wrap) + its A_y[0, 0] + row 0 of its
    correlation plane; ``dma`` writes channels 0-127 as the per-column
    sums of the last level's correlation plane, 0 past its width."""
    _choice("mode", mode, MODES)
    _choice("weights", weights, WEIGHTS)
    if mode in ("novab", "dma") and (round_mid or num_levels < 2):
        raise ValueError(f"mode {mode!r} needs 2 or more levels and has "
                         f"no row blend to round")
    if mode == "dma" and weights != "f32":
        raise ValueError("mode 'dma' reads no weights")
    if vol.device.type == "cpu":
        return corr_extract_packed_plain(vol, coords, num_levels, mode,
                                         weights, round_mid)
    E, H, W, _ = coords.shape
    shapes = level_shapes(H, W, num_levels)
    levels = level_array(shapes)
    N2 = sum(h * w for h, w in shapes)
    check_tensor("vol", vol, (E, H * W, N2), (torch.bfloat16,),
                 vol.device)
    check_tensor("coords", coords, (E, H, W, 2), (torch.float32,),
                 vol.device)
    out = torch.empty((E, H, W, num_levels * PTAPS), dtype=torch.bfloat16,
                      device=vol.device)
    with torch.cuda.device(vol.device):
        rc = _library().pvo_corr_extract_packed(
            vol.data_ptr(), coords.data_ptr(), out.data_ptr(), E * H * W,
            N2, num_levels, levels, MODES.index(mode),
            WEIGHTS.index(weights), int(round_mid),
            torch.cuda.current_stream().cuda_stream)
    check_rc(rc, "corr_extract_packed")
    LAUNCHES["corr_extract_packed"] += 1
    return out
