"""The three correlation kernels of the tracking path, hand-written in
CUDA for Hopper (``pvo_tpu_torch/csrc/corr.cu``), with their plain
PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version only for tensors on the CPU; it never falls back. The library
is built with ``nvcc`` for ``sm_90a`` at first use into ``csrc/build/``
and loaded with ctypes. ``LAUNCHES`` counts kernel launches per kernel.

K1 ``build_volumes`` replaces ``pallas_build_volumes``
  (pvo_tpu/vo/net/pallas_corr.py:381, body ``_build_kernel`` :349).
  Bound: arithmetic. E=48 edges at 30x101 is a (3030 x 128) x
  (128 x 3991) product per edge, 149 GFLOP, against a 1.16 GB bf16
  store. Design: a shared-memory-tiled f32 product (128x128 tile, 8x8
  register tile per thread, f32 accumulation, bf16 store); the pooled
  f2 pyramid is one stacked operand, so all four levels are one
  product. Tensor-core MMA is left for later work.
K2 ``corr_extract`` replaces ``pallas_corr_extract`` (:461, body
  ``_extract_kernel`` :265). Bound: memory. It reads 4 x 8x8 bf16 taps
  and writes 196 f32 per pixel. Design: one warp per pixel, a lane per
  (level, patch row); the lower patch row comes from the next lane by a
  shuffle, and the 7x7 window is written in the reference dx-major
  order. No one-hot selectors, no padding, no packed layout.
K3 ``corr_lookup`` replaces ``pallas_corr_lookup`` (:565, body
  ``_kernel`` :164). Bound: on-chip reads. Each pixel takes 4 x 64
  length-C dot products against pooled f2 rows that neighbouring
  pixels share through L1. Design: 4 pixels x 64 taps per block, f1 in
  shared memory, one dot product per thread, the blend from a shared
  8x8 patch. No stored volume and no x/y tiling.

K1 and K3 take the pooled f2 pyramid from the wrapper
(:func:`pool_pyramid`): each level's 2x2 mean is taken in f32 and
rounded to the feature dtype, and the next level is pooled from the
rounded one, as ``pallas_corr.build_padded_pyramid`` pools bf16 maps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import corr as corr_ops

RADIUS = 3
TAPS = (2 * RADIUS + 1) ** 2
SCALE = 1.0 / 16.0

KERNELS = ("build_volumes", "corr_extract", "corr_lookup")
LAUNCHES = dict.fromkeys(KERNELS, 0)

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "corr.cu"
BUILD_DIR = SOURCE.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def reset_launches():
    for k in KERNELS:
        LAUNCHES[k] = 0


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
        lib.pvo_build_volumes.argtypes = [p, i, p, p, i, i, i, i, f, p]
        lib.pvo_corr_extract.argtypes = [p, p, p, i, i, i, ip, p]
        lib.pvo_corr_lookup.argtypes = [p, i, p, p, p, i, i, i, i, f, i,
                                        ip, p]
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


def pool_pyramid(f2, num_levels=4):
    """(E, H, W, C) -> the levels of :func:`corr.pool_features`, stacked
    f32 (E, sum H_l W_l, C)."""
    E, C = f2.shape[0], f2.shape[-1]
    return torch.cat([f.reshape(E, -1, C) for f in
                      corr_ops.pool_features(f2, num_levels)], dim=1)


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


# ---------------------------------------------------------------- K1

def build_volumes_plain(f1, f2, num_levels=4):
    E, H, W, C = f1.shape
    pyr = pool_pyramid(f2, num_levels)
    vol = torch.bmm(f1.reshape(E, H * W, C).float() * SCALE,
                    pyr.transpose(1, 2))
    return vol.to(torch.bfloat16)


def build_volumes(f1, f2, num_levels=4):
    """All-pairs correlation volumes of edges (f1[e], f2[e]).

    f1, f2: (E, H, W, C) f32 or bf16. Returns (E, H*W, sum_l H_l W_l)
    bf16: level l (f2 pooled l times) at column offset
    sum_{k<l} H_k W_k, values f1 . f2_l / 16 accumulated in f32."""
    if f1.device.type == "cpu":
        return build_volumes_plain(f1, f2, num_levels)
    E, H, W, C = f1.shape
    check_tensor("f1", f1, (E, H, W, C), FEATS, f1.device)
    check_tensor("f2", f2, (E, H, W, C), FEATS, f1.device)
    shapes = level_shapes(H, W, num_levels)
    level_array(shapes)
    N2 = sum(h * w for h, w in shapes)
    with torch.cuda.device(f1.device):
        pyr = pool_pyramid(f2, num_levels)
        vol = torch.empty((E, H * W, N2), dtype=torch.bfloat16,
                          device=f1.device)
        rc = _library().pvo_build_volumes(
            f1.data_ptr(), int(f1.dtype == torch.bfloat16), pyr.data_ptr(),
            vol.data_ptr(), E, H * W, N2, C, SCALE,
            torch.cuda.current_stream().cuda_stream)
    check_rc(rc, "build_volumes")
    LAUNCHES["build_volumes"] += 1
    return vol


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

    vol: (E, H*W, N2) bf16; coords: (E, H, W, 2) f32 level-0 [x, y].
    Returns (E, H, W, num_levels*49) f32, dx-major taps."""
    if vol.device.type == "cpu":
        return corr_extract_plain(vol, coords, num_levels)
    E, H, W, _ = coords.shape
    shapes = level_shapes(H, W, num_levels)
    N2 = sum(h * w for h, w in shapes)
    check_tensor("vol", vol, (E, H * W, N2), (torch.bfloat16,), vol.device)
    check_tensor("coords", coords, (E, H, W, 2), (torch.float32,),
                 vol.device)
    out = torch.empty((E, H, W, num_levels * TAPS), dtype=torch.float32,
                      device=vol.device)
    with torch.cuda.device(vol.device):
        rc = _library().pvo_corr_extract(
            vol.data_ptr(), coords.data_ptr(), out.data_ptr(), E * H * W,
            N2, num_levels, level_array(shapes),
            torch.cuda.current_stream().cuda_stream)
    check_rc(rc, "corr_extract")
    LAUNCHES["corr_extract"] += 1
    return out


# ---------------------------------------------------------------- K3

def corr_lookup_plain(f1, f2, coords, num_levels=4):
    return corr_ops.corr_and_lookup(f1, f2, coords, num_levels, RADIUS)


def corr_lookup(f1, f2, coords, num_levels=4):
    """Fused correlation + windowed lookup without a stored volume.

    f1, f2: (E, H, W, C) f32 or bf16; coords: (E, H, W, 2) f32.
    Returns (E, H, W, num_levels*49) f32, dx-major taps."""
    if f1.device.type == "cpu":
        return corr_lookup_plain(f1, f2, coords, num_levels)
    E, H, W, C = f1.shape
    check_tensor("f1", f1, (E, H, W, C), FEATS, f1.device)
    check_tensor("f2", f2, (E, H, W, C), FEATS, f1.device)
    check_tensor("coords", coords, (E, H, W, 2), (torch.float32,),
                 f1.device)
    shapes = level_shapes(H, W, num_levels)
    N2 = sum(h * w for h, w in shapes)
    out = torch.empty((E, H, W, num_levels * TAPS), dtype=torch.float32,
                      device=f1.device)
    with torch.cuda.device(f1.device):
        pyr = pool_pyramid(f2, num_levels)
        rc = _library().pvo_corr_lookup(
            f1.data_ptr(), int(f1.dtype == torch.bfloat16), pyr.data_ptr(),
            coords.data_ptr(), out.data_ptr(), H * W, E * H * W, N2, C,
            SCALE, num_levels, level_array(shapes),
            torch.cuda.current_stream().cuda_stream)
    check_rc(rc, "corr_lookup")
    LAUNCHES["corr_lookup"] += 1
    return out
