"""A fixed-order segment sum, hand-written in CUDA for Hopper
(``pvo_tpu_torch/csrc/segsum.cu``), with its plain PyTorch version.

``index_add(out, idx, x)`` is ``out.index_add_(0, idx, x)`` on f32 rows,
with rows whose index lies outside ``[0, out.shape[0])`` dropped: each
output row takes its input rows in ascending order. On the card the CUDA
``index_add_`` adds with float atomics, so the order of a sum, and its
last bits, change from run to run, and the tracker (GraphAgg, the
factor graph's chunked update, the DBA) did not repeat itself. The
kernel sums in the order of the CPU's ``index_add_`` in one launch and
with no atomics, so on the same inputs it equals the CPU bit for bit.

The wrapper launches the kernel for CUDA tensors and takes the plain
version (the CPU's ``index_add_`` on a buffer with one overflow row) only
for tensors on the CPU. The library is built like the corr kernels'
(:func:`cuda_corr.build`) and launched on the current stream;
``LAUNCHES`` counts its launches.

The sums it replaces were ``Tensor.index_add_`` on the card; none of them
is a TPU kernel (the JAX package sums with ``segment_sum`` or one-hot
products).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import cuda_corr

KERNELS = ("segsum",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "segsum.cu"

_lib = None


def reset_launches():
    for k in KERNELS:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_corr.build(SOURCE)))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.pvo_segsum.argtypes = [p, p, p, i64, i64, i64, p]
        lib.pvo_segsum.restype = ctypes.c_int
        _lib = lib
    return _lib


def index_add_plain(out, idx, x):
    """The plain version: the CPU's ``index_add_`` into ``out`` and one
    overflow row that takes the dropped rows."""
    n = out.shape[0]
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    buf = torch.cat([out, out.new_zeros((1,) + tuple(out.shape[1:]))])
    buf.index_add_(0, idx, x.to(out.dtype))
    out.copy_(buf[:n])
    return out


def index_add(out, idx, x):
    """``out[idx[n]] += x[n]`` for the rows n with ``idx[n]`` in range,
    in ascending n; in place, returns ``out``. out (N_out, ...) f32
    contiguous, x (N, ...) with the same trailing shape, idx (N,)
    integer."""
    if out.device.type == "cpu":
        return index_add_plain(out, idx, x)
    if torch.is_grad_enabled() and (x.requires_grad or out.requires_grad):
        raise RuntimeError("index_add: the kernel has no backward")
    n_rows = x.shape[0]
    if tuple(x.shape[1:]) != tuple(out.shape[1:]) or \
            tuple(idx.shape) != (n_rows,):
        raise ValueError(f"index_add: out {tuple(out.shape)}, idx "
                         f"{tuple(idx.shape)}, x {tuple(x.shape)}")
    if out.dtype != torch.float32 or not out.is_contiguous():
        raise TypeError("index_add: out must be contiguous f32")
    x = x.to(torch.float32).contiguous()
    idx = idx.to(torch.int64).contiguous()
    for name, t in (("x", x), ("idx", idx)):
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{out.device}")
    D = out[0].numel() if out.shape[0] else 0
    with torch.cuda.device(out.device):
        rc = _library().pvo_segsum(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), n_rows,
            out.shape[0], D, torch.cuda.current_stream().cuda_stream)
    cuda_corr.check_rc(rc, "segsum")
    LAUNCHES["segsum"] += 1
    return out


def segment_sum(x, idx, n):
    """(n, ...) sums of the rows of x by ``idx``, rows out of range
    dropped, each sum in ascending row order."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    return index_add(out, idx, x)
