"""Fixed-order segment sums, hand-written in CUDA for Hopper
(``pvo_tpu_torch/csrc/segsum.cu``), with their plain PyTorch versions.

A job :class:`Sum` ``(out, idx, x, zero)`` is ``out.index_add_(0, idx,
x)`` on f32 rows, with rows whose index lies outside ``[0,
out.shape[0])`` dropped: each output row takes its input rows in
ascending order, starting from ``out`` (accumulate) or from +0.0 (zero
start: ``out`` is not read, so it may be ``torch.empty``). On the card
the CUDA ``index_add_`` adds with float atomics, so the order of a sum,
and its last bits, change from run to run, and the tracker (GraphAgg,
the factor graph's chunked update, the DBA) did not repeat itself. The
kernel sums in the order of the CPU's ``index_add_`` with no atomics, so
on the same inputs it equals the CPU bit for bit.

:func:`sums` runs up to ``MAX_JOBS`` independent jobs in one launch;
:func:`index_add` (accumulate) and :func:`segment_sum` (zero start) are
its one-job forms. The wrapper launches the kernel for CUDA tensors and
takes the plain version (the jobs one by one, in order, through
:func:`index_add_plain`, the zero-start ones into zeros) only for tensors
on the CPU. The library is built like the corr kernels'
(:func:`cuda_corr.build`) and launched on the current stream;
``LAUNCHES`` counts its launches.

The sums it replaces were ``Tensor.index_add_`` on the card; none of them
is a TPU kernel (the JAX package sums with ``segment_sum`` or one-hot
products).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from . import cuda_corr

KERNELS = ("segsum",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "segsum.cu"
MAX_JOBS = 8  # segsum.cu's MAX_JOBS

_lib = None


class Sum(NamedTuple):
    """One job of :func:`sums`: out (N_out, ...) f32 contiguous, idx (N,)
    integer, x (N, ...) with out's trailing shape; ``zero`` starts each
    sum from +0.0 instead of ``out``."""
    out: torch.Tensor
    idx: torch.Tensor
    x: torch.Tensor
    zero: bool = False


class _Job(ctypes.Structure):
    # segsum.cu's Job
    _fields_ = [("x", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("n_rows", ctypes.c_int64),
                ("n_out", ctypes.c_int64), ("D", ctypes.c_int64),
                ("zero", ctypes.c_int32), ("pad", ctypes.c_int32)]


def reset_launches():
    for k in KERNELS:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_corr.build(SOURCE)))
        lib.pvo_segsum.argtypes = [ctypes.POINTER(_Job), ctypes.c_int,
                                   ctypes.c_void_p]
        lib.pvo_segsum.restype = ctypes.c_int
        _lib = lib
    return _lib


def zero_sum(x, idx, n):
    """A zero-start job summing the rows of x into a new (n, ...) f32
    buffer (left unset: the sum writes every value)."""
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    return Sum(out, idx, x, True)


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


def sums_plain(jobs):
    """The plain version of :func:`sums`: the jobs one by one, in order,
    through :func:`index_add_plain`, the zero-start ones into zeros."""
    for out, idx, x, zero in jobs:
        if zero:
            out.zero_()
        index_add_plain(out, idx, x)
    return [job.out for job in jobs]


def _checked(job, dev):
    out, idx, x, zero = job
    n_rows = x.shape[0]
    if tuple(x.shape[1:]) != tuple(out.shape[1:]) or \
            tuple(idx.shape) != (n_rows,):
        raise ValueError(f"segsum: out {tuple(out.shape)}, idx "
                         f"{tuple(idx.shape)}, x {tuple(x.shape)}")
    if out.dtype != torch.float32 or not out.is_contiguous():
        raise TypeError("segsum: out must be contiguous f32")
    x = x.to(torch.float32).contiguous()
    idx = idx.to(torch.int64).contiguous()
    for name, t in (("out", out), ("x", x), ("idx", idx)):
        if t.device != dev:
            raise ValueError(f"segsum: {name} is on {t.device}, expected "
                             f"{dev}")
    D = out[0].numel() if out.shape[0] else 0
    return x, idx, _Job(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                        n_rows, out.shape[0], D, int(bool(zero)), 0)


def sums(jobs):
    """Run the :class:`Sum` jobs (or 4-tuples, or 3-tuples to
    accumulate) in one launch, or in order through their plain version
    on the CPU; returns their outputs. The jobs must be independent: no
    job's ``out`` may overlap another job's ``out`` or ``x``."""
    jobs = [Sum(*job) for job in jobs]
    if not jobs:
        return []
    dev = jobs[0].out.device
    if dev.type == "cpu":
        return sums_plain(jobs)
    if len(jobs) > MAX_JOBS:
        raise ValueError(f"segsum: {len(jobs)} jobs, at most {MAX_JOBS} "
                         "a launch")
    if torch.is_grad_enabled() and any(
            job.x.requires_grad or job.out.requires_grad for job in jobs):
        raise RuntimeError("segsum: the kernel has no backward")
    outs = [job.out.data_ptr() for job in jobs]
    if len(set(outs)) != len(outs):
        raise ValueError("segsum: two jobs write the same output")
    checked = [_checked(job, dev) for job in jobs]
    table = (_Job * len(jobs))(*(c[2] for c in checked))
    with torch.cuda.device(dev):
        rc = _library().pvo_segsum(table, len(jobs),
                                   torch.cuda.current_stream().cuda_stream)
    cuda_corr.check_rc(rc, "segsum")
    LAUNCHES["segsum"] += 1
    return [job.out for job in jobs]


def index_add(out, idx, x):
    """``out[idx[n]] += x[n]`` for the rows n with ``idx[n]`` in range,
    in ascending n; in place, returns ``out``. out (N_out, ...) f32
    contiguous, x (N, ...) with the same trailing shape, idx (N,)
    integer."""
    return sums([Sum(out, idx, x)])[0]


def segment_sum(x, idx, n):
    """(n, ...) sums of the rows of x by ``idx``, rows out of range
    dropped, each sum in ascending row order from +0.0."""
    return sums([zero_sum(x, idx, n)])[0]
