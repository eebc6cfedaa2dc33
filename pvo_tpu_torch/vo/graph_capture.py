"""One CUDA graph for a frame program with data-dependent branches.

:class:`Eager` runs a branch where its predicate holds, reading the
predicate on the host (on the CPU, and on the card before capture).
:class:`FrameGraph` captures the program once into a CUDA graph and turns
each branch into a CUDA conditional node (``csrc/cond.cu``): a one-thread
kernel sets the node's handle from the device predicate, and the body
runs at replay only where it holds, so a replayed frame reads nothing
back and the host never waits.

Capture rules the program keeps: no host read (``.item()``, a boolean
mask index, ``bincount``, a pageable copy; capture fails on one), every
tensor that outlives the frame or crosses a branch is a static buffer
written in place, and Python values are fixed at capture. Allocations of
the main program come from the graph's private pool; a body's from one
:class:`torch.cuda.MemPool` that only bodies use, so nothing else ever
takes their memory while the graph lives. TF32 and ``cudnn.benchmark``
stay off during capture.

Kernel launches: the wrappers count a launch when they issue it, which
under capture is once, not once per replay. :class:`FrameGraph` takes
each section's captured launches out of the counters (``COUNTERS``) and
gives them back with :meth:`FrameGraph.count`, for each replay, for the
sections that ran.
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path

import torch

from pvo_tpu_torch.vo.net import cuda_corr, cuda_dba, cuda_segsum

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "cond.cu"
# the launch counters a graph's replays are counted into
COUNTERS = (cuda_corr.LAUNCHES, cuda_corr.F32_LAUNCHES, cuda_segsum.LAUNCHES,
            cuda_dba.LAUNCHES)

_lib = None
# a few streams per device, shared by every capture and eager frame: a
# library (cuBLAS) keeps a workspace for each stream it first sees, for
# the life of the process
_STREAMS = {}


def _card(device):
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    return device


def stream(device, k):
    """The ``k``-th shared side stream of ``device``."""
    streams = _STREAMS.setdefault(_card(device), [])
    while len(streams) <= k:
        streams.append(torch.cuda.Stream(device))
    return streams[k]


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_corr.build(SOURCE)))
        p = ctypes.c_void_p
        lib.pvo_cond_begin.argtypes = [p, p, p]
        lib.pvo_cond_end.argtypes = [p]
        lib.pvo_cond_begin.restype = lib.pvo_cond_end.restype = ctypes.c_int
        _lib = lib
    return _lib


def _snapshot():
    return [dict(c) for c in COUNTERS]


def _restore(snap):
    for c, s in zip(COUNTERS, snap):
        c.update(s)


def _delta(a, b):
    return [{k: bk - ak[k] for k, bk in bd.items()} for ak, bd in zip(a, b)]


class Eager:
    """Branches taken on the host: ``cond`` reads its predicate."""

    def cond(self, pred, fn, name):
        if bool(pred):
            fn()


class FrameGraph:
    """Captures ``program(branches)`` once; :meth:`replay` runs it.

    Sections are named by the path of branch names that leads to them,
    ``()`` being the unconditional part; :attr:`launches` maps each to
    its captured launches (exclusive of nested sections)."""

    def __init__(self, device):
        self.device = _card(device)
        self.graph = torch.cuda.CUDAGraph()
        self.pool = torch.cuda.graph_pool_handle()
        self.body_pool = torch.cuda.MemPool()
        self._path = ()
        self.launches = {}
        self.replays = 0
        self.capture_s = None

    def capture(self, program):
        _library()       # built and loaded before capture
        before = _snapshot()
        self.launches = {}
        cudnn = torch.backends.cudnn
        saved = (cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32,
                 cudnn.allow_tf32)
        cudnn.benchmark = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool,
                                  stream=stream(self.device, 0)):
                program(self)
        finally:
            self.capture_s = time.perf_counter() - t0
            (cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32,
             cudnn.allow_tf32) = saved
        after = _snapshot()
        # sections hold their own launches, without their descendants'
        self.launches[()] = _minus(_delta(before, after),
                                   list(self.launches.values()))
        _restore(before)

    def cond(self, pred, fn, name):
        lib = _library()
        if pred.dtype != torch.bool or pred.numel() != 1 or \
                pred.device != self.device:
            raise ValueError("a branch predicate is one bool on the card")
        parent = torch.cuda.current_stream(self.device)
        path = self._path + (name,)
        if path in self.launches:
            raise ValueError(f"branch {path} captured twice")
        child = stream(self.device, len(path))
        cuda_corr.check_rc(lib.pvo_cond_begin(
            parent.cuda_stream, pred.data_ptr(), child.cuda_stream),
            "conditional node")
        before = _snapshot()
        outer, self._path = self._path, path
        try:
            with torch.cuda.stream(child):
                if len(path) == 1:
                    with torch.cuda.use_mem_pool(self.body_pool,
                                                 self.device):
                        fn()
                else:
                    fn()
        finally:
            self._path = outer
            rc = lib.pvo_cond_end(child.cuda_stream)
        cuda_corr.check_rc(rc, "conditional node")
        inner = [v for p, v in self.launches.items()
                 if len(p) > len(path) and p[:len(path)] == path]
        self.launches[path] = _minus(_delta(before, _snapshot()), inner)

    def replay(self):
        self.graph.replay()
        self.replays += 1

    def count(self, ran):
        """Add one replay's launches to the counters: the unconditional
        section's and those of the sections in ``ran`` (paths)."""
        for path in ((),) + tuple(ran):
            for c, d in zip(COUNTERS, self.launches.get(path, ())):
                for k, v in d.items():
                    c[k] += v

    def per_replay(self, ran):
        """{kernel: launches} of one replay that ran sections ``ran``:
        the corr kernels, the segment sum and the DBA's kernels."""
        out = {}
        for path in ((),) + tuple(ran):
            launches = self.launches.get(path)
            if launches is None:
                continue
            for d in (launches[0], launches[2], launches[3]):
                for k, v in d.items():
                    out[k] = out.get(k, 0) + v
        return out


def _minus(total, parts):
    out = [dict(d) for d in total]
    for p in parts:
        for o, d in zip(out, p):
            for k, v in d.items():
                o[k] -= v
    return out
