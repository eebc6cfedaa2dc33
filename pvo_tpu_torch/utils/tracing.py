"""Tracing / profiling utilities (port of :mod:`pvo_tpu.utils.tracing`).

Named step timers with running means, a ``torch.profiler`` trace
context, and an EventStorage-compatible scalar store. The layer ranges
of the tracker (``vo.<stage>.<layer>``, ``vo/factor_graph.py``) and of
the VPS predictor (``vps.<layer>``) are ``record_function`` ranges that
:func:`range_device_ms` sums from a profile.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


class StepTimer:
    """Named wall-clock timers with running means."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name, sync=None):
        """``sync``: a tensor whose device is synchronized before the
        clock stops when it is a card, as the JAX timer waits for its
        array."""
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self):
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in sorted(self.totals)}

    def report(self):
        return " ".join(f"{k}={1e3 * v:.1f}ms"
                        for k, v in self.summary().items())


@contextlib.contextmanager
def profile_trace(logdir="profiles", enabled=True):
    """``torch.profiler`` over the block, CPU and CUDA activity, written
    as a chrome trace under ``logdir`` (view in Perfetto). Yields the
    profiler (None when disabled)."""
    if not enabled:
        yield None
        return

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{int(time.time() * 1e3)}.json"))


def range_device_ms(prof, prefixes):
    """Device ms and kernel count inside each ``record_function`` range
    whose name starts with one of ``prefixes``, from a finished
    ``torch.profiler`` run with CUDA activity: {range: (ms, kernels)}.
    A kernel counts towards every range open on its host thread when it
    was launched; nested ranges each count it. Kernels launched outside
    PyTorch's dispatcher (the ctypes-bound corr kernels) are attributed
    to no range. The ranges' own annotation rows on the device are not
    kernels and are left out."""
    prefixes = tuple(prefixes)
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or \
                not e.name.startswith(prefixes):
            continue
        ks = [k for k in _kernels_below(e) if not k.name.startswith(prefixes)]
        ms, n = out.get(e.name, (0.0, 0))
        out[e.name] = (ms + sum(k.duration for k in ks) / 1e3, n + len(ks))
    return out


def _kernels_below(event):
    """CUDA kernels launched by ``event`` or by any op nested in it."""
    stack = [event]
    while stack:
        e = stack.pop()
        for k in e.kernels:
            yield k
        stack.extend(e.cpu_children)


class EventStorage:
    """Minimal detectron2-EventStorage equivalent: scalar history with
    smoothing, usable by trainers and writers."""

    def __init__(self):
        self._history = defaultdict(list)
        self.iter = 0

    def put_scalar(self, name, value):
        self._history[name].append((self.iter, float(value)))

    def put_scalars(self, **kw):
        for k, v in kw.items():
            self.put_scalar(k, v)

    def latest(self):
        return {k: v[-1][1] for k, v in self._history.items() if v}

    def median(self, name, window=20):
        vals = [v for _, v in self._history[name][-window:]]
        return float(np.median(vals)) if vals else 0.0

    def step(self):
        self.iter += 1
