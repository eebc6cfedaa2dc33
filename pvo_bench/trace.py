"""The traced stretch: ``torch.profiler`` over a few units of work, and
its reduction to what the per-layer metrics read.

Every device operation (kernels, copies, memsets) of the stretch is one
interval on one timeline; the busy time is the length of their union,
the window the span from the first operation's start to the last one's
end (the stretch is synchronized before and after). The breakdown lists the device operations that took the most
time and the longest idle gaps, each named by the innermost host
operation running when the gap began.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

# annotations on the device's timeline, not operations: the program's
# profiler ranges and the profiler's own steps
RANGE_PREFIXES = ("vo.", "vps.", "ProfilerStep")


class Profile:
    def __init__(self, device_ops, host_ops, window_s, units):
        # device_ops: [(name, start_us, end_us)], sorted by start
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.host_ops = host_ops
        self.units = units
        self.busy_s = self._union() / 1e6
        # the device timeline's span: the host's start-up after the
        # synchronize before the stretch is not the device's idle time
        self.window_s = (max(e for _, _, e in self.device_ops) -
                         self.device_ops[0][1]) / 1e6 \
            if self.device_ops else window_s

    def _union(self):
        total, end = 0.0, None
        for _, s, e in self.device_ops:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def periodic(self, marker):
        """Keep the device operations from the first start of an operation
        named ``marker`` (one a unit of work, such as a kernel each frame
        launches once) to its last start: whole units in steady state,
        without the edges of the stretch. Sets ``units`` to their number,
        the window to their span and the busy time to its union."""
        starts = [s for n, s, _ in self.device_ops if marker in n]
        if len(starts) < 2:
            raise ValueError(f"fewer than two {marker!r} in the profile")
        lo, hi = starts[0], starts[-1]
        self.device_ops = [(n, max(s, lo), min(e, hi))
                           for n, s, e in self.device_ops
                           if s >= lo and s < hi]
        self.units = len(starts) - 1
        self.window_s = (hi - lo) / 1e6
        self.busy_s = self._union() / 1e6

    def kernels(self, *substrings):
        """[(name, ms)] of the device operations whose names hold any of
        ``substrings``."""
        return [(n, (e - s) / 1e3) for n, s, e in self.device_ops
                if any(x in n for x in substrings)]

    def kernel_ms(self):
        """Summed duration of the kernels (copies and memsets left out),
        ms."""
        return sum(e - s for n, s, e in self.device_ops
                   if not n.startswith(("Memcpy", "Memset"))) / 1e3

    def gaps(self):
        """[(start_us, length_us)] of the idle stretches between the
        first and the last device operation."""
        out, end = [], None
        for _, s, e in self.device_ops:
            if end is not None and s > end:
                out.append((end, s - end))
            end = e if end is None else max(end, e)
        return out

    def _host_at(self, t):
        best = None
        for name, s, e in self.host_ops:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "no host operation"

    def breakdown(self):
        tot = defaultdict(float)
        for n, s, e in self.device_ops:
            tot[n] += (e - s) / 1e6
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:10]
        return {"device_ops": [[n[:200], v] for n, v in ops],
                "idle_gaps": [[self._host_at(s)[:200], g / 1e6]
                              for s, g in gaps]}


def traced(step, units, device, warmup=0):
    """Run ``step(i)`` for ``warmup + units`` units under the profiler,
    recording the last ``units`` only (a first unit pays the profiler's
    own start; the recorded ones follow it with no synchronize between),
    synchronized before the first unit and after the last, and reduce
    them to a :class:`Profile`."""
    card = device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU] + \
        ([torch.profiler.ProfilerActivity.CUDA] if card else [])
    sync = (lambda: torch.cuda.synchronize(device)) if card else \
        (lambda: None)
    sched = torch.profiler.schedule(wait=0, warmup=warmup, active=units,
                                    repeat=1) if warmup else None
    sync()
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        t0 = time.perf_counter()
        for i in range(warmup + units):
            step(i)
            if i == warmup + units - 1:
                sync()
            if sched is not None:
                prof.step()
        wall = time.perf_counter() - t0
    dev_ops, host_ops = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            if ev.name.startswith(RANGE_PREFIXES):
                continue
            dev_ops.append((ev.name, tr.start, tr.end))
        else:
            host_ops.append((ev.name, tr.start, tr.end))
    return Profile(dev_ops, host_ops, wall, units)
