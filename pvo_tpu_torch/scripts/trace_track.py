"""Device-op trace of the steady tracking loop, and the planner frame's
FLOPs and MFU (port of ``scripts/trace_track.py``).

    python -m pvo_tpu_torch.scripts.trace_track [n_traced_frames]
        [--image_size 240 808] [--warm 42] [--device cpu]

``bench.py``'s stream and system (``bench_track.bench_system``: 240x808,
every frame a keyframe, the segment filter on, the planner engaged from
frame 13), 42 warm-up frames, then ``n_traced_frames`` (default 5) under
``torch.profiler``, each frame a window of its own: the device total a
frame, its kernels a frame and the costliest ones
(``kbench.device_op_totals``). The traced frames replay the planner's
CUDA graph; their K1/K2/K3,
segment-sum and DBA-kernel launches in the trace are held equal to those
``FrameGraph.per_replay`` counts for them.

Then one more frame whose program runs eagerly
(``PlannerDriver.use_graph = False``) under
``torch.utils.flop_counter.FlopCounterMode``: the frame's FLOPs. The
hand-written kernels are opaque to the counter on the card, and on the
CPU their plain versions are torch ops it would count, so
:class:`KernelFlops` leaves the plain versions out of its total and adds
each kernel call's FLOPs by ``kbench.kernel_bound``'s,
``kbench.segsum_bound``'s and ``kbench.dba_bound``'s formulas at the
call's shapes (the segment sum's over every row it is given, the Schur
terms' over every pair slot: the program runs at static widths).
On the CPU the program takes the card's correlation route
(``planner.corr_route``) on the kernels' plain versions, so the count is
the same function of the shapes and of the sections the frame ran on
either device; ``sections`` runs a given set of sections (those the
card's frame ran) whatever the predicates say. MFU is the frame's FLOPs
over the traced frames' device ms a frame, against
``kbench.peak_flops()``, the card's bf16 dense peak; it is not computed
on the CPU, nor without traced frames (``n_traced_frames`` 0: the count
alone). ``launches``: the kernel launches the wrappers counted in this
process. One JSON line last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.scripts.bench_track import (bench_system, corr_rows,
                                               profiled, synth_stream)
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vo import graph_capture, planner
from pvo_tpu_torch.vo.net import corr as corr_ops
from pvo_tpu_torch.vo.net import cuda_corr, cuda_dba, cuda_segsum


def _corr(kernel, E, H, W, C):
    return kbench.kernel_bound(kernel, E, H, W, C)["flops"]


def _dba(kernel, E=0, K=0, HW=0, **kw):
    return kbench.dba_bound(kernel, E, K, HW, **kw)["flops"]


# the wrappers of the hand-written kernels (module, function name, the
# kernel's row, its FLOPs from the call's arguments); corr_and_lookup is
# the plain stand-in of K3 in the motion filter's probe on the CPU;
# cuda_segsum.sums is the entry of every segment sum (index_add and
# segment_sum call it); the DBA's kernels count the einsums of their plain
# versions, every pair slot included, and the solve (on either route) the
# factorization's and triangular solves' operations, which the counter
# does not see in the plain version
WRAPPERS = (
    (cuda_corr, "build_volumes", "build_volumes",
     lambda f1, f2, *a, **kw: _corr("build_volumes", *f1.shape)),
    (cuda_corr, "corr_extract", "corr_extract",
     lambda vol, coords, *a, **kw: _corr("corr_extract",
                                         *coords.shape[:3], 0)),
    (cuda_corr, "corr_lookup", "corr_lookup",
     lambda f1, f2, coords, *a, **kw: _corr("corr_lookup", *f1.shape)),
    (cuda_corr, "corr_lookup_indexed", "corr_lookup",
     lambda fmaps, pyr, ii, jj, coords, *a, **kw: _corr(
         "corr_lookup", *coords.shape[:3], fmaps.shape[-1])),
    (corr_ops, "corr_and_lookup", "corr_lookup",
     lambda f1, f2, coords, *a, **kw: _corr("corr_lookup", *f1.shape)),
    (cuda_segsum, "sums", "segsum",
     lambda jobs: sum(kbench.segsum_bound(
         x.shape[0], x.shape[0], out.shape[0],
         out[0].numel() if out.shape[0] else 0)["flops"]
         for out, idx, x, *_ in jobs)),
    (cuda_dba, "linearize", "dba_linearize",
     lambda poses, disps, intr, target, *a, **kw: _dba(
         "dba_linearize", target.shape[0], 0, target[0, ..., 0].numel())),
    (cuda_dba, "schur", "dba_schur",
     lambda Ei_m, Ej, C, eta, w_m, m_c, pairs_a, *a, **kw: _dba(
         "dba_schur", Ej.shape[0], Ei_m.shape[0], Ei_m.shape[-1],
         NP=pairs_a.shape[0])),
    (cuda_dba, "solve", "dba_solve",
     lambda H, S_sum, v, corr_v, P, *a, **kw: _dba(
         "dba_solve", P=P, motion_only=S_sum is None)),
    (cuda_dba, "backsub", "dba_backsub",
     lambda poses, dx, frame_row, disps, Ej=None, pj_sel=None, m_k=None,
     Ei_m=None, *a, **kw: _dba(
         "dba_backsub", 0 if Ej is None else Ej.shape[0],
         0 if Ei_m is None else Ei_m.shape[0], disps[0].numel(),
         F=poses.shape[0], motion_only=Ej is None)),
)


class KernelFlops:
    """A ``FlopCounterMode`` over a block in which each hand-written
    kernel's wrapper counts its call's FLOPs by the kernel's formula and
    runs its body (the kernel, or its plain version on the CPU) under an
    inner counter whose FLOPs are taken out of the total. A wrapper called
    inside another (the CPU's K3 plain version) counts nothing of its own.

    After the block: ``torch_flops`` (what the counter saw outside the
    wrappers), ``kernels`` {row: [calls, FLOPs]}, ``excluded`` (the plain
    versions' FLOPs left out) and ``total``."""

    def __init__(self):
        self.kernels = {}
        self.excluded = 0
        self.torch_flops = self.total = None
        self._depth = 0

    def _shim(self, fn, row, flops):
        def call(*args, **kw):
            if self._depth:
                return fn(*args, **kw)
            self._depth += 1
            try:
                with FlopCounterMode(display=False) as inner:
                    out = fn(*args, **kw)
            finally:
                self._depth -= 1
            self.excluded += inner.get_total_flops()
            k = self.kernels.setdefault(row, [0, 0])
            k[0] += 1
            k[1] += flops(*args, **kw)
            return out
        return call

    @contextlib.contextmanager
    def __call__(self):
        saved = [(mod, name, getattr(mod, name))
                 for mod, name, _, _ in WRAPPERS]
        for (mod, name, row, flops), (_, _, fn) in zip(WRAPPERS, saved):
            setattr(mod, name, self._shim(fn, row, flops))
        try:
            with FlopCounterMode(display=False) as outer:
                yield self
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        self.torch_flops = outer.get_total_flops() - self.excluded
        self.total = self.torch_flops + sum(f for _, f in
                                            self.kernels.values())


class Sections:
    """A frame program's branches: run where the predicate holds (as
    ``graph_capture.Eager``), or, given ``forced`` paths, exactly those;
    ``ran`` lists the paths that ran."""

    def __init__(self, forced=None):
        self.forced = None if forced is None else set(map(tuple, forced))
        self.ran = []
        self._path = ()

    def __call__(self):
        return self

    def cond(self, pred, fn, name):
        path = self._path + (name,)
        run = bool(pred) if self.forced is None else path in self.forced
        if not run:
            return
        self.ran.append(path)
        outer, self._path = self._path, path
        try:
            fn()
        finally:
            self._path = outer


# planner.corr_route itself: count_frame puts _card_route in its place
_corr_route = planner.corr_route


def _card_route(device, h, w):
    """The correlation route the card takes at h x w features, whatever
    ``device`` is (:func:`planner.corr_route` on a CUDA device)."""
    return _corr_route("cuda", h, w)


def count_frame(sysm, frame, sections=None):
    """Track ``frame`` (t, image, intrinsics, segments) on the engaged
    planner of ``sysm`` with its program run eagerly under
    :class:`KernelFlops`, on the card's correlation route, its branches
    where the predicates hold or, given ``sections``, those. Returns
    (KernelFlops, the sections that ran)."""
    drv = sysm.planner
    if not drv.engaged:
        raise RuntimeError("the planner is not engaged: no frame program "
                           "to count")
    branches = Sections(sections)
    counter = KernelFlops()
    saved = drv.use_graph, planner.corr_route, graph_capture.Eager
    drv.use_graph = False
    planner.corr_route = _card_route
    graph_capture.Eager = branches
    try:
        with counter():
            t, img, intr, segm = frame
            sysm.track(t, img, intr, segments=segm)
            if sysm.video.device.type == "cuda":
                torch.cuda.synchronize(sysm.video.device)
    finally:
        drv.use_graph, planner.corr_route, graph_capture.Eager = saved
    return counter, branches.ran


def replay_counted(drv, records):
    """{kernel: launches} of replayed frames with records ``records`` as
    ``FrameGraph.per_replay`` counts them: K1, K2, K3, the segment sum and
    the DBA's kernels (the solve's grid kernel too, which a planner frame's
    P never reaches)."""
    counted = dict.fromkeys(("build_volumes", "corr_extract", "corr_lookup",
                             "segsum", *cuda_dba.KERNELS, cuda_dba.GRID), 0)
    for rec in records:
        for k, v in drv.frame_graph.per_replay(drv.sections(rec)).items():
            counted[k] += v
    return counted


def profile_launches(prof):
    """The same kernels' launches as the kernel rows of a finished
    ``torch.profiler`` run show them."""
    rows = {k: n for k, (_, n) in corr_rows(prof).items()}

    def named(name):
        return sum(r.count for r in kbench.averages(prof)
                   if r.device_type == torch.autograd.DeviceType.CUDA
                   and name in r.key)
    return {"build_volumes": rows["K1"], "corr_extract": rows["K2"],
            "corr_lookup": rows["K3_bf16"] + rows["K3_f32"],
            "segsum": named("segsum_kernel"),
            **{k: named(f"{k}_kernel")
               for k in (*cuda_dba.KERNELS, cuda_dba.GRID)}}


def traced_frames(sysm, frames):
    """Track ``frames`` on the card, each under a profiler window of its
    own with the card synchronized before and after it. Returns (the
    summed ``kbench.device_op_totals``, the summed :func:`profile_launches`,
    and each window's)."""
    dev = sysm.video.device
    totals, seen = {}, {}
    windows = []
    for t, img, intr, segm in frames:
        torch.cuda.synchronize(dev)
        with profiled() as prof:
            sysm.track(t, img, intr, segments=segm)
            torch.cuda.synchronize(dev)
        for k, (us, n) in kbench.device_op_totals(prof).items():
            us0, n0 = totals.get(k, (0.0, 0))
            totals[k] = (us0 + us, n0 + n)
        windows.append(profile_launches(prof))
        for k, n in windows[-1].items():
            seen[k] = seen.get(k, 0) + n
    return totals, seen, windows


TOP = 40


def run(image_size=(240, 808), n_warm=42, n_trace=5, device="cuda",
        sections=None):
    dev = open_device(device)
    H, W = image_size
    sysm = bench_system(image_size, 128, dev)
    drv = sysm.planner
    frames = list(synth_stream(n_warm + n_trace + 1, H, W))
    resolved = {}
    resolve = drv._resolve_one

    def resolve_one():
        _, ts, replayed = drv._records[0]
        rec = resolve()
        resolved[ts] = (replayed, rec.tolist())
        return rec

    drv._resolve_one = resolve_one
    engaged_at = None
    for t, img, intr, segm in frames[:n_warm]:
        sysm.track(t, img, intr, segments=segm)
        if engaged_at is None and drv.engaged:
            engaged_at = t

    traced = frames[n_warm:n_warm + n_trace]
    totals = None
    if dev.type == "cuda" and traced:
        totals, seen, windows = traced_frames(sysm, traced)
    else:
        for t, img, intr, segm in traced:
            sysm.track(t, img, intr, segments=segm)
    counter, ran = count_frame(sysm, frames[-1], sections)
    drv.disengage()

    out = {"image_size": [H, W], "frames_traced": n_trace,
           "engaged_at": engaged_at,
           "frame_gflop": counter.total / 1e9,
           "frame_gflop_torch": counter.torch_flops / 1e9,
           "kernel_flops": {k: {"calls": n, "gflop": f / 1e9}
                            for k, (n, f) in sorted(counter.kernels.items())},
           "plain_gflop_left_out": counter.excluded / 1e9,
           "sections": [list(p) for p in ran],
           "device_ms_per_frame": None, "kernels_per_frame": None,
           "tflop_per_s": None, "mfu": None,
           "launches_counted": None, "launches_traced": None,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}
    if totals is not None:
        recs = [resolved[float(t)] for t, *_ in traced]
        if not all(replayed for replayed, _ in recs):
            raise AssertionError("the traced frames are not all replays")
        counted = replay_counted(drv, [r for _, r in recs])
        if counted != seen:
            raise AssertionError(f"replayed launches counted {counted}, "
                                 f"traced {seen}: by window {windows}")
        ms = kbench.total_ms(totals) / n_trace
        peak = kbench.peak_flops()
        rate = counter.total / (ms / 1e3)
        out.update(device_ms_per_frame=ms, tflop_per_s=rate / 1e12,
                   kernels_per_frame=sum(n for _, n in totals.values()) /
                   n_trace,
                   mfu=rate / peak, peak_tflop_per_s=peak / 1e12,
                   launches_counted=counted, launches_traced=seen,
                   traced_sections=[[list(p) for p in drv.sections(r)]
                                    for _, r in recs])
        print(f"\n=== {n_trace} frames, device total {ms * n_trace:.1f} ms "
              f"({ms:.3f} ms/frame) ===")
        out["top"] = [[name, us / 1e3, n] for name, us, n in
                      kbench.print_top(totals, TOP)]
        # the segment sum's and the conditional nodes' one-thread
        # kernels (csrc/cond.cu) a frame: (ms, launches)
        for key, name in (("segsum", "segsum_kernel"),
                          ("cond", "set_cond_kernel")):
            rows = [v for k, v in totals.items() if name in k]
            out[f"{key}_per_frame"] = (
                sum(us for us, _ in rows) / 1e3 / n_trace,
                sum(n for _, n in rows) / n_trace)
        if not 0 < out["mfu"] <= 1:
            raise AssertionError(f"MFU {out['mfu']} outside (0, 1]: a "
                                 f"counting fault")
        print(f"\nframe program: {out['frame_gflop']:.2f} GFLOP, device "
              f"{ms:.3f} ms -> {out['tflop_per_s']:.2f} TFLOP/s = "
              f"{100 * out['mfu']:.2f}% MFU (peak {peak / 1e12:.0f} TFLOP/s "
              f"bf16)")
    else:
        print(f"frame program: {out['frame_gflop']:.4f} GFLOP (CPU: no "
              f"device time, no MFU)")
    out["launches"] = kbench.launch_counts()
    if not math.isfinite(out["frame_gflop"]) or out["frame_gflop"] <= 0:
        raise AssertionError(f"frame FLOPs {out['frame_gflop']}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("n_traced", type=int, nargs="?", default=5)
    p.add_argument("--image_size", type=int, nargs=2, default=[240, 808])
    p.add_argument("--warm", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    out = run(tuple(args.image_size), args.warm, args.n_traced, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
