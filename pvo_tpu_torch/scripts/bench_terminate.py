"""``VOSystem.terminate`` (the last frontend update, 2 global-BA passes
and the trajectory filler) at >= 100 keyframes on one card (port of
``scripts/bench_terminate.py``), printed as ONE JSON line. Writes no
file.

    python -m pvo_tpu_torch.scripts.bench_terminate [n_keyframes [reps]]
        [--image_size 240 808] [--device cpu]

The protocol of the JAX script: ``n_keyframes`` frames (default 100) of
``bench_track``'s stream, every frame a keyframe, in a power-of-two
buffer of at least ``n_keyframes + 24`` (the filler stages 16-frame
batches past the keyframes), tracked with the default configuration's
planner engaged after initialization, as the JAX script runs;
``terminate(iter(frames))`` (which disengages the planner first, one
blocking read) timed on the host clock with a synchronize; the keyframe
count asserted at least 0.9 ``n_keyframes``; ``reps`` runs (default 3), the first cold, and the
minimum of the warm ones reported, with the backend's and the filler's
seconds of that run. One more run with terminate under ``torch.profiler``
gives the device ms and kernels inside each ``vo.<stage>.<layer>`` range
(``vo/factor_graph.py``) and the corr kernels' own rows, which no range
sees (they are launched through ctypes): K3 in bf16 is the backend's,
K1 and K2 the filler's and the last frontend update's.

``vs_baseline`` is null: the JAX script's 23.299 s is no figure of this
card. On the CPU (``--device cpu``) the device fields are null.
"""

import argparse
import json
import sys
from contextlib import nullcontext

import numpy as np
import torch

from pvo_tpu_torch.scripts.bench_track import (bench_system, corr_rows,
                                               kernel_rows, profiled,
                                               synth_stream, vo_counters)
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.utils.tracing import StepTimer, range_device_ms
from pvo_tpu_torch.vo.net import cuda_dba


def buffer_for(n_kf):
    """The power of two (at least 64) that holds ``n_kf`` keyframes and
    the filler's 16-frame batch past them."""
    buf = 64
    while buf < n_kf + 24:
        buf *= 2
    return buf


def tracked_system(n_kf, image_size, dev):
    """The benches' system after tracking ``n_kf`` frames of
    ``bench_track``'s stream. Returns (system, frames)."""
    H, W = image_size
    sysm = bench_system(image_size, buffer_for(n_kf), dev)
    frames = list(synth_stream(n_kf, H, W))
    for t, img, intr, segm in frames:
        sysm.track(t, img, intr, segments=segm)
    return sysm, frames


def run_once(n_kf, image_size, dev, profile_terminate=False):
    """Track ``n_kf`` frames, then time terminate. Returns (keyframes,
    terminate s, backend s, filler s, the backend's edges per call, the
    DBA kernels' launches in terminate, whether the planner was engaged,
    profile or None)."""
    sysm, frames = tracked_system(n_kf, image_size, dev)
    engaged = sysm.planner.engaged

    # the timers synchronize the device of ``sync`` when it is a card
    timer, sync = StepTimer(), sysm.video.poses

    def settle():
        # each clock starts with nothing queued on the card
        if sync.is_cuda:
            torch.cuda.synchronize(sync.device)

    def timed(name, fn):
        def call(*a, **kw):
            settle()
            with timer.time(name, sync=sync):
                return fn(*a, **kw)
        return call

    sysm.backend = timed("backend", sysm.backend)
    sysm.traj_filler = timed("filler", sysm.traj_filler)
    settle()
    edges = []
    before = dict(cuda_dba.LAUNCHES)
    with profiled() if profile_terminate else nullcontext() as prof, \
            vo_counters([], edges, []):
        with timer.time("terminate", sync=sync):
            traj = sysm.terminate(iter(frames))
    dba = {k: n - before[k] for k, n in cuda_dba.LAUNCHES.items()}
    kf = int(sysm.video.counter)
    if not np.isfinite(traj).all():
        raise AssertionError("terminate produced non-finite poses")
    # keyframe-everything settings must keep about n_kf keyframes, or the
    # metric silently describes a shorter video
    if kf < 0.9 * n_kf:
        raise AssertionError(f"keyframe count collapsed: {kf} < 0.9*{n_kf}")
    return (kf, timer.totals["terminate"], timer.totals["backend"],
            timer.totals["filler"], edges, dba, engaged, prof)


def run(n_kf=100, reps=3, image_size=(240, 808), device="cuda"):
    dev = open_device(device)
    kf, cold, *_, engaged, _ = run_once(n_kf, image_size, dev)
    warms = []
    for _ in range(max(1, reps - 1)):
        warms.append(run_once(n_kf, image_size, dev)[1:6])
        print(f"  warm rep: {warms[-1][0]:.3f}s", file=sys.stderr,
              flush=True)
    warm, backend_s, filler_s, edges, dba = min(warms, key=lambda w: w[0])

    ranges = corr = edges_profiled = None
    if dev.type == "cuda":
        *_, edges_profiled, _, _, prof = run_once(n_kf, image_size, dev,
                                                  profile_terminate=True)
        ranges = {k: {"device_ms": ms, "kernels": n} for k, (ms, n) in
                  sorted(range_device_ms(prof, ("vo.",)).items())}
        corr = {k: {"device_ms": ms, "launches": n}
                for k, (ms, n) in corr_rows(prof).items()}
        ms, n = kernel_rows(prof)
        corr["all_kernels"] = {"device_ms": ms, "launches": n}
    H, W = image_size
    return {
        "metric": "vo_terminate_seconds",
        "value": warm,
        "unit": f"s @ {kf} keyframes, {H}x{W} (min of {len(warms)} warm "
                f"reps {[w[0] for w in warms]}; cold {cold})",
        "vs_baseline": None,
        "backend_s": backend_s,
        "filler_s": filler_s,
        # the backend's edges per global-BA call: with random weights
        # they differ from run to run, and the backend's time with them
        "backend_edges": edges,
        "backend_edges_profiled": edges_profiled,
        # the DBA kernels' launches in that run's terminate: the backend's
        # solves above 48 poses on dba_solve_grid (zeros on the CPU)
        "dba_launches_in_terminate": dba,
        "planner_engaged": engaged,
        "device_ms_by_range": ranges,
        "device_ms_by_kernel": corr,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("n_keyframes", type=int, nargs="?", default=100)
    p.add_argument("reps", type=int, nargs="?", default=3)
    p.add_argument("--image_size", type=int, nargs=2, default=[240, 808])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    out = run(args.n_keyframes, args.reps, tuple(args.image_size),
              args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
