"""Per-stage wall time of the steady tracking loop (port of
``scripts/profile_track.py``).

    python -m pvo_tpu_torch.scripts.profile_track [--frames 40 30]
        [--image_size 240 808] [--classic] [--device cpu]

``bench.py``'s protocol (``bench_track.bench_system`` at 240x808, every
frame a keyframe, the segment filter on), 40 warm-up frames, then 30
measured. The JAX script wraps its asynchronous methods (``track_async``,
``resolve_track``, ``_fused``, ``prefetch``); the port has no such
split, so its own stages are wrapped, each with a synchronize before and
after it (a stage's time is its own, queued work included): the motion
filter (``track_async``, ``resolve_track``), the frontend
(``Frontend._update`` whole, and in it ``rm_factors``,
``add_proximity_factors``, the update, ``video.distance``). Once the
planner engages (frame 13 on this protocol) a frame is one program: the
stage ``planner.replay`` (a CUDA graph replay on the card;
``planner.eager`` for its eager frames, the CPU's included) and its
input upload ``planner.upload``. ``--classic`` (``VOConfig.pipeline =
False``) runs the classic stages on every frame. Prints per stage the
mean and total ms and the calls, costliest first, and frames/s over the
measured frames (with the stages' synchronizes). One JSON line last.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from pvo_tpu_torch.scripts.bench_track import bench_system, synth_stream
from pvo_tpu_torch.utils.device import open_device


class StageTimes:
    """Synchronized wall time of wrapped calls, by stage name."""

    def __init__(self, device):
        self.device = device
        self.times = defaultdict(list)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, name, fn, name_of=None):
        """``fn`` timed under ``name`` (or ``name_of(result)``)."""
        def call(*a, **kw):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.sync()
            self.times[name_of(out) if name_of else name].append(
                time.perf_counter() - t0)
            return out
        return call

    def table(self):
        rows = sorted(self.times.items(), key=lambda kv: -sum(kv[1]))
        return {k: {"mean_ms": 1e3 * float(np.mean(v)),
                    "total_ms": 1e3 * float(np.sum(v)), "calls": len(v)}
                for k, v in rows}


def instrument(sysm, st):
    """Wrap the stages of ``sysm`` (instance attributes; the classes stay
    as they are)."""
    fx, fe, v, drv = sysm.filterx, sysm.frontend, sysm.video, sysm.planner
    g = fe.graph
    fx.track_async = st.wrap("motion_filter.track_async", fx.track_async)
    fx.resolve_track = st.wrap("motion_filter.resolve_track",
                               fx.resolve_track)
    fe._update = st.wrap("frontend._update (total)", fe._update)
    g.rm_factors = st.wrap("frontend.rm_factors", g.rm_factors)
    g.add_proximity_factors = st.wrap("frontend.add_proximity",
                                      g.add_proximity_factors)
    g.update = st.wrap("frontend.update", g.update)
    v.distance = st.wrap("video.distance", v.distance)
    drv._upload = st.wrap("planner.upload", drv._upload)
    drv._run = st.wrap("planner", drv._run, lambda replayed: (
        "planner.replay" if replayed else "planner.eager"))


def run(image_size=(240, 808), n_warm=40, n_meas=30, device="cuda",
        pipeline=True):
    dev = open_device(device)
    H, W = image_size
    sysm = bench_system(image_size, 128, dev, pipeline=pipeline)
    st = StageTimes(dev)
    instrument(sysm, st)
    frames = list(synth_stream(n_warm + n_meas, H, W))
    engaged_at = None
    for t, img, intr, segm in frames[:n_warm]:
        sysm.track(t, img, intr, segments=segm)
        if engaged_at is None and sysm.planner.engaged:
            engaged_at = t
    st.sync()
    st.times.clear()
    t0 = time.perf_counter()
    for t, img, intr, segm in frames[n_warm:]:
        f0 = time.perf_counter()
        sysm.track(t, img, intr, segments=segm)
        st.times["frame_total"].append(time.perf_counter() - f0)
    st.sync()
    wall = time.perf_counter() - t0
    table = st.table()
    print(f"\n{n_meas} frames in {wall:.2f}s = {n_meas / wall:.2f} fps")
    print(f"{'stage':32s} {'mean ms':>9s} {'total ms':>9s} {'calls':>6s}")
    for k, r in table.items():
        print(f"{k:32s} {r['mean_ms']:9.2f} {r['total_ms']:9.1f} "
              f"{r['calls']:6d}")
    return {"frames": n_meas, "image_size": [H, W], "seconds": wall,
            "fps": n_meas / wall, "path": "planner" if pipeline else
            "classic", "engaged_at": engaged_at, "stages": table,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, nargs=2, default=[40, 30],
                   metavar=("WARM", "MEASURED"))
    p.add_argument("--image_size", type=int, nargs=2, default=[240, 808])
    p.add_argument("--classic", action="store_true",
                   help="the classic host loop (VOConfig.pipeline=False)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    out = run(tuple(args.image_size), *args.frames, args.device,
              pipeline=not args.classic)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
