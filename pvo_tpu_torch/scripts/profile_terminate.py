"""``VOSystem.terminate`` stage by stage (port of
``scripts/profile_terminate.py``).

    python -m pvo_tpu_torch.scripts.profile_terminate [n_keyframes]
        [--image_size 240 808] [--device cpu]

``bench_terminate``'s system (``tracked_system``: ``n_keyframes``
frames of ``bench_track``'s stream, default 100, every one a keyframe,
the planner engaged after initialization), then terminate's stages run
one by one as the JAX script runs them, each on the host clock ending
in a synchronize: disengaging the planner (one blocking read), the
pending admission, the last frontend update, the flush, the two backend
passes (``Backend``'s body: normalize, the proximity factors with their
edge count, each update step as its own ``update_lowmem(steps=1)``, which
prepares its correlation operands anew each step, then clear) and the
trajectory filler over the stream. Prints one line a stage and one JSON
line last, ``{"total_s", "n_kf", "stages"}``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from pvo_tpu_torch.scripts.bench_terminate import tracked_system
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vo.factor_graph import FactorGraph

BACKEND_STEPS = (7, 12)


class Stamps:
    """Stage rows: each from the last stamp, after a synchronize."""

    def __init__(self, device):
        self.device = device
        self.rows = []
        self.sync()
        self.t0 = time.perf_counter()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, name):
        self.sync()
        t = time.perf_counter()
        self.rows.append((name, t - self.t0))
        print(f"  {name:40s} {t - self.t0:8.3f}s", flush=True)
        self.t0 = t


@torch.no_grad()
def stages(sysm, frames, stamp):
    """terminate's stages on ``sysm``, stamped; returns the poses."""
    sysm.planner.disengage()
    stamp("disengage")
    if sysm._pending_adm is not None:
        sysm.filterx.resolve_track(sysm._pending_adm)
        sysm._pending_adm = None
    stamp("resolve_track")
    sysm.frontend()
    stamp("frontend_last_update")
    sysm.frontend.flush()
    stamp("frontend_flush")
    be = sysm.backend
    for steps in BACKEND_STEPS:
        be.video.normalize()
        stamp(f"backend{steps}.normalize")
        graph = FactorGraph(be.video, be.update, max_edges=be.max_edges,
                            max_inactive=1, edge_chunk=be.edge_chunk,
                            net_dtype=torch.bfloat16)
        graph.layer = "vo.backend"
        graph.add_proximity_factors(
            rad=be.cfg.backend_radius, nms=be.cfg.backend_nms,
            thresh=be.cfg.backend_thresh, beta=be.cfg.beta,
            max_new=be.max_edges // 2)
        stamp(f"backend{steps}.proximity (E={graph.n_edges})")
        for s in range(steps):
            graph.update_lowmem(steps=1)
            stamp(f"backend{steps}.lowmem_step{s}")
        graph.clear_edges()
        stamp(f"backend{steps}.clear")
    traj = sysm.traj_filler(iter(frames)).cpu().numpy()
    stamp("traj_filler")
    return traj


def run(n_kf=100, image_size=(240, 808), device="cuda"):
    dev = open_device(device)
    t0 = time.perf_counter()
    sysm, frames = tracked_system(n_kf, image_size, dev)
    print(f"  tracking total {time.perf_counter() - t0:.1f}s", flush=True)
    stamp = Stamps(dev)
    traj = stages(sysm, frames, stamp)
    if not np.isfinite(traj).all():
        raise AssertionError("terminate's stages gave non-finite poses")
    return {"total_s": sum(d for _, d in stamp.rows), "n_kf": n_kf,
            "keyframes": int(sysm.video.counter),
            "stages": {k: v for k, v in stamp.rows},
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("n_keyframes", type=int, nargs="?", default=100)
    p.add_argument("--image_size", type=int, nargs=2, default=[240, 808])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    out = run(args.n_keyframes, tuple(args.image_size), args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
