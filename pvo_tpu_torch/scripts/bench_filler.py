"""The trajectory filler alone at terminate scale (port of
``scripts/bench_filler.py``).

    python -m pvo_tpu_torch.scripts.bench_filler [n_kf [reps]]
        [--image_size 240 808] [--device cpu]

``bench_track``'s system (240x808, every frame a keyframe, the segment
filter on, ``tame_net(0)`` weights) in a power-of-two buffer of at least
``n_kf + 24`` (``bench_terminate.buffer_for``), with ``n_kf`` (default
100) synthetic keyframes already on the device and no tracking: the JAX
script's fake keyframe state, SE3-exp poses of 0.01-scale tangents from
``RandomState(0)``, unit disparities, frame 0's fnet features tiled, the
keyframes' timestamps 0..n_kf-1 (and frame 0's intrinsics, which the
filler's reprojection reads). Then ``traj_filler`` over the
``n_kf``-frame stream, ``reps`` times (default 3), each on the host
clock ending in its poses' readback; the poses must be finite. One JSON
line last.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.scripts.bench_terminate import buffer_for
from pvo_tpu_torch.scripts.bench_track import bench_system, synth_stream
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vo.net.droidnet import normalize_images


@torch.no_grad()
def fake_keyframes(sysm, frames, n_kf):
    """The JAX script's keyframe state for ``n_kf`` keyframes of
    ``sysm``'s video."""
    v = sysm.video
    dev = v.device
    rng = np.random.RandomState(0)
    tang = torch.from_numpy(0.01 * rng.randn(n_kf, 6).astype(np.float32))
    v.poses[:n_kf] = se3.exp(tang.to(dev))
    v.disps[:n_kf] = 1.0
    _, img, intr, _ = frames[0]
    x = torch.as_tensor(np.asarray(img)[None], device=dev)
    v.fmaps[:n_kf] = sysm.net.fnet(normalize_images(x))[0].to(v.fmaps.dtype)
    v.intrinsics[:n_kf] = torch.as_tensor(intr, device=dev) / 8.0
    v.tstamp[:n_kf] = np.arange(n_kf)
    v.counter = n_kf


def run(n_kf=100, reps=3, image_size=(240, 808), device="cuda"):
    dev = open_device(device)
    H, W = image_size
    sysm = bench_system(image_size, buffer_for(n_kf), dev)
    frames = list(synth_stream(n_kf, H, W))
    fake_keyframes(sysm, frames, n_kf)
    secs = []
    for r in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        traj = sysm.traj_filler(iter(frames)).cpu().numpy()
        secs.append(time.perf_counter() - t0)
        print(f"rep {r}: {secs[-1]:.3f}s for {len(traj)} poses ({n_kf} kf)",
              flush=True)
        if not np.isfinite(traj).all():
            raise AssertionError("the filler gave non-finite poses")
    return {"n_kf": n_kf, "image_size": [H, W], "poses": len(traj),
            "seconds": secs, "warm_min_s": min(secs[1:] or secs),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("n_kf", type=int, nargs="?", default=100)
    p.add_argument("reps", type=int, nargs="?", default=3)
    p.add_argument("--image_size", type=int, nargs=2, default=[240, 808])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    out = run(args.n_kf, args.reps, tuple(args.image_size), args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
