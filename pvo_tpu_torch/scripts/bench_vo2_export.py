"""Benchmark the flow/depth export step (port of
``scripts/bench_vo2_export.py``): DroidNet on one 2-frame window at
376x1248 (1/8 res 47x156: the fused lookup kernel on every iteration),
15 iterations, identity poses, unit disparities, random weights and
images from a seed.

    python -m pvo_tpu_torch.scripts.bench_vo2_export [--device cpu]

Prints one JSON line {"metric": "vo2_export_seconds_per_pair", ...}:
the mean of 5 warm pairs after one warm-up pair, each ending in the
readback of both exported arrays, synchronized; on a card, with its
name and power limit. Writes no file.
"""

import argparse
import json
import time

import numpy as np
import torch

from pvo_tpu_torch.scripts.kbench import gpu_line
from pvo_tpu_torch.scripts.test_vo2 import export_pair, load_net
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.utils.io import VKITTI_INTRINSICS

def bench_inputs(size, seed=0):
    """The bench's pair: ((2, H, W, 3) uint8 images from ``seed``,
    identity poses, vkitti intrinsics at 1/8 res)."""
    H, W = size
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (2, H, W, 3), np.uint8)
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (2, 1))
    return images, poses, VKITTI_INTRINSICS / 8.0


def time_pairs(net, size=(376, 1248), iters=15, pairs=5, **kw):
    """(seconds per pair over ``pairs`` pairs, the last pair's arrays) on
    :func:`bench_inputs`; the device is synchronized around the timed
    loop and every pair ends in its readbacks. No warm-up: the caller
    runs a pair first."""
    images, poses, intr8 = bench_inputs(size)
    sync = torch.cuda.synchronize if next(
        net.parameters()).is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(pairs):
        arrays = export_pair(net, images, poses, intr8, iters=iters, **kw)
    sync()
    return (time.perf_counter() - t0) / pairs, arrays


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--image_size", type=int, nargs=2, default=[376, 1248])
    p.add_argument("--iters", type=int, default=15)
    args = p.parse_args(argv)

    device = open_device(args.device)
    net = load_net(None, device)
    H, W = args.image_size
    first, _ = time_pairs(net, (H, W), args.iters, pairs=1)
    warm, _ = time_pairs(net, (H, W), args.iters)
    out = {
        "metric": "vo2_export_seconds_per_pair",
        "value": warm,
        "unit": f"s/pair @{H}x{W}, {args.iters} iters, f32, incl. "
                f"per-pair readback (first pair {first:.1f} s, with the "
                f"kernels' build or load)",
        "device": gpu_line() if device.type == "cuda" else "cpu",
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
