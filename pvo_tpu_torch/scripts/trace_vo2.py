"""Kernel trace of the vo2 export's forward (port of
``scripts/trace_vo2.py``).

    python -m pvo_tpu_torch.scripts.trace_vo2 [iters]
        [--image_size 376 1248] [--device cpu]

``DroidNet.forward`` on one 2-frame window at 376x1248 (47x156
features: K3 on every iteration), f32, ``iters`` iterations (default
15), identity poses, unit disparities, the vkitti intrinsics, images and
random weights from seed 0 (``bench_vo2_export``'s pair, through
``test_vo2.export_pair``, readbacks included). Prints the kernels'
device total of one traced pair, the ms an iteration amortized and the
costliest kernels (``kbench.breakdown``); on the CPU the host ms only.
One JSON line last.
"""

from __future__ import annotations

import argparse
import json

import torch

from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.scripts.bench_vo2_export import bench_inputs
from pvo_tpu_torch.scripts.test_vo2 import export_pair, load_net
from pvo_tpu_torch.utils.device import open_device


TOP = 30


def run(iters=15, image_size=(376, 1248), device="cuda"):
    dev = open_device(device)
    net = load_net(None, dev)
    images, poses, intr8 = bench_inputs(image_size)
    res = kbench.breakdown(
        lambda: export_pair(net, images, poses, intr8, iters=iters), dev,
        top=TOP, reps=1)
    ms = res["device_ms"]
    if ms is not None:
        print(f"total device {ms:.1f} ms / {iters} iters = "
              f"{ms / iters:.2f} ms/iter amortized")
    return {"iters": iters, "image_size": list(image_size), **res,
            "device_ms_per_iter": None if ms is None else ms / iters,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("iters", type=int, nargs="?", default=15)
    p.add_argument("--image_size", type=int, nargs=2, default=[376, 1248])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    out = run(args.iters, tuple(args.image_size), args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
