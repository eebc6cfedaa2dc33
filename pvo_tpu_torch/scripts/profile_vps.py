"""The VPS fusion path's costs (port of ``scripts/profile_vps.py``):
program time per variant, and the host-to-card copies apart.

    python -m pvo_tpu_torch.scripts.profile_vps [--height 375 --width 1242]
        [--tiny] [--reps 8] [--device cpu]

Panoptic FPN R-50 (``benchmark_vps.tamed_model(0)``; ``--tiny``: one
block a stage) in bf16 at 375x1242, padded to 384x1248, on the JAX
script's seeded image, flow and depth. Programs: plain, fusion with the
flow on the card, fusion with flow and depth on the card (the
predictor's dense path, ``PanopticPredictor._run``, on the previous
frame's features). Copies: the uint8 image, the flow as f16 and as f32,
the depth as f32, each from the host and summed on the card. Each is
the mean of ``reps`` calls on the host clock ending in a synchronize.
The JAX script fences with a read of a small output, its relay's
workaround (the relay's ``block_until_ready`` returns early); here the
card is synchronized. One JSON line last.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.scripts.benchmark_vps import tamed_model
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vps.panoptic_fpn import PanopticPredictor


def vps_setup(hw, tiny, device, frames=1):
    """The JAX scripts' inputs from ``RandomState(0)`` at ``hw``: a bf16
    predictor on tamed weights, ``frames`` uint8 images, a flow (H, W, 2)
    and a depth (H, W), host arrays."""
    H, W = hw
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (H, W, 3)).astype(np.uint8)
            for _ in range(frames)]
    flow = (rng.randn(H, W, 2) * 2).astype(np.float32)
    depth = (rng.rand(H, W) * 20 + 1).astype(np.float32)
    model = tamed_model(0, (1, 1, 1, 1) if tiny else (3, 4, 6, 3))
    return PanopticPredictor(model, bf16=True, device=device), imgs, flow, \
        depth


def pad32(img):
    """The (H, W, 3) image zero-padded to multiples of 32 at the bottom
    and right, as the predictor pads it."""
    H, W = img.shape[:2]
    return np.pad(img, ((0, (-H) % 32), (0, (-W) % 32), (0, 0)))


def programs(pred, img, flow, depth):
    """{variant: a no-argument call of the dense path} on the card."""
    dev = pred.device
    x = torch.from_numpy(pad32(img)).to(dev).permute(2, 0, 1)[None]
    fl = torch.from_numpy(flow).to(dev).to(torch.float16).float()
    d = torch.from_numpy(depth).to(dev)
    feats = pred._run(x)[2]
    return {"plain": lambda: pred._run(x),
            "fusion": lambda: pred._run(x, feats, fl),
            "fusion+depth": lambda: pred._run(x, feats, fl, d)}


def copies(img, flow, depth, device):
    """{copy: a no-argument upload from the host, summed on the card}."""
    arrays = {"image uint8": pad32(img), "flow f16": flow.astype(np.float16),
              "flow f32": flow, "depth f32": depth}
    return {k: (lambda a=a: torch.from_numpy(a).to(device).sum())
            for k, a in arrays.items()}


def run(hw=(375, 1242), tiny=False, reps=8, device="cuda"):
    dev = open_device(device)
    pred, imgs, flow, depth = vps_setup(hw, tiny, dev)
    out = {"image_size": list(hw), "tiny": tiny, "programs": {},
           "copies": {}}
    for kind, calls in (("programs", programs(pred, imgs[0], flow, depth)),
                        ("copies", copies(imgs[0], flow, depth, dev))):
        for name, fn in calls.items():
            out[kind][name] = kbench.host_ms(fn, dev, reps)
    plain = out["programs"]["plain"]
    for name, ms in out["programs"].items():
        print(f"prog {name:20s} {ms:8.2f} ms   (+{ms - plain:.2f})")
    for name, ms in out["copies"].items():
        print(f"h2d+sum {name:17s} {ms:8.3f} ms")
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=375)
    p.add_argument("--width", type=int, default=1242)
    p.add_argument("--tiny", action="store_true",
                   help="one block a backbone stage (CI on the CPU)")
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    out = run((args.height, args.width), args.tiny, args.reps, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
