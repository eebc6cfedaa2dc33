"""Kernel trace of the VPS dense program (port of
``scripts/trace_vps.py``): plain and fusion.

    python -m pvo_tpu_torch.scripts.trace_vps [--height 375 --width 1242]
        [--tiny] [--device cpu]

Panoptic FPN R-50 in bf16 (``profile_vps.vps_setup``: tamed weights
from seed 0, the JAX script's seeded image and flow, and a depth) at
375x1242, padded to 384x1248. Traces one frame of the dense path
(``PanopticPredictor._run``) plain and one fused with the flow and the
depth on the card (the previous frame's features), after a warm-up
call each: the kernels' device total a frame and the costliest kernels
(``kbench.breakdown``); on the CPU the host ms only. One JSON line last.
"""

from __future__ import annotations

import argparse
import json

import torch

from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.scripts.profile_vps import programs, vps_setup
from pvo_tpu_torch.utils.device import open_device


TOP = 60


@torch.no_grad()
def run(hw=(375, 1242), tiny=False, device="cuda"):
    dev = open_device(device)
    pred, imgs, flow, depth = vps_setup(hw, tiny, dev)
    progs = programs(pred, imgs[0], flow, depth)
    out = {"image_size": list(hw), "tiny": tiny}
    for name in ("plain", "fusion+depth"):
        print(f"=== {name} ===")
        res = kbench.breakdown(progs[name], dev, top=TOP, reps=1)
        if res["device_ms"] is not None:
            print(f"{name} device total {res['device_ms']:.1f} ms")
        out[name] = res
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=375)
    p.add_argument("--width", type=int, default=1242)
    p.add_argument("--tiny", action="store_true",
                   help="one block a backbone stage (CI on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    out = run((args.height, args.width), args.tiny, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
