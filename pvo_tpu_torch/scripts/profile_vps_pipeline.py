"""Host time of the VPS predictor's submit/result protocol, phase by
phase (port of ``scripts/profile_vps_pipeline.py``).

    python -m pvo_tpu_torch.scripts.profile_vps_pipeline [--frames 12]
        [--height 375 --width 1242] [--tiny] [--device cpu]

``profile_vps.vps_setup``'s bf16 predictor and seeded inputs, frames
submitted with one in flight (``PanopticPredictor.submit`` /
``result``, ``vps/panoptic_fpn.py``) in the JAX script's modes: plain,
fusion with the host flow, fusion with host flow and depth, and with
flow (and depth) already on the card, as the PVO loop hands them over.
Per frame, on the host clock and without synchronizing (the protocol's
own waits are the point): ``submit`` split into its flow/depth uploads
(``_upload``), its dispatch of the dense path (``_run``) and the rest
(the host's image preparation and its copy), and the blocking
``result()`` (the readbacks' wait and the host stitch); the mean over
the frames after the first two, and the frame time over all. One JSON
line last.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from pvo_tpu_torch.scripts.profile_vps import vps_setup
from pvo_tpu_torch.utils.device import open_device

IMAGES = 8


def timed_protocol(pred, imgs, label, flow, depth, frames):
    """Per-phase host ms of ``frames`` frames with one in flight."""
    acc = defaultdict(float)
    rows = defaultdict(list)
    upload, dispatch = pred._upload, pred._run

    def wrap(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            acc[name] += time.perf_counter() - t0
            return out
        return call

    pred._upload, pred._run = wrap("uploads", upload), wrap("dispatch",
                                                            dispatch)
    try:
        pred._video_id = None
        pred(imgs[0], video_id=label)
        if flow is not None:
            pred(imgs[1], video_id=label, flow=flow, depth=depth)
        pend = None
        t00 = time.perf_counter()
        for k in range(frames):
            acc.clear()
            t0 = time.perf_counter()
            nxt = pred.submit(imgs[2 + k % (len(imgs) - 2)], video_id=label,
                              flow=flow, depth=depth)
            t1 = time.perf_counter()
            if pend is not None:
                pred.result(pend)
            t2 = time.perf_counter()
            pend = nxt
            rows["submit"].append(t1 - t0)
            rows["uploads"].append(acc["uploads"])
            rows["dispatch"].append(acc["dispatch"])
            rows["prepare+image copy"].append(
                t1 - t0 - acc["uploads"] - acc["dispatch"])
            rows["result"].append(t2 - t1)
        pred.result(pend)
        total = time.perf_counter() - t00
    finally:
        pred._upload, pred._run = upload, dispatch
    out = {k: 1e3 * float(np.mean(v[2:] or v)) for k, v in rows.items()}
    out["frame"] = 1e3 * total / frames
    print(f"{label:22s} " + "  ".join(f"{k} {v:7.2f} ms"
                                      for k, v in out.items()))
    return out


def run(hw=(375, 1242), tiny=False, frames=12, device="cuda"):
    dev = open_device(device)
    pred, imgs, flow, depth = vps_setup(hw, tiny, dev, frames=IMAGES)
    fl_dev = torch.from_numpy(flow).to(dev).to(torch.float16)
    d_dev = torch.from_numpy(depth).to(dev)
    modes = (("plain", None, None), ("fusion", flow, None),
             ("fusion+depth", flow, depth), ("fusion dev-flow", fl_dev, None),
             ("fusion dev-flow+d", fl_dev, d_dev))
    out = {"image_size": list(hw), "tiny": tiny, "frames": frames,
           "modes": {label: timed_protocol(pred, imgs, label, f, d, frames)
                     for label, f, d in modes}}
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--height", type=int, default=375)
    p.add_argument("--width", type=int, default=1242)
    p.add_argument("--tiny", action="store_true",
                   help="one block a backbone stage (CI on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    out = run((args.height, args.width), args.tiny, args.frames, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
