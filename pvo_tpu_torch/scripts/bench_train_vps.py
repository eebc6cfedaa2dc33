"""Training-learns evidence for the VPS fusion finetune (port of
``scripts/bench_train_vps.py``), printed as ONE JSON line. Writes no
``BENCH_*.json``.

    python -m pvo_tpu_torch.scripts.bench_train_vps [--steps 150]
        [--lr 2.5e-3] [--height 64] [--width 96] [--device cpu]

The fusion step of :mod:`pvo_tpu_torch.vps.train` (only ``fusion_conv1``
moves, the reference's fusion mode) for ``--steps`` steps on one fixed
synthetic (ref, cur) pair: the 1-block Panoptic FPN at 64x96, random
weights from seed 0 (``init_weights``), images N(90, 20) from numpy seeds
0 and 1, zero flow, two GT instances of four padded, ``max_props=32``,
``pre_nms_topk=64``. Reports ``vps_fusion_train_loss_ratio`` (the loss
of the last step over the first; the JAX bench's assertion, final below
0.9 of the first, is asserted), the loss curve every 10 steps, steps/s
after the first step (host clock, synchronized at the end) and peak
memory. Runs on the card unless ``--device cpu``; there the memory field
is null.
"""

import argparse
import json
import time

import numpy as np
import torch

from pvo_tpu_torch.scripts.bench_train_vo import peak_gib, reset_peak, sync
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vps import train as T
from pvo_tpu_torch.vps.panoptic_fpn import PanopticFPN, init_weights


def fusion_batch(H, W):
    """The JAX bench's synthetic (ref, cur) pair, from numpy seeds."""
    masks = np.zeros((4, H, W), np.float32)
    masks[0, 4:20, 4:20] = 1.0
    masks[1, 6:24, 10:30] = 1.0
    image = lambda seed: (np.random.RandomState(seed).randn(1, H, W, 3) *
                          20 + 90).astype(np.float32)
    return {
        "cur_image": image(0),
        "ref_image": image(1),
        "flow": np.zeros((H, W, 2), np.float32),
        "gt_boxes": np.asarray([[4., 4., 20., 20.], [10., 6., 30., 24.],
                                [0., 0., 1., 1.], [0., 0., 1., 1.]],
                               np.float32),
        "gt_classes": np.asarray([1, 2, 0, 0], np.int32),
        "gt_valid": np.asarray([True, True, False, False]),
        "sem_labels": np.full((1, H, W), 3, np.int32),
        "gt_masks": masks,
    }


def fusion_protocol(steps=150, lr=2.5e-3, H=64, W=96, device="cuda"):
    """The protocol's JSON dict."""
    dev = open_device(device)
    model = init_weights(PanopticFPN(backbone_blocks=(1, 1, 1, 1)), 0)
    model = model.to(dev).train()
    tx = T.make_fusion_optimizer(model, lr=lr)
    step = T.make_fusion_train_step(model, tx, max_props=32,
                                    pre_nms_topk=64)
    state = T.TrainState(model, tx)
    batch = T.to_device(fusion_batch(H, W), dev)

    reset_peak(dev)
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss0 = float(metrics["loss"])
    first_s = time.perf_counter() - t0
    curve = [loss0]
    t0 = time.perf_counter()
    for k in range(1, steps):
        state, metrics = step(state, batch)
        if k % 10 == 0 or k == steps - 1:
            curve.append(metrics["loss"])
    sync(dev)
    sps = (steps - 1) / (time.perf_counter() - t0) if steps > 1 else None
    curve = [float(v) for v in curve]
    final = curve[-1]
    return {
        "metric": "vps_fusion_train_loss_ratio",
        "value": final / max(loss0, 1e-12),
        "unit": (f"final/initial loss after {steps} fusion-only steps "
                 f"@{H}x{W}"),
        "vs_baseline": None,
        "loss_initial": loss0,
        "loss_final": final,
        "steps_per_sec": sps,
        "first_step_s": first_s,
        "peak_mem_gib": peak_gib(dev),
        "loss_curve": curve,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--lr", type=float, default=2.5e-3)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = fusion_protocol(args.steps, args.lr, args.height, args.width,
                          args.device)
    print(json.dumps(out), flush=True)
    if not out["loss_final"] < 0.9 * out["loss_initial"]:
        raise SystemExit(f"fusion finetune did not reduce the loss: "
                         f"{out['loss_initial']} -> {out['loss_final']}")
    return out


if __name__ == "__main__":
    main()
