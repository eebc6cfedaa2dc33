"""Steady-state economics of the VPS full-model train step on one device
(port of ``scripts/bench_vps_train.py``), printed as ONE JSON line.
Writes no ``BENCH_*.json``.

    python -m pvo_tpu_torch.scripts.bench_vps_train [STEPS] [--device cpu]

The full step of :mod:`pvo_tpu_torch.vps.train` (R-50 Panoptic FPN, the
RPN, box, mask and semantic losses, detectron2's solver at base lr
2.5e-4 with its 1000-iteration warmup) on ONE synthetic sample at the
padded vkitti geometry 384x1248 (375x1242 padded to the FPN's stride),
batch 1, 8 padded GT instances of which 2 are valid, random weights from
seed 0 tamed as the VPS inference benches tame them
(``benchmark_vps.tamed_model``: the residual branches' frozen-BN scales
cut, the regressions scaled down), the image N(90, 20) from numpy seed
0. The JAX bench trains untamed weights; untamed, the port's f32 step
diverges within a dozen steps (the CPU at 192x640: the loss 9.9e4, then
1.1e11 at step 11, as the random R-50's residual stream reaches ~1e4),
tamed it falls (3.7 -> 1.4 over 25 steps there). One
first step (the caches' warm-up), then ``STEPS`` (default 60) steps,
each read back as the JAX bench reads its loss. Reports
``vps_train_steps_per_sec``, ms a step, the first step's and the
model's set-up seconds, peak memory and the loss curve; asserts finite
losses and a last loss below the first, as the JAX bench does. Unlike
the JAX bench, whose solver decays every leaf, the norms take no weight
decay (detectron2's rule, as ``train_vps`` trains). Runs on the card
unless ``--device cpu``; there the memory field is null.
"""

import argparse
import json
import time

import numpy as np
import torch

from pvo_tpu_torch.scripts.bench_train_vo import peak_gib, reset_peak, sync
from pvo_tpu_torch.scripts.benchmark_vps import tamed_model
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vps import train as T

SIZE = (384, 1248)
N_GT = 8


def full_batch(H, W):
    """The JAX bench's synthetic sample (two valid instances of eight),
    the image from a numpy seed."""
    masks = np.zeros((N_GT, H, W), np.float32)
    masks[0, 40:200, 40:200] = 1.0
    masks[1, 60:240, 100:300] = 1.0
    boxes = np.tile(np.array([0., 0., 1., 1.], np.float32), (N_GT, 1))
    boxes[0] = [40., 40., 200., 200.]
    boxes[1] = [100., 60., 300., 240.]
    valid = np.zeros(N_GT, bool)
    valid[:2] = True
    classes = np.zeros(N_GT, np.int32)
    classes[:2] = [1, 2]
    return {
        "image": (np.random.RandomState(0).randn(1, H, W, 3) * 20 +
                  90).astype(np.float32),
        "gt_boxes": boxes, "gt_classes": classes, "gt_valid": valid,
        "sem_labels": np.full((1, H, W), 3, np.int32),
        "gt_masks": masks,
    }


def full_setup(device, size=SIZE, blocks=(3, 4, 6, 3), **loss_kw):
    """(step, state, batch on the device, set-up seconds) of the
    protocol."""
    dev = open_device(device)
    t0 = time.perf_counter()
    model = tamed_model(0, backbone_blocks=blocks).to(dev).train()
    tx = T.make_solver(model, base_lr=2.5e-4)
    step = T.make_full_train_step(model, tx, **loss_kw)
    batch = T.to_device(full_batch(*size), dev)
    sync(dev)
    return step, T.TrainState(model, tx), batch, time.perf_counter() - t0


def full_protocol(steps=60, device="cuda", size=SIZE, blocks=(3, 4, 6, 3),
                  **loss_kw):
    """The protocol's JSON dict; ``size`` and ``blocks`` shrink it for
    the CPU tests."""
    step, state, batch, init_s = full_setup(device, size, blocks, **loss_kw)
    dev = batch["image"].device
    reset_peak(dev)
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss0 = float(metrics["loss"])
    first_s = time.perf_counter() - t0
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    sync(dev)
    per = (time.perf_counter() - t0) / steps
    H, W = size
    return {
        "metric": "vps_train_steps_per_sec",
        "value": 1.0 / per,
        "unit": (f"steps/s @{H}x{W} bs1 full model over {steps} steps"),
        "vs_baseline": None,
        "ms_per_step": 1e3 * per,
        "init_s": init_s,
        "first_step_s": first_s,
        "first_step_loss": loss0,
        "peak_mem_gib": peak_gib(dev),
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "losses_finite": bool(np.isfinite(losses).all()),
        "loss_curve": losses[::max(1, steps // 20)] + losses[-1:],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def check(out):
    """The JAX bench's assertions: finite losses, the last below the
    first."""
    if not out["losses_finite"]:
        raise SystemExit(f"non-finite losses: {out['loss_curve']}")
    if not out["loss_last"] < out["loss_first"]:
        raise SystemExit(f"the loss did not fall: {out['loss_first']} -> "
                         f"{out['loss_last']}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("steps", type=int, nargs="?", default=60)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = full_protocol(args.steps, args.device)
    print(json.dumps(out), flush=True)
    check(out)
    return out


if __name__ == "__main__":
    main()
