"""VPS training CLI (port of ``scripts/train_vps.py``; reference
VPS_Module/tools/train_net.py:184-194), on one card or data-parallel over
several.

    python -m pvo_tpu_torch.scripts.train_vps --datapath <vkitti root> \
        [--dataset vkitti_511_train] [--mode full|fusion] \
        [--config cfg.yaml] [--lr LR] [--max_iter N] \
        [--weights panFPN.pth | <checkpoint dir>] [--out runs/vps] \
        [--ckpt_every N] [--log_every 20] [--max_instances 32] \
        [--shared_data shared_data] [--device cpu] [--tiny] [--scale 0.25]

Trains Panoptic FPN on a prepared vkitti tree (``prepare_vkitti``
writes the panoptic ground truth and the 5:1:1 split) in the reference's
two modes: ``full`` (every head learns, detectron2's solver) and
``fusion`` (only ``fusion_conv1`` moves, on (previous, current) frame
pairs with the exported flow under ``<shared_data>/full_flow``; a frame
without a flow file is paired with zero flow, as the JAX CLI does). A
sample is padded to a multiple of 32 (detectron2's ImageList; the JAX
CLI does not pad, fault J6). ``--weights``: a detectron2 ``.pth`` (or
``.pkl``) file, or a directory of the port's own checkpoints (its
latest step). A checkpoint (the model's state dict,
``utils/checkpoint.py``) is written every ``--ckpt_every`` iterations
and at the end, as ``<out>/<iteration:06d>.pth``. Runs on the card
unless ``--device cpu``; ``--tiny`` (1-block backbone, 64 proposals of
128 a level before NMS, as the JAX package's tests train) and
``--scale`` (frames and targets resized) make a run small enough for the
CPU.

Under ``torchrun --nproc_per_node N`` the full mode trains over the
process group (one card a process, NCCL; gloo on the CPU):
``--batch`` is the global batch (default 1) and must divide by the
world size; every rank draws the same records and takes its slice, and
the step (``make_full_train_step_dp``) averages the gradients over the
ranks. The fusion finetune trains one pair a step in one process. Rank 0
logs, writes the checkpoints and ends with one JSON line: iterations,
the last loss (the global mean), the checkpoint, the world size.
"""

import argparse
import json
import os
import os.path as osp
import time

import numpy as np
import torch

from pvo_tpu_torch.scripts.initial_segmentation import load_model
from pvo_tpu_torch.utils import checkpoint
from pvo_tpu_torch.utils.logger import Logger
from pvo_tpu_torch.vps import datasets as D
from pvo_tpu_torch.vps import train as T
from pvo_tpu_torch.vps.config import get_cfg

# the proposals of --tiny (tests/test_vps_train.py's loss settings)
TINY_LOSS_KW = dict(max_props=64, pre_nms_topk=128)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", default="datasets/Virtual_KITTI2")
    p.add_argument("--dataset", default="vkitti_511_train")
    p.add_argument("--mode", default="full", choices=["full", "fusion"])
    p.add_argument("--config", default=None,
                   help="yacs yaml overriding solver defaults")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--max_iter", type=int, default=None)
    p.add_argument("--weights", default=None,
                   help="detectron2 .pth/.pkl, or a checkpoint directory")
    p.add_argument("--out", default="runs/vps")
    p.add_argument("--ckpt_every", type=int, default=None)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--max_instances", type=int, default=32)
    p.add_argument("--shared_data", default="shared_data")
    p.add_argument("--batch", type=int, default=1,
                   help="samples a step over all ranks (full mode)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="1-block backbone, 64 proposals (CI on CPU)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="resize factor of the frames and their targets")
    return p.parse_args(argv)


def scale_sample(sample, scale):
    """Resize a training sample (numpy, the JAX layout) by ``scale``:
    images bilinear, labels and masks nearest, boxes and flow scaled."""
    import cv2
    if scale == 1.0:
        return sample
    H, W = sample["image"].shape[1:3]
    size = (max(int(round(W * scale)), 1), max(int(round(H * scale)), 1))

    def resize(a, nearest=False):
        return cv2.resize(a, size, interpolation=cv2.INTER_NEAREST
                          if nearest else cv2.INTER_LINEAR)

    out = dict(sample)
    for k in ("image", "ref_image"):
        if k in sample:
            out[k] = resize(sample[k][0])[None]
    out["sem_labels"] = resize(sample["sem_labels"][0].astype(np.uint8),
                               True)[None].astype(np.int32)
    out["gt_masks"] = np.stack([resize(m, True) for m in
                                sample["gt_masks"]]).astype(np.float32)
    out["gt_boxes"] = sample["gt_boxes"] * np.float32(scale)
    if "flow" in sample:
        out["flow"] = resize(sample["flow"]) * np.float32(scale)
    return out


def load_weights(path, tiny):
    """The model of ``--weights``: a detectron2 file, or the latest
    checkpoint of a directory; random weights from seed 0 without."""
    if path and osp.isdir(path):
        model = checkpoint.load(path, template=load_model(None, tiny))
        if model is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        return model
    return load_model(path, tiny)


def fusion_sample(sample):
    """A sample as the fusion step reads it: (ref, cur) and the flow,
    zero where the record has no flow file (as the JAX CLI pairs it)."""
    H, W = sample["image"].shape[1:3]
    out = {k: sample[k] for k in ("gt_boxes", "gt_classes", "gt_valid",
                                  "sem_labels", "gt_masks")}
    out["cur_image"] = sample["image"]
    out["ref_image"] = sample.get("ref_image", sample["image"])
    out["flow"] = sample.get("flow", np.zeros((H, W, 2), np.float32))
    return out


def main(argv=None):
    args = parse_args(argv)
    from pvo_tpu_torch.parallel import data_parallel as dp

    mesh = dp.make_mesh(args.device)
    if args.batch % mesh.world:
        raise ValueError(f"--batch {args.batch} does not divide by the "
                         f"world size {mesh.world}")
    if args.mode == "fusion" and args.batch * mesh.world > 1:
        raise ValueError("the fusion finetune trains one pair a step in "
                         "one process")
    dev, main_rank = mesh.device, mesh.rank == 0

    cfg = get_cfg()
    if args.config:
        cfg.merge_from_file(args.config)
    lr = args.lr if args.lr is not None else cfg.SOLVER.BASE_LR
    max_iter = (args.max_iter if args.max_iter is not None
                else cfg.SOLVER.MAX_ITER)
    ckpt_every = (args.ckpt_every if args.ckpt_every is not None
                  else cfg.SOLVER.CHECKPOINT_PERIOD)

    catalog = D.register_vkitti(D.Catalog(), args.datapath, args.shared_data)
    records = catalog.get(args.dataset)
    if args.mode == "fusion":
        records = [r for r in records if r.get("ref_file_name")]
    if not records:
        raise SystemExit(f"no records in {args.dataset}")
    if main_rank:
        print(f"{len(records)} training records from {args.dataset}",
              flush=True)

    model = dp.replicate(load_weights(args.weights, args.tiny).to(dev)
                         .train(), mesh)
    loss_kw = TINY_LOSS_KW if args.tiny else {}
    if args.mode == "fusion":
        tx = T.make_fusion_optimizer(model, lr=lr)
        step = T.make_fusion_train_step(model, tx, **loss_kw)
    else:
        tx = T.make_solver(model, base_lr=lr, max_iter=max_iter)
        step = T.make_full_train_step_dp(model, tx, mesh, **loss_kw)
    state = T.TrainState(model, tx)

    logger = (Logger("train_vps", log_every=args.log_every, logdir=args.out)
              if main_rank else None)
    rng = np.random.RandomState(0)
    local = args.batch // mesh.world
    t0 = time.time()
    path = None
    for it in range(max_iter):
        # the same draws on every rank: the global batch's records
        picks = [records[rng.randint(len(records))]
                 for _ in range(args.batch)]
        samples = [T.to_device(prep_sample(rec, args), dev) for rec in
                   picks[mesh.rank * local:(mesh.rank + 1) * local]]
        if args.mode == "fusion":
            batch = samples[0]
        else:
            batch = {k: torch.stack([s[k] for s in samples])
                     for k in samples[0]}
        state, metrics = step(state, batch)
        if not main_rank:
            continue
        logger.push({k: float(v) for k, v in metrics.items()})
        if (it + 1) % args.log_every == 0:
            dt = (time.time() - t0) / args.log_every
            print(f"iter {it + 1}/{max_iter}  "
                  f"loss {float(metrics['loss']):.4f}  {dt:.2f}s/it",
                  flush=True)
            t0 = time.time()
        if (it + 1) % ckpt_every == 0 or it + 1 == max_iter:
            path = checkpoint.save(args.out, it + 1, model)
            print(f"checkpoint @ {it + 1} -> {path}", flush=True)
    out = {"iterations": max_iter,
           "loss_last": float(metrics["loss"]) if max_iter else None,
           "checkpoint": path and os.path.relpath(path), "device": str(dev),
           "world": mesh.world}
    if main_rank:
        print(json.dumps(out), flush=True)
    return out


def prep_sample(rec, args):
    """A record's training sample (numpy, the JAX layout), scaled, padded
    to 32 and, in the fusion mode, paired with its reference frame."""
    sample = D.pad_to_divisor(scale_sample(
        D.train_sample_mapper(rec, max_instances=args.max_instances),
        args.scale))
    return fusion_sample(sample) if args.mode == "fusion" else sample


if __name__ == "__main__":
    main()
