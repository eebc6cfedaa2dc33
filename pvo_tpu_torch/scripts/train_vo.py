"""VO training CLI (port of ``scripts/train_vo.py``; reference
VO_Module/train.py), on one card or data-parallel over several.

    python -m pvo_tpu_torch.scripts.train_vo --datapath <vkitti2 root> \
        [--mode semisup] [--iters 15] [--n_frames 6] [--clip 2.5] \
        [--batch 1] [--steps 20000] [--ckpt STEP|file.pth] \
        [--crop_size 200 400] [--device cpu]
    torchrun --nproc_per_node N -m pvo_tpu_torch.scripts.train_vo ...

The sup/semisup/unsup loss modes of :mod:`pvo_tpu_torch.vo.losses`, a
fixed ring edge list, the reference's random-restart inner loop (each
pass restarts from the last estimates and its gradient accumulates; one
optimizer step an outer step), OneCycle Adam with gradient clipping,
``remat`` when ``--iters`` > 8, a checkpoint every ``--ckpt_every``
steps under ``checkpoints/<name>`` and the running-mean logger. Runs on
the card unless ``--device cpu``. ``--ckpt`` restores a step of
``checkpoints/<name>``, or a reference-format ``.pth`` file.

Under ``torchrun`` each process trains on one card (NCCL; gloo on the
CPU) over the process group of :func:`pvo_tpu_torch.parallel.
data_parallel.make_mesh`: ``--batch`` is the global batch and must divide
by the world size; each rank samples its own clips (the dataset's
generator seeded by its rank), starts from rank 0's weights, draws the
restart passes from rank 0's seed (every rank runs the same passes) and
averages the summed gradients over the ranks before each optimizer
step. Rank 0 logs, writes the checkpoints and ends with one JSON line:
steps, grad passes, the last loss (the global mean), the checkpoint,
the device.
"""

import argparse
import json
import os
import os.path as osp

import numpy as np

from pvo_tpu_torch.data.vkitti2 import VKitti2Dataset
from pvo_tpu_torch.parallel import data_parallel as dp
from pvo_tpu_torch.utils import checkpoint
from pvo_tpu_torch.utils.logger import Logger
from pvo_tpu_torch.vo.net.droidnet import DroidNet

RESTART_PROB = 0.2  # reference train.py random-restart inner loop
# the restart draws' seed (rank 0's, on every rank) and the dataset's
# seed (plus the rank)
RESTART_SEED, DATA_SEED = 12345, 1234


def ring_edges(n, r=2):
    ii, jj = [], []
    for a in range(n):
        for b in range(n):
            if a != b and abs(a - b) <= r:
                ii.append(a)
                jj.append(b)
    return np.asarray(ii), np.asarray(jj)


def restart_passes(pass_fn, acc_fn, batch, rng):
    """One outer step's passes: always one, then another while
    ``rng.random() < RESTART_PROB``, each from the last estimates.
    Returns (loss, metrics, summed grads, number of passes)."""
    pi, di = batch["poses_init"], batch["disps_init"]
    loss, metrics, grads, (pi, di) = pass_fn(batch, pi, di)
    n = 1
    r = rng.random()
    while r < RESTART_PROB:
        r = rng.random()
        loss, metrics, g2, (pi, di) = pass_fn(batch, pi, di)
        grads = acc_fn(grads, g2)
        n += 1
    return loss, metrics, grads, n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", default="vkitti2_dy_train")
    p.add_argument("--datapath", default="datasets/Virtual_KITTI2")
    p.add_argument("--mode", default="semisup",
                   choices=["sup", "semisup", "unsup"])
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--iters", type=int, default=15)
    p.add_argument("--n_frames", type=int, default=6)
    p.add_argument("--clip", type=float, default=2.5)
    p.add_argument("--batch", type=int, default=1,
                   help="clips per step over all ranks (the global batch)")
    p.add_argument("--crop_size", type=int, nargs=2, default=(200, 400))
    p.add_argument("--ckpt", default=None)
    p.add_argument("--ckpt_every", type=int, default=2000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    mesh = dp.make_mesh(args.device)
    if args.batch % mesh.world:
        raise ValueError(f"--batch {args.batch} does not divide by the "
                         f"world size {mesh.world}")
    dev, main_rank = mesh.device, mesh.rank == 0
    db = VKitti2Dataset(args.datapath, "train", n_frames=args.n_frames,
                        mode=args.mode, crop_size=args.crop_size,
                        seed=DATA_SEED + mesh.rank)
    ckpt_dir = osp.abspath(f"checkpoints/{args.name}")

    model = DroidNet.from_seed(0)
    if args.ckpt and osp.isfile(args.ckpt):
        from pvo_tpu_torch.utils.convert import load_droidnet_torch
        model = load_droidnet_torch(args.ckpt)
    elif args.ckpt:
        model = checkpoint.load(ckpt_dir, int(args.ckpt), template=model)
    model = dp.replicate(model.to(dev).train(), mesh)

    # fixed ring topology: the covis graph drives CLIP sampling (in the
    # dataset); the edge list stays the same every step
    ii, jj = ring_edges(args.n_frames)
    tx = dp.make_optimizer(model.parameters(), args.lr, args.steps,
                           args.clip)
    pass_fn, apply_fn, acc_fn = dp.make_restart_step(
        model, tx, ii, jj, num_steps=args.iters, mode=args.mode,
        remat=args.iters > 8, mesh=mesh)
    state = dp.TrainState(model, tx)

    sample = db.sample_clip()
    logger = (Logger(args.name, log_every=args.log_every) if main_rank
              else None)
    rng = dp.restart_rng(RESTART_SEED, mesh)
    n_passes, loss = 0, None
    for step in range(args.steps):
        clips = [db.sample_clip() for _ in range(args.batch // mesh.world)]
        batch = dp.to_device({k: np.stack([c[k][0] for c in clips])[:, None]
                              for k in sample if k != "segments"}, dev)
        loss, metrics, grads, n = restart_passes(pass_fn, acc_fn, batch,
                                                 rng)
        metrics = {"loss": loss, **metrics}
        state = apply_fn(state, grads, metrics)
        loss = metrics.pop("loss")
        n_passes += n
        if main_rank:
            logger.push({k: float(v) for k, v in metrics.items()})
            if (step + 1) % args.ckpt_every == 0:
                checkpoint.save(ckpt_dir, step + 1, model)
    out = {"steps": args.steps, "grad_passes": n_passes,
           "loss_last": None if loss is None else float(loss),
           "checkpoint": None, "device": str(dev)}
    if main_rank:
        out["checkpoint"] = os.path.relpath(
            checkpoint.save(ckpt_dir, args.steps, model))
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
