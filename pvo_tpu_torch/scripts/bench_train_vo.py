"""Training-learns evidence for the VO trainer (port of
``scripts/bench_train_vo.py``), printed as ONE JSON line. Writes no
``BENCH_*.json``.

    python -m pvo_tpu_torch.scripts.bench_train_vo [--steps 200]
        [--iters 4] [--device cpu]
    torchrun --nproc_per_node N -m pvo_tpu_torch.scripts.bench_train_vo
    python -m pvo_tpu_torch.scripts.bench_train_vo --recipe [--steps 300]

Default protocol: the train step of
:mod:`pvo_tpu_torch.parallel.data_parallel` (the code ``train_vo``
drives) for ``--steps`` steps on one fixed synthetic supervised batch
(sup, 4 iterations, 48x64, F=4, random weights from seed 0), over the
process group as the JAX bench runs it over its mesh: a global batch of
one sample a rank sharded over the ranks, the gradients summed before
each step, rank 0 printing; the loss
curve, steps/s, peak memory, a checkpoint save -> load round trip that
must restore bit-equal tensors, and the overfit canary. The JAX bench
holds its canary on the total loss (``final < 0.5 * loss0``); on untamed
random weights that curve is chaotic (a 1e-7 relative change of the
weights moves the next step's loss by a quarter): the JAX package's own
bench ends at 0.604 and 0.755 of its initial loss after 200 and 400
steps on the CPU, the port's runs from seed 0 read 0.35-3.75 (the loss
ratio, ``value``, is reported with no limit). The canary here
(``canary_ok``) is the dynamic-mask BCE (``gt_l``), a term the model can
fit: the mean of its last tenth below half the mean of its first tenth
(``gt_l_ratio < 0.5``). Over 20 steps on the CPU its tenths fall from
29.1 to 3.0e-4 in the JAX package's step (with the bench's 200-step
schedule) and from 5.4 to 5.0e-5 in the port's, and it is asserted on
runs of at least ``MIN_DEFAULT_CHECKED_STEPS`` steps.

``--recipe``: the reference's production recipe (semisup, 15 unrolled
iterations, n_frames=6, 200x400 crop, the random-restart loop with
gradient accumulation and pose/disp carry, ``remat``) on a synthetic
vkitti2 scene with GT dynamic masks, written once under
``.synth_recipe_torch/`` (:func:`synth_dataset_root`). Clips are sampled
on a background thread. It reports the flow residual's ratio (last
tenth over first tenth; must fall below 0.3), the loss's, s/step, grad
passes/s and peak memory.

The recipe's canary is asserted on runs of at least 100 steps (a
shorter run is a smoke run and reports it). Runs on the card unless
``--device cpu``; on the CPU the memory fields are null.
"""

import argparse
import contextlib
import json
import os
import os.path as osp
import queue
import tempfile
import threading
import time

import numpy as np
import torch

from pvo_tpu_torch.parallel import data_parallel as dp
from pvo_tpu_torch.scripts.train_vo import restart_passes, ring_edges
from pvo_tpu_torch.utils import checkpoint
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vo.net.droidnet import DroidNet

RECIPE_ROOT = ".synth_recipe_torch"
RECIPE_CROP = (200, 400)
# the curve keys kept in the recipe's JSON line
RECIPE_CURVES = ("loss", "cam_ph", "gt_l", "res", "ph")
# runs shorter than these report the canary without asserting it: the
# recipe's, and the default protocol's
MIN_CHECKED_STEPS = 100
MIN_DEFAULT_CHECKED_STEPS = 20


def tenth_means(curve):
    """Mean of the first and of the last tenth (at least one value)."""
    k = max(len(curve) // 10, 1)
    return float(np.mean(curve[:k])), float(np.mean(curve[-k:]))


def peak_gib(dev):
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def checkpoint_roundtrip(model):
    """Save the model's state dict through utils.checkpoint, load it
    back: True when every tensor is bit-equal."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, sd)
        back = checkpoint.load(d)
    return sd.keys() == back.keys() and all(
        torch.equal(sd[k], back[k]) for k in sd)


def default_protocol(steps=200, iters=4, lr=5e-4, mode="sup", device="cuda",
                     model=None, mesh=None, batch=None):
    """The default protocol; returns its JSON dict. ``model``: the
    weights to train (default: random from seed 0); ``mesh``: the
    data-parallel group (default: this process alone, on ``device``);
    ``batch``: the global batch (default: one sample a rank)."""
    mesh = mesh or dp.Mesh(device=open_device(device))
    dev = mesh.device
    F = 4
    ii, jj = dp.losses.ring_graph(F)
    model = dp.replicate((model or DroidNet.from_seed(0)).to(dev).train(),
                         mesh)
    tx = dp.make_optimizer(model.parameters(), lr, total_steps=steps)
    step_fn = dp.make_train_step(model, tx, ii, jj, num_steps=iters,
                                 mode=mode, mesh=mesh)
    state = dp.TrainState(model, tx)
    batch = dp.to_device(dp.shard_batch(dp.make_synthetic_batch(
        batch or mesh.world, F=F, H=48, W=64, seed=0), mesh.rank,
        mesh.world), dev)

    reset_peak(dev)
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    curve, mask_bce = [metrics["loss"]], [metrics["gt_l"]]
    sync(dev)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(1, steps):
        state, metrics = step_fn(state, batch)
        curve.append(metrics["loss"])
        mask_bce.append(metrics["gt_l"])
    sync(dev)
    sps = (steps - 1) / (time.perf_counter() - t0) if steps > 1 else None
    curve = [float(v) for v in curve]
    first, last = tenth_means(curve)
    bce_first, bce_last = tenth_means([float(v) for v in mask_bce])
    ckpt_ok = checkpoint_roundtrip(model)
    return {
        "metric": "vo_train_loss_ratio",
        "value": last / max(first, 1e-12),
        "unit": (f"mean(last 10%)/mean(first 10%) loss over {steps} steps "
                 f"({mode}, {iters} iters, 48x64xF4)"),
        "vs_baseline": None,
        "loss_initial": curve[0],
        "loss_final": curve[-1],
        "loss_first10pct": first,
        "loss_last10pct": last,
        "canary_ok": bce_last < 0.5 * bce_first,
        "gt_l_ratio": bce_last / max(bce_first, 1e-12),
        "gt_l_first10pct": bce_first,
        "gt_l_last10pct": bce_last,
        "steps_per_sec": sps,
        "first_step_s": first_s,
        "peak_mem_gib": peak_gib(dev),
        "ckpt_roundtrip_ok": bool(ckpt_ok),
        "loss_curve": curve,
        "world": mesh.world,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def synth_dataset_root(root=RECIPE_ROOT, device="cuda", n_frames=40):
    """A synthetic vkitti2-format scene with GT dynamic masks under
    ``root`` (written once: a ``.done`` marker), for the recipe: the
    photometric terms mean nothing on random pixels."""
    from pvo_tpu_torch.data.synth_scene import write_synth_scene
    from pvo_tpu_torch.scripts.prepare_vkitti import generate_dynamic_masks

    root = osp.abspath(root)
    marker = osp.join(root, ".done")
    if not osp.exists(marker):
        write_synth_scene(root, scene="Scene02", views=("clone",),
                          n_frames=n_frames, workers=os.cpu_count() or 1)
        generate_dynamic_masks(osp.join(root, "Scene02", "clone"),
                               device=device)
        with open(marker, "w") as fh:
            fh.write("ok")
    return root


@contextlib.contextmanager
def clip_feeder(db, depth=4):
    """Sample ``db``'s clips on a background thread (host decode does not
    serialize with the device step); yields ``next_batch()``, a batch of
    one clip as numpy leaves (leading 1). The thread stops on exit."""
    q = queue.Queue(maxsize=depth)
    stop = threading.Event()
    failed = []

    def feed():
        try:
            while not stop.is_set():
                clip = db.sample_clip()
                batch = {k: v[None] for k, v in clip.items()
                         if k != "segments"}
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        pass
        except Exception as e:  # handed to the consumer
            failed.append(e)
            stop.set()

    def next_batch():
        while True:
            if failed:
                raise failed[0]
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                pass

    thread = threading.Thread(target=feed, daemon=True)
    thread.start()
    try:
        yield next_batch
    finally:
        stop.set()
        thread.join(timeout=60)


def recipe_trainer(dev, iters=15, n_frames=6, total_steps=200, lr=5e-4,
                   remat=True, seed=0, model=None, mesh=None):
    """(model, pass_fn, apply_fn, acc_fn, state) of the recipe: semisup,
    ring edges, the restart step (over ``mesh``'s group if given)."""
    model = (model or DroidNet.from_seed(seed)).to(dev).train()
    ii, jj = ring_edges(n_frames)
    tx = dp.make_optimizer(model.parameters(), lr, total_steps=total_steps)
    pass_fn, apply_fn, acc_fn = dp.make_restart_step(
        model, tx, ii, jj, num_steps=iters, mode="semisup", remat=remat,
        mesh=mesh)
    return model, pass_fn, apply_fn, acc_fn, dp.TrainState(model, tx)


def recipe_db(root, n_frames=6):
    from pvo_tpu_torch.data.vkitti2 import VKitti2Dataset
    return VKitti2Dataset(root, "train", n_frames=n_frames, mode="semisup",
                          crop_size=RECIPE_CROP,
                          cache_dir=osp.join(root, ".cache_pvo"))


def run_recipe(next_batch, trainer, steps, dev, rng, check_grads=False,
               log_every=10):
    """``steps`` outer steps of the restart loop. Returns (curves, grad
    passes of each step, seconds of the first step, seconds of the
    rest). With ``check_grads`` every accumulated gradient must be
    finite."""
    _, pass_fn, apply_fn, acc_fn, state = trainer
    curves, passes = {}, []
    t0 = time.perf_counter()
    t_first = None
    for step in range(steps):
        batch = dp.to_device(next_batch(), dev)
        loss, metrics, grads, n = restart_passes(pass_fn, acc_fn, batch,
                                                 rng)
        passes.append(n)
        if check_grads:
            bad = [k for k, g in grads.items()
                   if not bool(torch.isfinite(g).all())]
            if bad:
                raise FloatingPointError(f"step {step}: non-finite "
                                         f"gradients in {bad[:5]}")
        state = apply_fn(state, grads)
        rec = {"loss": loss, **metrics}
        for k, v in rec.items():
            curves.setdefault(k, []).append(v)
        if step == 0:
            sync(dev)
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
        if log_every and step % log_every == 0:
            print(f"step {step}: " + " ".join(
                f"{k}={float(v):.2f}" for k, v in sorted(rec.items())
                if k in RECIPE_CURVES), flush=True)
    sync(dev)
    curves = {k: [float(v) for v in c] for k, c in curves.items()}
    return curves, passes, t_first, time.perf_counter() - t0


def recipe(steps=300, iters=15, n_frames=6, lr=5e-4, device="cuda"):
    """The recipe's JSON dict."""
    dev = open_device(device)
    db = recipe_db(synth_dataset_root(device=device), n_frames)
    trainer = recipe_trainer(dev, iters, n_frames, steps, lr)
    reset_peak(dev)
    with clip_feeder(db) as next_batch:
        curves, passes, t_first, t_rest = run_recipe(
            next_batch, trainer, steps, dev, np.random.default_rng(7))
    sps = (steps - 1) / t_rest if steps > 1 else None
    pps = sum(passes[1:]) / t_rest if steps > 1 else None
    first, last = tenth_means(curves["loss"])
    rf, rl = tenth_means(curves["res"])
    return {
        "metric": "vo_train_recipe_res_ratio",
        "value": rl / max(rf, 1e-12),
        "loss_ratio": last / max(first, 1e-12),
        "res_first10pct": rf,
        "res_last10pct": rl,
        "unit": (f"mean(last 10%)/mean(first 10%) flow residual over "
                 f"{steps} steps (semisup, {iters} iters, "
                 f"n_frames={n_frames}, {RECIPE_CROP[0]}x{RECIPE_CROP[1]} "
                 "crop, restart loop, remat, synthetic scene)"),
        "vs_baseline": None,
        "loss_first10pct": first,
        "loss_last10pct": last,
        "canary_ok": rl < 0.3 * rf and last < first,
        "steps_per_sec": sps,
        "s_per_step": None if sps is None else 1.0 / sps,
        "grad_passes_per_sec": pps,
        "n_grad_passes": sum(passes),
        "first_step_s": t_first,
        "peak_mem_gib": peak_gib(dev),
        "curves": {k: v for k, v in curves.items()
                   if k in RECIPE_CURVES + ("1px",)},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=None,
                   help="default 200, with --recipe 300")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--mode", default="sup")
    p.add_argument("--n_frames", type=int, default=6)
    p.add_argument("--recipe", action="store_true",
                   help="reference production recipe: semisup, 15 "
                        "iters, n_frames=6, 200x400, restart loop")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.recipe:
        steps = args.steps or 300
        out = recipe(steps, max(args.iters, 15), args.n_frames, args.lr,
                     args.device)
    else:
        steps = args.steps or 200
        mesh = dp.make_mesh(args.device)
        out = default_protocol(steps, args.iters, args.lr, args.mode,
                               mesh=mesh)
        if mesh.rank:
            return out
    print(json.dumps(out), flush=True)
    if args.recipe and steps >= MIN_CHECKED_STEPS and not out["canary_ok"]:
        raise SystemExit(f"the flow residual did not fall: {out['unit']}")
    if not args.recipe and not out["ckpt_roundtrip_ok"]:
        raise SystemExit("checkpoint round trip differs")
    if (not args.recipe and steps >= MIN_DEFAULT_CHECKED_STEPS
            and not out["canary_ok"]):
        raise SystemExit(f"the dynamic-mask BCE did not fall: gt_l ratio "
                         f"{out['gt_l_ratio']:.4g} over {steps} steps")
    return out


if __name__ == "__main__":
    main()
