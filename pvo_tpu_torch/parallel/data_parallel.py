"""VO training steps, on one device or data-parallel across processes
(port of :mod:`pvo_tpu.parallel.data_parallel`).

The JAX module jits one train step over a mesh: the batch sharded over
the devices, params replicated, the gradient all-reduce inserted by XLA.
Here the mesh becomes a ``torch.distributed`` process group of one
process a card (:func:`make_mesh`: ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` as ``torchrun`` sets them; NCCL on the card, gloo on the
CPU). Each rank takes its slice of the global batch (:func:`shard_batch`),
the parameters start from rank 0's (:func:`replicate`), and one explicit
all-reduce of the flattened gradients (with the loss and metrics in the
same buffer: :func:`reduce_step`) runs before each optimizer step, where
XLA puts its all-reduce. Not
``DistributedDataParallel``: the restart step sums a step's gradients
over its restart passes in a dict (``make_restart_step``), and one
reduce of that sum equals the JAX step's sum of reduced passes, with
one collective an optimizer step and no bucket hooks in the passes.
Each rank differentiates its share of the global mean loss (its local
mean over the world size, :func:`global_share`), and the collective sums
the shares' gradients (:func:`reduce_step`). The global batch must divide
by the world size: the shares add up to the global mean only for equal
local batches (the JAX mesh requires the same). Without a process
group every collective is a no-op, and the steps are the one-device
steps.

The forward takes one sample (``DroidNet.forward`` has B=1), so a step
loops over its rank's samples, takes the mean of their losses and runs
one backward and one optimizer step. :func:`spawn` runs a function in
several processes of one host (``torchrun``'s job, for the dry run, the
tests and ``chip_smoke.py``).

Numerics: training runs in float32 throughout (the JAX trainer's
``compute_dtype`` is None), with TF32 off for matmuls and cuDNN
convolutions in every process (:func:`pvo_tpu_torch.utils.device.open_device`).
The forward differentiates through the plain correlation lookup
(``corr_impl="plain"``), as the JAX trainer differentiates through its
XLA lookup: the hand-written corr kernels have no backward.

The optimizer is optax's chain ``clip_by_global_norm(clip) ->
add_decayed_weights(1e-5) -> scale_by_adam -> cosine_onecycle_schedule
(pct_start=0.01)``: ``clip_grad_norm_``, then ``torch.optim.Adam`` with
``weight_decay`` (L2 added to the gradient before Adam's moments, as
optax adds it: not AdamW), its learning rate from a ``LambdaLR`` that
computes optax's schedule (:func:`onecycle_lr`). ``OneCycleLR`` would not
do: it cycles Adam's beta1 by default and its phase boundaries differ
from optax's by a step.
"""

from __future__ import annotations

import math
import os
import socket
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.vo import losses
from pvo_tpu_torch.vo.net.droidnet import DroidNet


def onecycle_lr(step, total_steps, peak, pct_start=0.01, div_factor=25.0,
                final_div_factor=1e4):
    """optax.cosine_onecycle_schedule(total_steps, peak, pct_start) at
    ``step``: cosine from peak/div_factor up to peak over the first
    int(pct_start * total_steps) steps, then down to
    peak/(div_factor * final_div_factor) at total_steps, constant after.
    A phase of zero steps is skipped (optax gives NaN there)."""
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    values = [peak / div_factor, peak, peak / (div_factor * final_div_factor)]
    for k in range(2):
        lo, hi = bounds[k], bounds[k + 1]
        if lo <= step < hi:
            pct = (step - lo) / (hi - lo)
            start, end = values[k], values[k + 1]
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
    return values[-1] if step >= bounds[-1] else values[0]


class Optimizer:
    """Clip by global norm, L2 weight decay, Adam, the one-cycle LR: the
    JAX module's ``make_optimizer`` chain. :meth:`step` applies the
    gradients held in the parameters' ``.grad`` and clears them."""

    def __init__(self, params, lr=5e-4, total_steps=20000, clip=2.5,
                 weight_decay=1e-5):
        self.params = [p for p in params if p.requires_grad]
        self.clip = clip
        self.adam = torch.optim.Adam(self.params, lr=lr,
                                     weight_decay=weight_decay)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.adam, lambda k: onecycle_lr(k, total_steps, lr) / lr)

    def step(self):
        torch.nn.utils.clip_grad_norm_(self.params, self.clip)
        self.adam.step()
        self.sched.step()
        self.adam.zero_grad(set_to_none=True)


def make_optimizer(params, lr=5e-4, total_steps=20000, clip=2.5,
                   weight_decay=1e-5) -> Optimizer:
    """Adam + OneCycle + grad clipping (reference train.py:95-98,:292)."""
    return Optimizer(params, lr, total_steps, clip, weight_decay)


@dataclass
class Mesh:
    """This process's place in the data-parallel group: its rank, the
    world size, its card (``LOCAL_RANK``) and whether a
    ``torch.distributed`` process group is formed (without one every
    collective is a no-op)."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    distributed: bool = False


def make_mesh(device="cuda", backend=None) -> Mesh:
    """The data-parallel group of this process. Reads ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` as ``torchrun`` sets them (0, 1, 0
    without), takes card ``LOCAL_RANK`` on ``device="cuda"``, and forms
    the process group (``backend``: NCCL on the card, gloo on the CPU by
    default; rendezvous at ``MASTER_ADDR``:``MASTER_PORT``) when
    ``WORLD_SIZE`` is set. A group that cannot be formed raises; a group
    formed already is adopted. TF32 goes off in this process
    (``open_device``)."""
    from pvo_tpu_torch.utils.device import open_device
    dev = open_device(device)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local_rank}, but "
                               f"{torch.cuda.device_count()} card(s)")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method="env://", rank=rank, world_size=world)
    return Mesh(rank, world, local_rank, dev, dist.is_initialized())


def shard_batch(batch, rank, world):
    """Rank ``rank``'s slice of the global ``batch`` (leaves with a
    leading batch axis) over ``world`` ranks; the batch must divide by
    the world size."""
    n = len(next(iter(batch.values())))
    if n % world:
        raise ValueError(f"global batch {n} does not divide by world size "
                         f"{world}")
    k = n // world
    return {key: v[rank * k:(rank + 1) * k] for key, v in batch.items()}


@torch.no_grad()
def replicate(model, mesh: Mesh):
    """Broadcast rank 0's parameters and buffers to every rank (in
    place); returns the model."""
    if mesh.distributed:
        for t in model.state_dict().values():
            dist.broadcast(t, 0)
    return model


@torch.no_grad()
def reduce_step(grads, metrics, mesh: Mesh):
    """The one collective of an optimizer step: ``grads`` (a dict of the
    rank's gradients of its share of the global mean loss, see
    :func:`global_share`) summed over the ranks and ``metrics`` (a dict
    of the rank's means) averaged, in one all-reduce of the tensors
    flattened into one float32 buffer. Returns (grads, metrics), new
    dicts; without a process group the same tensors."""
    if not mesh.distributed:
        return dict(grads), dict(metrics)
    parts = [*grads.values(), *(v / mesh.world for v in metrics.values())]
    flat = torch.cat([t.detach().reshape(-1).float() for t in parts])
    dist.all_reduce(flat)
    out, i = [], 0
    for t in parts:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return (dict(zip(grads, out[:len(grads)])),
            dict(zip(metrics, out[len(grads):])))


def reduce_model_grads(model, metrics, mesh: Mesh):
    """:func:`reduce_step` on the model's ``.grad`` fields (zeros where
    none arrived), written back; returns the averaged metrics."""
    if not mesh.distributed:
        return metrics
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads, metrics = reduce_step(
        {n: p.grad if p.grad is not None else torch.zeros_like(p)
         for n, p in named}, metrics, mesh)
    for n, p in named:
        p.grad = grads[n]
    return metrics


def global_share(local_mean, mesh: Mesh):
    """The rank's share of the global batch's mean loss: its local mean
    over the world size (local batches of one size). Its gradients,
    summed over the ranks, are the global mean's, as the JAX step
    differentiates the mean over its whole sharded batch. Averaging the
    ranks' gradients of their local means instead is not the same
    function: ``GradientClip`` zeroes gradient entries above its bound,
    and it sees the cotangent's scale."""
    return local_mean / mesh.world


def restart_rng(seed, mesh: Mesh):
    """The generator of the restart draws, seeded with rank 0's ``seed``
    on every rank: every rank then runs the same restart passes (the
    JAX trainer draws them once on the host for the whole global
    batch), so the collectives pair up."""
    if mesh.distributed:
        t = torch.tensor([int(seed)], dtype=torch.int64,
                         device=mesh.device)
        dist.broadcast(t, 0)
        seed = int(t.item())
    return np.random.default_rng(seed)


def free_port():
    """A free localhost TCP port (for a rendezvous or a server)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, device, backend, share_card, threads,
               queue, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0" if share_card else str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = make_mesh(device, backend)
        queue.put((rank, fn(mesh, *args), None))
    except BaseException as e:  # handed to the launcher, then re-raised
        import traceback
        queue.put((rank, None, traceback.format_exc()))
        raise e
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world, args=(), device="cuda", backend=None, share_card=False,
          threads=None, timeout=900):
    """Run ``fn(mesh, *args)`` in ``world`` new processes of this host
    (spawned; ``fn`` a module-level function), each with its
    ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` and a free localhost port, as
    ``torchrun`` would start them; ``device``: the cards by default (and
    raises here, before any rank starts, without one), ``"cpu"`` when
    asked for; ``share_card``: every rank on card 0
    (gloo only: NCCL refuses two ranks on one card); ``threads``: torch
    threads a rank. Returns the ranks' results in rank order; a rank that
    fails, or a run past ``timeout`` seconds, raises."""
    import multiprocessing as mp
    import queue as queue_mod
    import time
    from pvo_tpu_torch.utils.device import open_device
    open_device(device)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, port, device, backend, share_card, threads, q, args))
        for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            try:
                rank, out, err = q.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout} s")
                if any(p.exitcode not in (None, 0) for p in procs) and \
                        not q.qsize():
                    dead = [p.exitcode for p in procs]
                    raise RuntimeError(f"a rank died: exit codes {dead}")
                continue
            (errors if err else results)[rank] = err or out
            if errors:
                break
        if errors:
            raise RuntimeError("rank(s) failed:\n" + "\n".join(
                f"rank {r}: {e}" for r, e in sorted(errors.items())))
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


@dataclass
class TrainState:
    model: DroidNet
    tx: Optimizer
    step: int = 0


def to_device(batch, device):
    """numpy (or torch) leaves -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device)
            for k, v in batch.items()}


def vo_loss_fn(model: DroidNet, batch, ii, jj, num_steps,
               weights: Dict[str, float], mode="sup", ph_loss=True,
               ret_est=False, remat=False):
    """Per-sample loss with the reference's mode dispatch
    (train.py:178-261): sup = geodesic + cam-flow + gt-label (+photo);
    semisup = cam-photometric + gt-label (+photo); unsup =
    cam-photometric w/ occlusion vals + self-labeled masks (+photo).
    Residual loss always applies. ``batch`` holds one sample's tensors
    (leading dim 1)."""
    out = model(batch["poses_init"], batch["images"], batch["disps_init"],
                batch["intrinsics"], ii, jj, num_steps=num_steps,
                ret_flow=ph_loss, downsample=True, remat=remat,
                corr_impl="plain")

    w = lambda k, d: weights.get(k, d)
    res, _ = losses.residual_loss(out["residuals"])
    total = w("w2", 0.01) * res
    metrics = {"res": res}

    if mode == "sup":
        geo, geo_m = losses.geodesic_loss(
            batch["poses_gt"], out["poses"], ii, jj, do_scale=False)
        camf, camf_m = losses.cam_flow_loss(
            batch["poses_gt"], batch["disps_gt_up"], out["poses"],
            out["disps_up"], batch["intrinsics_up"])
        gtl, _ = losses.gt_label_loss(
            batch["gt_masks"], batch["gt_vals"], out["masks_up"], ii)
        total = total + (w("w1", 40.0) * geo + w("w3", 0.20) * camf +
                         w("w9", 0.01) * gtl)
        metrics.update({"geo": geo, "cam_flow": camf, "gt_l": gtl,
                        **geo_m, **camf_m})

    elif mode == "semisup":
        cam_ph, cpm = losses.photo_loss_cam(
            batch["images"].float(), out["poses"], out["disps_up"],
            batch["intrinsics_up"], batch["gt_masks"])
        gtl, _ = losses.gt_label_loss(
            batch["gt_masks"], batch["gt_vals"], out["masks_up"], ii)
        total = total + w("w10", 100.0) * cam_ph + w("w9", 0.01) * gtl
        metrics.update({"cam_ph": cam_ph, "gt_l": gtl, **cpm})

    elif mode == "unsup":
        # occlusion validity masks gate the cam-photometric term
        F = batch["images"].shape[1]
        rii, rjj = losses.ring_graph(F)
        occ = losses.unsup_occ_vals(
            out["poses"], out["disps_up"], batch["intrinsics_up"], rii, rjj)
        # per-edge masks -> per-frame masks: scatter-min onto the sources
        per_frame = occ.new_ones((occ.shape[0], F) + occ.shape[2:])
        idx = torch.as_tensor(rii, device=occ.device).reshape(
            1, -1, 1, 1).expand_as(occ)
        per_frame = per_frame.scatter_reduce(1, idx, occ, reduce="amin")
        cam_ph, cpm = losses.photo_loss_cam(
            batch["images"].float(), out["poses"], out["disps_up"],
            batch["intrinsics_up"], per_frame)

        # self-labeled static masks: full flow ~ camera flow at 1/8
        disps8 = out["disps_up"][-1][:, :, 3::8, 3::8]
        cam_flow, _ = projective.induced_flow(
            out["poses"][-1], disps8, batch["intrinsics"], ii, jj)
        art = losses.self_label_masks(out["flows"][-1], cam_flow)
        masks8 = [m[:, :, 3::8, 3::8] for m in out["masks_up"]]
        al, _ = losses.art_label_loss(art, masks8)
        total = total + w("w10", 100.0) * cam_ph + w("w6", 0.05) * al
        metrics.update({"cam_ph": cam_ph, "al": al, **cpm})

    if ph_loss:
        ph, phm = losses.photo_loss_full(
            batch["images"].float(), out["flows"], batch.get("gt_vals"),
            ii, jj, use_ssim=False, downsample=True)
        total = total + w("w4", 5.0) * ph
        metrics.update({"ph": ph, **phm})

    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    if ret_est:
        # last pose/disp estimates for the reference's random-restart
        # carry (train.py:264-265: Gs = poses_est[-1].detach(),
        # disp0 = disps_est[-1][:, :, 3::8, 3::8].detach())
        est = (out["poses"][-1].detach(),
               out["disps_up"][-1][:, :, 3::8, 3::8].detach())
        return total, (metrics, est)
    return total, metrics


def _batch_loss(model, batch, ii, jj, num_steps, weights, mode, ph_loss,
                remat=False, inits=None):
    """Mean loss over the batch's samples (leading dim), the metrics'
    means and, with ``inits`` = (poses_init, disps_init), the stacked
    restart estimates."""
    n = next(iter(batch.values())).shape[0]
    total, mets, ests = 0.0, [], []
    for b in range(n):
        sample = {k: v[b] for k, v in batch.items()}
        if inits is not None:
            sample["poses_init"], sample["disps_init"] = \
                inits[0][b], inits[1][b]
        loss, aux = vo_loss_fn(model, sample, ii, jj, num_steps, weights,
                               mode=mode, ph_loss=ph_loss,
                               ret_est=inits is not None, remat=remat)
        if inits is not None:
            aux, est = aux
            ests.append(est)
        total = total + loss
        mets.append(aux)
    metrics = {k: torch.stack([m[k] for m in mets]).float().mean()
               for k in mets[0]}
    est = (tuple(torch.stack(t) for t in zip(*ests)) if ests else None)
    return total / n, metrics, est


def make_train_step(model: DroidNet, tx: Optimizer, ii, jj, num_steps=8,
                    weights=None, mode="sup", ph_loss=True, remat=False,
                    mesh: Optional[Mesh] = None):
    """The train step: ``step(state, batch) -> (state, metrics)`` on a
    batch of tensors whose leaves have a leading batch axis (each sample
    with leading dim 1, as the JAX step's vmapped leaves). Under a
    ``mesh`` the batch is this rank's slice of the global batch: the
    rank differentiates its share of the global mean loss, and the
    shares' gradients are summed over the ranks (the loss and metrics
    averaged) before the optimizer step."""
    weights = weights or {}
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    mesh = mesh or Mesh()

    def step(state: TrainState, batch):
        loss, metrics, _ = _batch_loss(model, batch, ii, jj, num_steps,
                                       weights, mode, ph_loss, remat)
        global_share(loss, mesh).backward()
        metrics = reduce_model_grads(model, {"loss": loss.detach(),
                                             **metrics}, mesh)
        tx.step()
        state.step += 1
        return state, metrics

    return step


def _grads(model):
    """{name: grad} of the model's parameters (zeros where none
    arrived), the ``.grad`` fields cleared."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return out


def make_restart_step(model: DroidNet, tx: Optimizer, ii, jj, num_steps=8,
                      weights=None, mode="sup", ph_loss=True, remat=False,
                      mesh: Optional[Mesh] = None):
    """The reference's restart semantics (train.py:150-265): each
    restart pass re-runs the model from the LAST pose/disp estimates and
    its loss gradient ACCUMULATES; clip + optimizer step apply once per
    outer step.

    Returns (pass_fn, apply_fn, acc_fn):
      pass_fn(batch, poses_init, disps_init) ->
        (loss, metrics, grads, (poses_last, disps8_last)), grads a
        {parameter name: tensor} dict, the estimates detached
      acc_fn(acc_grads, grads) -> summed grads
      apply_fn(state, grads, metrics=None) -> the state after one
        optimizer step

    Under a ``mesh`` the passes see this rank's slice of the global
    batch and differentiate its share of the global mean
    (:func:`global_share`; the returned loss is the local mean), and
    ``apply_fn`` sums the shares' gradients over the ranks first, in one
    collective with ``metrics`` (a dict of tensors, replaced in place by
    their means over the ranks); every rank must run the same passes
    (:func:`restart_rng`).
    """
    weights = weights or {}
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    mesh = mesh or Mesh()

    def pass_fn(batch, poses_init, disps_init):
        loss, metrics, est = _batch_loss(
            model, batch, ii, jj, num_steps, weights, mode, ph_loss,
            remat, inits=(poses_init, disps_init))
        global_share(loss, mesh).backward()
        return loss.detach(), metrics, _grads(model), est

    def acc_fn(acc, grads):
        return {k: acc[k] + grads[k] for k in acc}

    def apply_fn(state: TrainState, grads, metrics=None):
        grads, reduced = reduce_step(grads, metrics or {}, mesh)
        if metrics is not None:
            metrics.update(reduced)
        for name, p in model.named_parameters():
            p.grad = grads[name]
        tx.step()
        state.step += 1
        return state

    return pass_fn, apply_fn, acc_fn


def make_synthetic_batch(n_dev, F=4, H=48, W=64, seed=0):
    """Tiny random batch for dry-runs and tests (numpy leaves, leading
    batch axis, then each sample's leading 1)."""
    rng = np.random.RandomState(seed)
    h, w = H // 8, W // 8
    tang = 0.05 * rng.randn(n_dev, 1, F, 6).astype(np.float32)
    poses_gt = se3.exp(torch.from_numpy(tang)).numpy()
    ident = np.zeros((n_dev, 1, F, 7), np.float32)
    ident[..., 6] = 1.0
    return {
        "images": rng.randint(0, 255, (n_dev, 1, F, H, W, 3)
                              ).astype(np.uint8),
        "poses_gt": poses_gt,
        "poses_init": ident,
        "disps_init": np.ones((n_dev, 1, F, h, w), np.float32),
        "disps_gt_up": 1.0 + 0.1 * rng.rand(
            n_dev, 1, F, H, W).astype(np.float32),
        "intrinsics": np.tile(np.array(
            [W / 8.0, W / 8.0, w / 2.0, h / 2.0], np.float32),
            (n_dev, 1, F, 1)),
        "intrinsics_up": np.tile(np.array(
            [W, W, W / 2.0, H / 2.0], np.float32), (n_dev, 1, F, 1)),
        "gt_masks": np.ones((n_dev, 1, F, H, W), np.float32),
        "gt_vals": np.ones((n_dev, 1, F, H, W), np.float32),
    }


def _dryrun_rank(mesh, num_steps, dry, model=None):
    """One train step of :func:`dryrun` on this rank's slice of a
    synthetic global batch of one sample a rank."""
    model = replicate((model or DroidNet.from_seed(0)).to(mesh.device)
                      .train(), mesh)
    F = 4
    ii, jj = [], []
    for a in range(F):
        for b in range(F):
            if a != b and abs(a - b) <= 2:
                ii.append(a)
                jj.append(b)
    tx = make_optimizer(model.parameters(), total_steps=100)
    step = make_train_step(model, tx, ii, jj, num_steps=num_steps,
                           ph_loss=not dry, mesh=mesh)
    batch = shard_batch(make_synthetic_batch(mesh.world, F=F), mesh.rank,
                        mesh.world)
    _, metrics = step(TrainState(model, tx), to_device(batch, mesh.device))
    return {k: float(v) for k, v in metrics.items()}


def dryrun(device="cuda", num_steps=2, dry=False,
           model: Optional[DroidNet] = None, world=1):
    """One train step on tiny shapes on ``device``; returns the metrics
    as floats. ``dry=True`` drops the photometric term. ``world`` > 1:
    one data-parallel step in that many spawned processes (one sample a
    rank, one card a rank on the card), rank 0's metrics: the global
    means."""
    from pvo_tpu_torch.utils.device import open_device
    dev = open_device(device)
    if world > 1:
        return spawn(_dryrun_rank, world, (num_steps, dry),
                     device=device)[0]
    return _dryrun_rank(Mesh(device=dev), num_steps, dry, model)
