"""VO training steps on one device (port of
:mod:`pvo_tpu.parallel.data_parallel`).

The JAX module jits one train step over a mesh: the batch sharded over
the devices, params replicated, the gradient all-reduce inserted by XLA.
Here the step runs on one device. Its forward takes one sample
(``DroidNet.forward`` has B=1), so a step loops over the batch's
samples, takes the mean of their losses and runs one backward and one
optimizer step. Distributed data parallel across cards, and the JAX
package's ``multihost``, are not ported yet (ROADMAP.md Queue 1).

Numerics: training runs in float32 throughout (the JAX trainer's
``compute_dtype`` is None), with TF32 off for matmuls and cuDNN
convolutions (:func:`pvo_tpu_torch.utils.device.open_device`). The
forward differentiates through the plain correlation lookup
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
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

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
                    weights=None, mode="sup", ph_loss=True, remat=False):
    """The train step: ``step(state, batch) -> (state, metrics)`` on a
    batch of tensors whose leaves have a leading batch axis (each sample
    with leading dim 1, as the JAX step's vmapped leaves)."""
    weights = weights or {}
    ii = np.asarray(ii)
    jj = np.asarray(jj)

    def step(state: TrainState, batch):
        loss, metrics, _ = _batch_loss(model, batch, ii, jj, num_steps,
                                       weights, mode, ph_loss, remat)
        loss.backward()
        tx.step()
        state.step += 1
        return state, {"loss": loss.detach(), **metrics}

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
                      weights=None, mode="sup", ph_loss=True, remat=False):
    """The reference's restart semantics (train.py:150-265): each
    restart pass re-runs the model from the LAST pose/disp estimates and
    its loss gradient ACCUMULATES; clip + optimizer step apply once per
    outer step.

    Returns (pass_fn, apply_fn, acc_fn):
      pass_fn(batch, poses_init, disps_init) ->
        (loss, metrics, grads, (poses_last, disps8_last)), grads a
        {parameter name: tensor} dict, the estimates detached
      acc_fn(acc_grads, grads) -> summed grads
      apply_fn(state, grads) -> the state after one optimizer step
    """
    weights = weights or {}
    ii = np.asarray(ii)
    jj = np.asarray(jj)

    def pass_fn(batch, poses_init, disps_init):
        loss, metrics, est = _batch_loss(
            model, batch, ii, jj, num_steps, weights, mode, ph_loss,
            remat, inits=(poses_init, disps_init))
        loss.backward()
        return loss.detach(), metrics, _grads(model), est

    def acc_fn(acc, grads):
        return {k: acc[k] + grads[k] for k in acc}

    def apply_fn(state: TrainState, grads):
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


def dryrun(device="cuda", num_steps=2, dry=False,
           model: Optional[DroidNet] = None):
    """One train step on tiny shapes on ``device``; returns the metrics
    as floats. ``dry=True`` drops the photometric term."""
    from pvo_tpu_torch.utils.device import open_device
    dev = open_device(device)
    model = (model or DroidNet.from_seed(0)).to(dev).train()
    F = 4
    ii, jj = [], []
    for a in range(F):
        for b in range(F):
            if a != b and abs(a - b) <= 2:
                ii.append(a)
                jj.append(b)
    tx = make_optimizer(model.parameters(), total_steps=100)
    step = make_train_step(model, tx, ii, jj, num_steps=num_steps,
                           ph_loss=not dry)
    _, metrics = step(TrainState(model, tx),
                      to_device(make_synthetic_batch(1, F=F), dev))
    return {k: float(v) for k, v in metrics.items()}
