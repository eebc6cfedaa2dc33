"""VPS training: the fusion-conv finetune and the full-model step, on one
device or data-parallel across processes (port of :mod:`pvo_tpu.vps.train`).

The Panoptic FPN loss stack (RPN, Fast R-CNN, mask, semantic) on one
image, with flow-warped reference features in the fusion mode, where
only ``fusion_conv1`` moves (the reference's fusion mode,
panoptic_fpn.py:75-100, freezes every other parameter); and detectron2's
default solver for the full model.

Numerics: f32 throughout with TF32 off for matmuls and cuDNN
convolutions (:func:`pvo_tpu_torch.utils.device.open_device`), as the
JAX package trains; the forward is the model's own modules, differentiated
(the predictor's path is ``no_grad``). Proposals are detached and their
NMS is the port's host sweep (:func:`pvo_tpu_torch.vps.ops.nms`),
outside the graph. The backbone's ``FrozenBN`` statistics are buffers
and never move: the JAX package declares them parameters and its solver
trains them (fault J5, not copied).

The full step (``make_full_train_step_dp``; ``make_full_train_step``
is it on one device and one sample) runs over the process group of
:func:`pvo_tpu_torch.parallel.data_parallel.make_mesh`, or alone without
one: each rank differentiates its share of the global batch's mean
loss, then one all-reduce sums the gradients (and averages the loss and
metrics) before the solver's step. As the JAX step closes one key over its
vmap, every sample of a step, on every rank, draws its RPN subsample from
the same draws: ``rng_fn(step, device)`` is called afresh for each
sample.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from . import losses as L
from .panoptic_fpn import PanopticFPN, flow_warp_features
from .roi_heads import multilevel_roi_align
from .rpn import LEVELS, generate_anchors, generate_proposals

# the batch leaves that are images: (1, H, W, 3) in a sample, as the JAX
# package lays them out, (1, 3, H, W) on the device
IMAGE_KEYS = ("image", "cur_image", "ref_image")
# the rng stream of the train steps, as the JAX step's
# fold_in(PRNGKey(17), step)
RNG_STREAM = 17


@dataclass
class TrainState:
    model: PanopticFPN
    tx: object
    step: int = 0


def step_generator(step, device):
    """The RPN subsample's generator of ``step``: seeded by
    (RNG_STREAM, step), a fresh draw every step as detectron2 draws."""
    g = torch.Generator(device=device)
    g.manual_seed((RNG_STREAM << 32) + int(step))
    return g


def to_device(sample, device):
    """A sample of numpy leaves (the JAX package's layout, as
    :func:`pvo_tpu_torch.vps.datasets.train_sample_mapper` gives it) as
    tensors on ``device``, images NCHW."""
    out = {}
    for k, v in sample.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if k in IMAGE_KEYS:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[k] = t.to(device)
    return out


def panoptic_losses(model: PanopticFPN, image_bgr, feats_warp, gt_boxes,
                    gt_classes, gt_valid, sem_labels, gt_masks=None,
                    max_props=256, pre_nms_topk=1000, rng=None):
    """The loss stack of one image (detectron2's PanopticFPN training
    branch, panoptic_fpn.py:137-166; mask_head.py:21-60 for the mask
    term): RPN objectness and box regression, Fast R-CNN classification
    and class-specific box regression, semantic CE, and with ``gt_masks``
    the mask BCE on foreground proposals. Returns (total, metrics).

    image_bgr (1, 3, H, W); feats_warp: the warped reference features or
    None; gt_* padded to G, gt_masks (G, H, W); ``rng``: the RPN
    subsample's generator or priorities (:func:`losses.subsample_labels`;
    default: step 0's generator)."""
    H, W = image_bgr.shape[2:]
    if rng is None:
        rng = step_generator(0, image_bgr.device)
    feats = model.features(image_bgr)
    if feats_warp is not None:
        feats = model.fuse(feats, feats_warp)
    sem_logits = model.sem_seg_head(feats, (H, W))
    obj_logits, deltas = model.proposal_generator.rpn_head(feats)

    # RPN losses over all anchors, in the JAX package's (h, w, anchor)
    # order
    anchors = torch.cat([generate_anchors(lvl, obj_logits[lvl].shape[2:],
                                          image_bgr.device)
                         for lvl in LEVELS], 0)
    lg = torch.cat([obj_logits[lvl][0].permute(1, 2, 0).reshape(-1)
                    for lvl in LEVELS], 0)
    rg = torch.cat([deltas[lvl][0].permute(1, 2, 0).reshape(-1, 4)
                    for lvl in LEVELS], 0)
    obj_l, loc_l = L.rpn_loss(anchors, lg, rg, gt_boxes, gt_valid, rng)

    # ROI losses on the proposals: detached (detectron2's
    # find_top_rpn_proposals), the last G replaced by the GT boxes
    # (add_gt_proposals)
    with torch.no_grad():
        props, _, pvalid = generate_proposals(
            {k: v[0] for k, v in obj_logits.items()},
            {k: v[0] for k, v in deltas.items()}, (H, W),
            pre_nms_topk=pre_nms_topk, post_nms_topk=max_props)
    if not bool(torch.isfinite(props).all()):
        # a diverged model: its boxes would index outside the levels
        raise FloatingPointError("non-finite proposals")
    G = gt_boxes.shape[0]
    props = torch.cat([props[:-G], gt_boxes], 0)
    pvalid = torch.cat([pvalid[:-G], gt_valid], 0)

    heads = model.roi_heads
    pooled = multilevel_roi_align(feats, props, out_size=7)
    scores, box_deltas = heads.box_predictor(heads.box_head(pooled))
    cls_l, bloc_l, fg, best_gt = L.fast_rcnn_loss(
        props, pvalid, scores, box_deltas, gt_boxes, gt_classes, gt_valid,
        heads.num_classes)
    sem_l = L.semseg_loss(sem_logits, sem_labels)

    total = obj_l + loc_l + cls_l + bloc_l + sem_l
    metrics = {"rpn_obj": obj_l, "rpn_loc": loc_l, "cls": cls_l,
               "box_loc": bloc_l, "sem_seg": sem_l}

    if gt_masks is not None:
        K = heads.num_classes
        mlogits = heads.mask_head(multilevel_roi_align(feats, props,
                                                       out_size=14))
        tgt_cls = torch.clamp(gt_classes[best_gt].long(), 0, K - 1)
        sel = torch.gather(mlogits, 1, tgt_cls[:, None, None, None].expand(
            -1, 1, *mlogits.shape[2:]))[:, 0]
        gt28 = L.crop_and_resize_masks(gt_masks, best_gt, props)
        mask_l = L.mask_loss(sel, fg, gt28)
        total = total + mask_l
        metrics["mask"] = mask_l

    return total, {k: v.detach() for k, v in metrics.items()}


def _loss_kwargs(batch, loss_kw, rng):
    return dict(gt_masks=batch.get("gt_masks"), rng=rng, **loss_kw)


def _backward(loss, metrics, step):
    """detectron2's trainer check, then the backward: a non-finite loss
    raises ``FloatingPointError`` (one read of the loss a step; the
    proposals' NMS has already waited for the card)."""
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(
            f"loss became {float(loss)} at step {step}: "
            f"{ {k: float(v) for k, v in metrics.items()} }")
    loss.backward()


def clip_global_norm_(params, max_norm):
    """optax.clip_by_global_norm on the ``.grad`` of ``params``: scale by
    max_norm / max(norm, max_norm)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale)


class FusionOptimizer:
    """SGD with momentum on ``fusion_conv1`` alone, after a global-norm
    clip of 1.0 over that conv's gradients (the JAX package's
    ``make_fusion_optimizer``; every other parameter is frozen: its
    ``requires_grad`` is switched off here)."""

    def __init__(self, model: PanopticFPN, lr=2.5e-4, clip=1.0,
                 momentum=0.9):
        for name, p in model.named_parameters():
            p.requires_grad_(name.startswith("fusion_conv1."))
        self.params = list(model.fusion_conv1.parameters())
        self.clip = clip
        self.sgd = torch.optim.SGD(self.params, lr=lr, momentum=momentum)

    def step(self):
        clip_global_norm_(self.params, self.clip)
        self.sgd.step()
        self.sgd.zero_grad(set_to_none=True)


def make_fusion_optimizer(model, lr=2.5e-4) -> FusionOptimizer:
    return FusionOptimizer(model, lr)


def decays(name):
    """Whether the parameter ``name`` takes weight decay: detectron2
    exempts normalization parameters (WEIGHT_DECAY_NORM = 0.0), the JAX
    package's ``_decay_mask`` every leaf under a module whose name holds
    "norm"; the port's norms that are parameters are the semantic head's
    GroupNorms (``sem_seg_head.p2.0.norm.weight``)."""
    return "norm" not in name.lower()


def warmup_multistep_lr(count, base_lr, warmup_iters=1000,
                        warmup_factor=1e-3, steps=(60000, 80000),
                        gamma=0.1):
    """detectron2's WarmupMultiStepLR (linear warmup) at ``count``, as
    the JAX package's schedule computes it."""
    lr = base_lr
    for s in steps:
        if count >= s:
            lr *= gamma
    warm = warmup_factor + (1.0 - warmup_factor) * \
        min(float(count), warmup_iters) / max(warmup_iters, 1)
    return lr * warm


class Solver:
    """detectron2's default solver: SGD with momentum and weight decay
    (the norms exempt, :func:`decays`), WarmupMultiStepLR, and optionally
    a global-norm clip first (the reference ships with clipping off). The
    JAX package's ``make_solver`` chain: clip -> add_decayed_weights ->
    trace -> scale_by_schedule; ``torch.optim.SGD`` adds the decay to the
    gradient before its momentum, as optax does."""

    def __init__(self, model: PanopticFPN, base_lr=2.5e-4, max_iter=90000,
                 warmup_iters=1000, warmup_factor=1e-3,
                 steps=(60000, 80000), gamma=0.1, momentum=0.9,
                 weight_decay=1e-4, clip=None):
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.params = [p for _, p in named]
        self.clip = clip
        self.max_iter = max_iter
        groups = [{"params": [p for n, p in named if decays(n)],
                   "weight_decay": weight_decay},
                  {"params": [p for n, p in named if not decays(n)],
                   "weight_decay": 0.0}]
        self.sgd = torch.optim.SGD(groups, lr=base_lr, momentum=momentum)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.sgd, lambda k: warmup_multistep_lr(
                k, base_lr, warmup_iters, warmup_factor, steps, gamma) /
            base_lr)

    def step(self):
        if self.clip is not None:
            clip_global_norm_(self.params, self.clip)
        self.sgd.step()
        self.sched.step()
        self.sgd.zero_grad(set_to_none=True)


def make_solver(model, base_lr=2.5e-4, max_iter=90000, warmup_iters=1000,
                warmup_factor=1e-3, steps=(60000, 80000), gamma=0.1,
                momentum=0.9, weight_decay=1e-4, clip=None) -> Solver:
    return Solver(model, base_lr, max_iter, warmup_iters, warmup_factor,
                  steps, gamma, momentum, weight_decay, clip)


def make_fusion_train_step(model: PanopticFPN, tx: FusionOptimizer,
                           rng_fn: Optional[Callable] = None, **loss_kw):
    """The fusion-finetune step on a (ref, cur) pair:
    ``step(state, batch) -> (state, metrics)``.

    batch (on the device, :func:`to_device`): cur_image and ref_image
    (1, 3, H, W), flow (H, W, 2), gt_boxes (G, 4), gt_classes (G,),
    gt_valid (G,), sem_labels (1, H, W), optional gt_masks (G, H, W).
    ``rng_fn(step, device)``: the RPN subsample's generator or priorities
    of a step (default :func:`step_generator`). The reference frame's
    features are taken without a graph: no parameter they touch moves."""
    rng_fn = rng_fn or step_generator

    def step(state: TrainState, batch):
        image = batch["cur_image"]
        with torch.no_grad():
            warped = flow_warp_features(model.features(batch["ref_image"]),
                                        batch["flow"])
        loss, metrics = panoptic_losses(
            model, image, warped, batch["gt_boxes"], batch["gt_classes"],
            batch["gt_valid"], batch["sem_labels"],
            **_loss_kwargs(batch, loss_kw, rng_fn(state.step, image.device)))
        _backward(loss, metrics, state.step)
        tx.step()
        state.step += 1
        return state, {"loss": loss.detach(), **metrics}

    return step


def make_full_train_step_dp(model: PanopticFPN, tx: Solver, mesh=None,
                            rng_fn: Optional[Callable] = None, **loss_kw):
    """The full-model step (every head learns: backbone, FPN, RPN,
    box/mask heads, semantic head; the reference's train_net.py
    DefaultTrainer over the PanopticFPN losses), over a data-parallel
    ``mesh`` (:func:`pvo_tpu_torch.parallel.data_parallel.make_mesh`;
    None: this process alone): ``step(state, batch) -> (state,
    metrics)``.

    batch (on the device): this rank's samples along a leading axis,
    each sample's leaves image (1, 3, H, W), gt_boxes (G, 4), gt_classes
    (G,), gt_valid (G,), sem_labels (1, H, W), gt_masks (G, H, W).
    ``rng_fn`` as :func:`make_fusion_train_step`'s. The loss is the mean
    over the global batch (local batches of one size on every rank). A
    non-finite global loss raises ``FloatingPointError`` on every rank,
    after the backward and the all-reduce, so that no rank waits on
    another; the gradients are cleared and the solver does not step."""
    from pvo_tpu_torch.parallel.data_parallel import (Mesh, global_share,
                                                      reduce_model_grads)
    rng_fn = rng_fn or step_generator
    mesh = mesh or Mesh()

    def step(state: TrainState, batch):
        n = batch["image"].shape[0]
        total, mets = 0.0, []
        for b in range(n):
            sample = {k: v[b] for k, v in batch.items()}
            loss, metrics = panoptic_losses(
                model, sample["image"], None, sample["gt_boxes"],
                sample["gt_classes"], sample["gt_valid"],
                sample["sem_labels"], **_loss_kwargs(
                    sample, loss_kw, rng_fn(state.step,
                                            sample["image"].device)))
            total = total + loss
            mets.append(metrics)
        loss = total / n
        global_share(loss, mesh).backward()
        metrics = reduce_model_grads(
            model, {"loss": loss.detach(),
                    **{k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}}, mesh)
        if not bool(torch.isfinite(metrics["loss"])):
            model.zero_grad(set_to_none=True)
            raise FloatingPointError(
                f"loss became {float(metrics['loss'])} at step "
                f"{state.step}: { {k: float(v) for k, v in metrics.items()} }")
        tx.step()
        state.step += 1
        return state, metrics

    return step


def make_full_train_step(model: PanopticFPN, tx: Solver,
                         rng_fn: Optional[Callable] = None, **loss_kw):
    """:func:`make_full_train_step_dp` on one device, one sample a step:
    the batch's leaves without the leading axis (image (1, 3, H, W),
    ...)."""
    step = make_full_train_step_dp(model, tx, None, rng_fn, **loss_kw)

    def one(state: TrainState, batch):
        return step(state, {k: v[None] for k, v in batch.items()})

    return one


def dryrun_sample(H=64, W=96, device="cpu"):
    """The JAX ``dryrun_dp``'s sample on ``device`` (its image drawn from
    a seeded torch generator): two boxes with masks, two padded GT
    slots, semantic class 3 everywhere. H and W divide by 32."""
    g = torch.Generator().manual_seed(0)
    masks = np.zeros((4, H, W), np.float32)
    masks[0, 4:20, 4:20] = 1.0
    masks[1, 6:24, 10:30] = 1.0
    sample = {
        "image": (torch.randn((1, H, W, 3), generator=g) * 20 + 90).numpy(),
        "gt_boxes": np.asarray([[4., 4., 20., 20.], [10., 6., 30., 24.],
                                [0., 0., 1., 1.], [0., 0., 1., 1.]],
                               np.float32),
        "gt_classes": np.asarray([1, 2, 0, 0], np.int64),
        "gt_valid": np.asarray([True, True, False, False]),
        "sem_labels": np.full((1, H, W), 3, np.int64),
        "gt_masks": masks,
    }
    return to_device(sample, device)


def _dryrun_dp_rank(mesh, H, W):
    from pvo_tpu_torch.parallel.data_parallel import replicate
    from .panoptic_fpn import init_weights
    model = init_weights(PanopticFPN(backbone_blocks=(1, 1, 1, 1)), 0)
    model = replicate(model.to(mesh.device).train(), mesh)
    tx = make_solver(model, base_lr=1e-3)
    step = make_full_train_step_dp(model, tx, mesh, max_props=32,
                                   pre_nms_topk=64)
    one = dryrun_sample(H, W, mesh.device)
    batch = {k: v[None] for k, v in one.items()}
    _, metrics = step(TrainState(model, tx), batch)
    return {k: float(v) for k, v in metrics.items()}


def dryrun_dp(world=1, H=64, W=96, device="cuda"):
    """ONE data-parallel full-model step of the 1-block Panoptic FPN at
    HxW (32 proposals of 64 a level before NMS), one sample a rank, in
    ``world`` spawned processes (one card a rank on the card; in this
    process for ``world`` 1). Returns rank 0's metrics: the global
    means."""
    from pvo_tpu_torch.parallel import data_parallel as dp
    from pvo_tpu_torch.utils.device import open_device
    dev = open_device(device)
    if world > 1:
        return dp.spawn(_dryrun_dp_rank, world, (H, W), device=device)[0]
    return _dryrun_dp_rank(dp.Mesh(device=dev), H, W)
