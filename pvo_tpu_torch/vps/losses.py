"""Detection and segmentation training losses (the port's own copy of
:mod:`pvo_tpu.vps.losses`).

The detectron2 loss stack the reference trains with: RPN objectness BCE
and box regression on a random 256-anchor subsample, Fast R-CNN
classification and class-specific box regression, the mask BCE, and the
semantic cross-entropy with an ignore label. Matching and subsampling
keep the JAX package's fixed-size masked form: every anchor carries a
label and the subsample is a pair of boolean masks.

Layouts: ``semseg_loss`` takes NCHW logits (B, S, H, W) as the port's
head gives them; every other input is as the JAX function's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ops

IGNORE_LABEL = 255


def smooth_l1(x, beta=0.0):
    ax = torch.abs(x)
    if beta <= 0:
        return ax
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def match_anchors(anchors, gt_boxes, gt_valid, pos_thresh=0.7,
                  neg_thresh=0.3):
    """IoU matcher (detectron2 Matcher with allow_low_quality_matches):
    returns (matched_idx (A,), labels (A,)), labels 1 = positive,
    0 = negative, -1 = ignored."""
    iou = ops.box_iou(anchors, gt_boxes)              # (A, G)
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    best_iou, best_gt = torch.max(iou, dim=1)
    labels = torch.where(best_iou >= pos_thresh, 1,
                         torch.where(best_iou < neg_thresh, 0, -1))
    # low-quality matches: each gt's best anchor is positive
    best_anchor_per_gt = torch.max(iou, dim=0).values  # (G,)
    is_best = ((iou >= best_anchor_per_gt[None, :] - 1e-6) & (iou > 0) &
               gt_valid[None, :]).any(dim=1)
    return best_gt, torch.where(is_best, 1, labels)


def _ranks(key):
    """Each entry's position in a stable ascending sort of ``key``."""
    order = torch.argsort(key, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(key.numel(), device=key.device)
    return ranks


def subsample_labels(labels, rng, num_samples=256, pos_fraction=0.5):
    """detectron2 sampling.py subsample_labels in fixed shapes: min(#pos,
    num_samples * pos_fraction) random positives, the rest of
    ``num_samples`` random negatives. Returns (sel_pos, sel_neg).

    ``rng``: a ``torch.Generator`` on ``labels``' device, from which every
    anchor draws a uniform priority, or those priorities as a tensor
    shaped like ``labels``. An anchor is selected iff its rank among its
    class by priority is below the class quota."""
    if isinstance(rng, torch.Generator):
        r = torch.rand(labels.shape, generator=rng, device=labels.device)
    else:
        r = rng.to(labels.device, torch.float32)
    pos = labels == 1
    neg = labels == 0
    n_pos = torch.clamp(pos.sum(), max=int(num_samples * pos_fraction))
    n_neg = torch.minimum(neg.sum(), num_samples - n_pos)
    inf = torch.full_like(r, torch.inf)
    pos_rank = _ranks(torch.where(pos, r, inf))
    neg_rank = _ranks(torch.where(neg, r, inf))
    return pos & (pos_rank < n_pos), neg & (neg_rank < n_neg)


def rpn_loss(anchors, obj_logits, deltas, gt_boxes, gt_valid, rng,
             norm_count=256.0):
    """anchors (A,4), obj_logits (A,), deltas (A,4); gt_boxes (G,4)
    padded, with the gt_valid mask. Returns (objectness, localization).

    detectron2 semantics: both terms on the 256-anchor random subsample
    (<= 50% positive), normalized by 256. Summed over all ~270k anchors
    at 384x1248, the objectness term reaches ~4e6 and the first SGD step
    NaNs the parameters (the JAX package's finding)."""
    matched, labels = match_anchors(anchors, gt_boxes, gt_valid)
    sel_pos, sel_neg = subsample_labels(labels, rng)
    pos = sel_pos.to(obj_logits.dtype)
    neg = sel_neg.to(obj_logits.dtype)

    tgt = ops.encode_boxes(anchors, gt_boxes[matched])
    # where (not a product): degenerate matches give inf targets, and
    # 0 * inf = NaN would poison the sum
    loc = torch.where(pos[:, None] > 0, smooth_l1(deltas - tgt),
                      0.0).sum() / norm_count
    obj = -(pos * F.logsigmoid(obj_logits) + neg * F.logsigmoid(-obj_logits))
    return obj.sum() / norm_count, loc


def fast_rcnn_loss(proposals, prop_valid, scores, deltas, gt_boxes,
                   gt_classes, gt_valid, num_classes, fg_thresh=0.5):
    """scores (R, K+1), deltas (R, K*4); background = class K. Returns
    (classification, box regression, fg (R,), best_gt (R,))."""
    iou = ops.box_iou(proposals, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    best_iou, best_gt = torch.max(iou, dim=1)
    fg = (best_iou >= fg_thresh) & prop_valid
    tgt_cls = torch.where(fg, gt_classes[best_gt].long(), num_classes)
    n_valid = torch.clamp(prop_valid.sum(), min=1)

    logp = F.log_softmax(scores, dim=-1)
    ce = -torch.gather(logp, 1, tgt_cls[:, None])[:, 0]
    ce = torch.where(prop_valid, ce, 0.0).sum() / n_valid

    tgt_deltas = ops.encode_boxes(proposals, gt_boxes[best_gt],
                                  weights=(10.0, 10.0, 5.0, 5.0))
    d = deltas.reshape(-1, num_classes, 4)
    sel = torch.clamp(tgt_cls, 0, num_classes - 1)
    d_sel = torch.gather(d, 1, sel[:, None, None].expand(-1, 1, 4))[:, 0]
    loc = torch.where(fg[:, None], smooth_l1(d_sel - tgt_deltas),
                      0.0).sum() / n_valid
    return ce, loc, fg, best_gt


def crop_and_resize_masks(gt_masks, gt_idx, boxes, out_size=28,
                          samples=2):
    """Each proposal's matched GT bitmask cropped to its box at
    out_size x out_size (detectron2 BitMasks.crop_and_resize: ROIAlign
    aligned=True on the mask, then >= 0.5 binarization as in
    mask_rcnn_loss).

    gt_masks (G, H, W) {0,1}; gt_idx (R,) the matched gt of each
    proposal; boxes (R, 4) image coords. Returns (R, out, out) {0,1}."""
    G, H, W = gt_masks.shape
    R = boxes.shape[0]
    dev = boxes.device
    b = boxes.float() - 0.5                       # aligned=True shift
    x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    bw = (x1 - x0) / out_size
    bh = (y1 - y0) / out_size

    ix = torch.arange(out_size, dtype=torch.float32, device=dev)
    sx = (torch.arange(samples, dtype=torch.float32, device=dev) + 0.5) / \
        samples
    grid = ix[None, :, None] + sx[None, None, :]
    gx = (x0[:, None, None] + grid * bw[:, None, None]).reshape(R, -1)
    gy = (y0[:, None, None] + grid * bh[:, None, None]).reshape(R, -1)

    flat = gt_masks.reshape(G, H * W).float()
    ys = gy[:, :, None]                           # (R, os, 1)
    xs = gx[:, None, :]                           # (R, 1, os)
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    fy = ys - y0f
    fx = xs - x0f
    gi = gt_idx.long()[:, None, None]

    def g(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = torch.clamp(yi, 0, H - 1).long()
        xc = torch.clamp(xi, 0, W - 1).long()
        return flat[gi, yc * W + xc] * inb       # (R, os, os)

    vals = ((1 - fy) * (1 - fx) * g(y0f, x0f) +
            (1 - fy) * fx * g(y0f, x0f + 1) +
            fy * (1 - fx) * g(y0f + 1, x0f) +
            fy * fx * g(y0f + 1, x0f + 1))       # (R, os, os)
    s = samples
    vals = vals.reshape(R, out_size, s, out_size, s).mean((2, 4))
    return (vals >= 0.5).float()


def mask_loss(mask_logits, fg, gt_masks_28):
    """mask_logits (R, 28, 28) of the target class; gt_masks_28
    (R, 28, 28) {0,1}, cropped to the proposal."""
    p, y = mask_logits, gt_masks_28
    bce = torch.clamp(p, min=0) - p * y + torch.log1p(torch.exp(-p.abs()))
    per = bce.mean((1, 2))
    return torch.where(fg, per, 0.0).sum() / torch.clamp(fg.sum(), min=1)


def semseg_loss(logits, labels, ignore=IGNORE_LABEL, weight=0.5):
    """logits (B, S, H, W); labels (B, H, W) int, ``ignore`` where
    unlabelled."""
    valid = labels != ignore
    safe = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits, dim=1)
    ce = -torch.gather(logp, 1, safe[:, None])[:, 0]
    return weight * torch.where(valid, ce, 0.0).sum() / \
        torch.clamp(valid.sum(), min=1)
