"""Standard ROI heads (box + mask), NCHW (the port's own copy of
:mod:`pvo_tpu.vps.roi_heads`, inference).

detectron2's StandardROIHeads: each box pooled from its FPN level
(canonical 224 at p4), a 2-FC box head on the NCHW flattening of the
(R, C, 7, 7) pool, class-wise box regression and per-class NMS, then the
Mask R-CNN head on the detections. State-dict names as detectron2's:
``box_head.fc{1,2}``, ``box_predictor.{cls_score,bbox_pred}``,
``mask_head.{mask_fcn1..4,deconv,predictor}``.

The box head's fc1 reads the pool flattened in (c, y, x) order, as
detectron2 does, so a reference checkpoint's fc1 is right as it is. The
JAX package flattens (y, x, c) against the same converted weights
(``pvo_tpu/vps/roi_heads.py:81-82``, ``:120-121``), which permutes fc1's
input there; :func:`pvo_tpu_torch.utils.convert_vps.panoptic_fpn_from_jax`
permutes the JAX weights' columns, so the two packages agree on bridged
weights.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from . import ops
from .resnet import Conv2d

BOX_LEVELS = ("p2", "p3", "p4", "p5")
BOX_STRIDES = (4, 8, 16, 32)


def assign_levels(boxes, k_min=2, k_max=5, canonical=224,
                  canonical_level=4):
    """FPN paper level assignment (poolers.py)."""
    area = ops.box_area(boxes)
    s = torch.sqrt(torch.clamp(area, min=1e-9))
    lvl = torch.floor(canonical_level + torch.log2(s / canonical + 1e-8))
    return torch.clamp(lvl, k_min, k_max).long() - k_min


def flat_levels(feats: Dict[str, torch.Tensor], dtype=None):
    """The box levels of one image as one (sum h*w, C) buffer with each
    level's (offset, h, w, 1/stride)."""
    flats, geometry = [], []
    off = 0
    for lvl, stride in zip(BOX_LEVELS, BOX_STRIDES):
        f = feats[lvl][0]
        C, h, w = f.shape
        flats.append(f.reshape(C, h * w).t())
        geometry.append((off, h, w, 1.0 / stride))
        off += h * w
    flat = torch.cat(flats, 0)
    return (flat if dtype is None else flat.to(dtype)), geometry


def multilevel_roi_align(feats, boxes, out_size=7, samples=None,
                         flat=None):
    """Pool each box from its assigned level (one bag of rows of the
    concatenated levels per output bin; ``ops.roi_align_flat``).

    ``samples``: the per-bin sample grid, 4 at out_size 7 and 2 at 14
    (the JAX package's static approximation of sampling_ratio=0, exact at
    the top of each level's bin range). ``flat``: ``flat_levels(feats)``
    when the caller already has it. Returns (R, C, out, out)."""
    if samples is None:
        samples = 4 if out_size <= 7 else 2
    flat, geometry = flat if flat is not None else flat_levels(feats)
    lvl_idx = assign_levels(boxes)
    table = torch.tensor(geometry, dtype=torch.float64,
                         device=boxes.device)[lvl_idx]   # (R, 4)
    offb, Hb, Wb = (table[:, i].long() for i in range(3))
    sb = table[:, 3].to(boxes.dtype)
    return ops.roi_align_flat(flat, boxes * sb[:, None], Hb, Wb, offb,
                              out_size=out_size, samples=samples)


class BoxHead(nn.Module):
    """FastRCNNConvFCHead with two FCs, on the NCHW flattening."""

    def __init__(self, in_features=256 * 7 * 7, fc_dim=1024):
        super().__init__()
        self.fc1 = nn.Linear(in_features, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)

    def forward(self, x):
        x = F.relu(self.fc1(x.flatten(1)))
        return F.relu(self.fc2(x))


class BoxPredictor(nn.Module):
    """FastRCNNOutputLayers: class scores (K + background) and class-wise
    box deltas."""

    def __init__(self, num_classes=3, fc_dim=1024):
        super().__init__()
        self.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    """MaskRCNNConvUpsampleHead: 4x conv3x3 + 2x2/2 deconv + 1x1."""

    def __init__(self, num_classes=3, dim=256):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}", Conv2d(dim, dim, 3, padding=1,
                                                   activation=F.relu))
        self.deconv = nn.ConvTranspose2d(dim, dim, 2, stride=2)
        self.predictor = nn.Conv2d(dim, num_classes, 1)

    def forward(self, x):
        for i in range(1, 5):
            x = getattr(self, f"mask_fcn{i}")(x)
        return self.predictor(F.relu(self.deconv(x)))


class ROIHeads(nn.Module):
    def __init__(self, num_classes=3):
        super().__init__()
        self.num_classes = num_classes
        self.box_head = BoxHead()
        self.box_predictor = BoxPredictor(num_classes)
        self.mask_head = MaskHead(num_classes)

    def forward(self, feats, proposals, proposal_valid, image_hw,
                score_thresh=0.05, nms_thresh=0.5, max_dets=100):
        """Inference. Returns dict with boxes (D,4), scores (D,), classes
        (D,), mask_logits (D, 28, 28), valid (D,)."""
        H, W = image_hw
        R = proposals.shape[0]
        K = self.num_classes
        dt = next(self.parameters()).dtype
        # pooled in f32 from an f32 copy of the levels (a bf16 model's
        # sample weights stay f32), then cast to the heads' dtype
        flat = flat_levels(feats, torch.float32)

        with record_function("vps.box_head"):
            pooled = multilevel_roi_align(feats, proposals, out_size=7,
                                          flat=flat)
            scores, deltas = self.box_predictor(self.box_head(
                pooled.to(dt)))
            probs = torch.softmax(scores.float(), dim=-1)[:, :K]

            deltas = deltas.float().reshape(R, K, 4)
            boxes_k = ops.decode_boxes(
                deltas, proposals[:, None, :].expand(R, K, 4),
                weights=(10.0, 10.0, 5.0, 5.0))
            boxes_k = ops.clip_boxes(boxes_k, H, W)

            flat_boxes = boxes_k.reshape(R * K, 4)
            flat_scores = probs.reshape(R * K)
            flat_cls = torch.arange(K, dtype=torch.int32,
                                    device=proposals.device).repeat(R)
            pvalid = proposal_valid.repeat_interleave(K)
            flat_scores = torch.where(
                pvalid & (flat_scores > score_thresh), flat_scores,
                -torch.inf)
            keep, valid = ops.batched_nms(flat_boxes, flat_scores,
                                          flat_cls, nms_thresh, max_dets)
            det_boxes = flat_boxes[keep]
            det_scores = torch.where(valid, flat_scores[keep], 0.0)
            det_cls = flat_cls[keep]

        with record_function("vps.mask_head"):
            mpooled = multilevel_roi_align(feats, det_boxes, out_size=14,
                                           flat=flat)
            mlogits = self.mask_head(mpooled.to(dt))      # (D, K, 28, 28)
            masks = torch.gather(
                mlogits, 1, det_cls.long()[:, None, None, None].expand(
                    -1, 1, *mlogits.shape[2:]))[:, 0]

        return {
            "boxes": det_boxes,
            "scores": det_scores,
            "classes": det_cls,
            "mask_logits": masks.float(),
            "valid": valid,
        }
