"""Region Proposal Network, NCHW (the port's own copy of
:mod:`pvo_tpu.vps.rpn`).

detectron2's StandardRPNHead (shared 3x3 conv, objectness and anchor-delta
1x1 convs over p2..p6; state-dict names ``rpn_head.conv``,
``rpn_head.objectness_logits``, ``rpn_head.anchor_deltas``), anchors of
sizes 32..512 at aspects 0.5/1/2, per-level top-1000, decode, clip, and one
NMS over all levels to 1000 proposals.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import ops

LEVELS = ("p2", "p3", "p4", "p5", "p6")
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
SIZES = {"p2": 32, "p3": 64, "p4": 128, "p5": 256, "p6": 512}
ASPECTS = (0.5, 1.0, 2.0)


def base_anchors(level):
    """(A, 4) anchors of a level centred on the origin."""
    area = float(SIZES[level] ** 2)
    anchors = []
    for a in ASPECTS:
        aw = math.sqrt(area / a)
        ah = a * aw
        anchors.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
    return np.asarray(anchors, np.float32)


@functools.lru_cache(maxsize=32)
def _anchors_np(level, h, w):
    stride = STRIDES[level]
    ys = np.arange(h, dtype=np.float32) * stride
    xs = np.arange(w, dtype=np.float32) * stride
    gx, gy = np.meshgrid(xs, ys)
    shifts = np.stack([gx, gy, gx, gy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base_anchors(level)[None]).reshape(-1, 4)


def generate_anchors(level, hw, device="cpu"):
    """Anchor boxes (H*W*A, 4) for a feature level of shape hw, anchor
    fastest (as :func:`pvo_tpu.vps.rpn.generate_anchors`)."""
    return torch.from_numpy(_anchors_np(level, *hw)).to(device)


class RPNHead(nn.Module):
    def __init__(self, in_channels=256, num_anchors=len(ASPECTS)):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(in_channels, 4 * num_anchors, 1)

    def forward(self, feats: Dict[str, torch.Tensor]):
        """Returns ({lvl: (B, A, h, w)}, {lvl: (B, 4A, h, w)})."""
        logits, regs = {}, {}
        for lvl in LEVELS:
            t = F.relu(self.conv(feats[lvl]))
            logits[lvl] = self.objectness_logits(t)
            regs[lvl] = self.anchor_deltas(t)
        return logits, regs


class RPN(nn.Module):
    """detectron2's proposal generator: holds ``rpn_head``."""

    def __init__(self):
        super().__init__()
        self.rpn_head = RPNHead()

    def forward(self, feats, image_hw):
        logits, regs = self.rpn_head(feats)
        return generate_proposals({k: v[0] for k, v in logits.items()},
                                  {k: v[0] for k, v in regs.items()},
                                  image_hw)


def generate_proposals(logits, regs, image_hw, pre_nms_topk=1000,
                       post_nms_topk=1000, nms_thresh=0.7, min_size=0.0):
    """Decode + NMS proposals for ONE image.

    logits: {lvl: (A, h, w)}; regs: {lvl: (4A, h, w)}.
    Returns (boxes (post_nms_topk, 4), scores, valid). The per-level
    top-k is a stable descending sort: ties keep the lower index first, as
    ``jax.lax.top_k``.
    """
    H, W = image_hw
    A = len(ASPECTS)
    all_boxes, all_scores = [], []
    for lvl in LEVELS:
        _, h, w = logits[lvl].shape
        lg = logits[lvl].permute(1, 2, 0).reshape(-1).float()
        rg = regs[lvl].permute(1, 2, 0).reshape(h * w * A, 4).float()
        anchors = generate_anchors(lvl, (h, w), lg.device)

        k = min(pre_nms_topk, lg.shape[0])
        top_scores, idx = torch.sort(lg, descending=True, stable=True)
        top_scores, idx = top_scores[:k], idx[:k]
        boxes = ops.clip_boxes(ops.decode_boxes(rg[idx], anchors[idx]),
                               H, W)
        ok = ((boxes[:, 2] - boxes[:, 0] > min_size) &
              (boxes[:, 3] - boxes[:, 1] > min_size))
        all_boxes.append(boxes)
        all_scores.append(torch.where(ok, top_scores, -torch.inf))

    boxes = torch.cat(all_boxes, 0)
    scores = torch.cat(all_scores, 0)
    keep, valid = ops.nms(boxes, scores, nms_thresh, post_nms_topk)
    return boxes[keep], scores[keep], valid
