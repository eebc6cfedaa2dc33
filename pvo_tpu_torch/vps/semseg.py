"""Semantic segmentation FPN head, NCHW (the port's own copy of
:mod:`pvo_tpu.vps.semseg`).

detectron2's SemSegFPNHead: per level, ``max(1, log2(stride / 4))``
steps of conv3x3 + GroupNorm(32) + ReLU, each followed by a 2x bilinear
upsampling while the level is coarser than stride 4; the levels summed, a
1x1 predictor, and a bilinear resize to the (padded) image. State-dict
names as detectron2's: ``p{2..5}.{0,2,4}`` for the convs (the upsamplings
sit at the odd places of each ``nn.Sequential``), ``.norm`` for their
GroupNorms, ``predictor``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d

LEVELS = ("p2", "p3", "p4", "p5")
STRIDES = (4, 8, 16, 32)
COMMON_STRIDE = 4


class SemSegFPNHead(nn.Module):
    def __init__(self, num_classes=12, conv_dim=128, in_channels=256):
        super().__init__()
        for lvl, stride in zip(LEVELS, STRIDES):
            k = max(1, (stride // COMMON_STRIDE).bit_length() - 1)
            layers = []
            for i in range(k):
                layers.append(Conv2d(
                    in_channels if i == 0 else conv_dim, conv_dim, 3,
                    padding=1, bias=False, norm=nn.GroupNorm(32, conv_dim),
                    activation=F.relu))
                if stride > COMMON_STRIDE:
                    layers.append(nn.Upsample(scale_factor=2,
                                              mode="bilinear",
                                              align_corners=False))
                    stride //= 2
            self.add_module(lvl, nn.Sequential(*layers))
        self.predictor = nn.Conv2d(conv_dim, num_classes, 1)

    def forward(self, feats, out_hw):
        total = None
        for lvl in LEVELS:
            x = getattr(self, lvl)(feats[lvl])
            total = x if total is None else total + x
        logits = self.predictor(total)
        return F.interpolate(logits, size=tuple(out_hw), mode="bilinear",
                             align_corners=False)
