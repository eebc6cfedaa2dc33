"""ResNet-50 backbone with frozen batch-norm, NCHW (the port's own copy of
:mod:`pvo_tpu.vps.resnet`).

detectron2's ResNet as Panoptic FPN builds it (stride on the 1x1 conv1,
caffe-style R-50): a 7x7/2 stem and a 3x3/2 max pool, then the bottleneck
stages res2..res5. The modules carry detectron2's state-dict names
(``stem.conv1.norm.running_var``, ``res3.0.shortcut.weight``, ...), so a
reference checkpoint loads with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBN(nn.Module):
    """detectron2's FrozenBatchNorm2d: four buffers folded into one affine
    at call time."""

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


class Conv2d(nn.Conv2d):
    """detectron2's Conv2d: a convolution followed by an optional ``norm``
    submodule (its state-dict names end in ``.norm.*``) and activation."""

    def __init__(self, *args, norm=None, activation=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm
        self.activation = activation

    def forward(self, x):
        x = super().forward(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


def conv_bn(cin, cout, k, stride=1, relu=True):
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False,
                  norm=FrozenBN(cout), activation=F.relu if relu else None)


class Bottleneck(nn.Module):
    def __init__(self, cin, out_channels, bottleneck_channels, stride=1):
        super().__init__()
        self.conv1 = conv_bn(cin, bottleneck_channels, 1, stride)
        self.conv2 = conv_bn(bottleneck_channels, bottleneck_channels, 3)
        self.conv3 = conv_bn(bottleneck_channels, out_channels, 1,
                             relu=False)
        self.shortcut = None
        if cin != out_channels:
            self.shortcut = conv_bn(cin, out_channels, 1, stride, relu=False)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(x + y)


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            norm=FrozenBN(64), activation=F.relu)

    def forward(self, x):
        # max_pool2d pads with -inf, as the JAX package's pool
        return F.max_pool2d(self.conv1(x), 3, stride=2, padding=1)


class ResNet50(nn.Module):
    """Returns {"res2": ..., "res3": ..., "res4": ..., "res5": ...};
    ``stage_blocks`` shrinks the stages (tests use (1, 1, 1, 1))."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stage_blocks = tuple(stage_blocks)
        self.stem = Stem()
        channels = [(256, 64), (512, 128), (1024, 256), (2048, 512)]
        cin = 64
        for stage, (n_blocks, (oc, bc)) in enumerate(
                zip(self.stage_blocks, channels)):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(cin, oc, bc,
                                         stride=stride if b == 0 else 1))
                cin = oc
            self.add_module(f"res{stage + 2}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.stem(x)
        out = {}
        for stage in range(2, 6):
            x = getattr(self, f"res{stage}")(x)
            out[f"res{stage}"] = x
        return out
