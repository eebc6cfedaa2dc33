"""RAFT-style residual feature encoder (port of
:mod:`pvo_tpu.vo.net.extractor`).

7x7 stride-2 stem, three 2-block residual stages (32/64/128 channels,
strides 1/2/2) to 1/8 resolution, 1x1 output conv. Module names follow
the reference state dict (``conv1``, ``layer1.0.conv1``,
``layer2.0.downsample.0`` ...), so a reference checkpoint loads with
``load_state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import make_conv, make_norm, nchw, nhwc

DIM = 32


def conv_input(x):
    """(..., H, W, C) -> the encoders' (N, C, H, W) convolution input. On
    the card an NCHW-contiguous copy: on the channels-last view that
    ``nchw`` gives, cuDNN asks 2.09 GiB of workspace for the f32 3x3
    convolutions at 240x808, 13.3 MiB contiguous (fault B3;
    ``scripts/export_memory.py``). The CPU keeps the view (its
    convolutions take no workspace)."""
    x = nchw(x)
    return x.contiguous() if x.is_cuda else x


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.conv1 = make_conv(norm_fn, in_planes, planes, 3, stride,
                               padding=1)
        self.conv2 = make_conv(norm_fn, planes, planes, 3, 1, padding=1)
        self.norm1 = make_norm(norm_fn)
        self.norm2 = make_norm(norm_fn)
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                make_conv(norm_fn, in_planes, planes, 1, stride),
                make_norm(norm_fn))
        else:
            self.downsample = None

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim=128, norm_fn="instance"):
        super().__init__()
        self.conv1 = make_conv(norm_fn, 3, DIM, 7, 2, padding=3)
        self.norm1 = make_norm(norm_fn)
        layers, cin = [], DIM
        for dim, stride in [(DIM, 1), (2 * DIM, 2), (4 * DIM, 2)]:
            layers.append(nn.Sequential(
                ResidualBlock(cin, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1)))
            cin = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = nn.Conv2d(4 * DIM, output_dim, 1)

    def forward(self, x):
        """x: (..., H, W, 3) normalized images -> (..., H/8, W/8, out)."""
        lead = x.shape[:-3]
        y = torch.relu(self.norm1(self.conv1(conv_input(x))))
        y = self.layer3(self.layer2(self.layer1(y)))
        return nhwc(self.conv2(y), lead)
