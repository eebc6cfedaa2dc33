"""DroidNet's inference modules and input normalization.

The container mirrors the reference ``DroidNet`` state dict (``fnet``,
``cnet``, ``update`` with ``update.agg``), so a reference checkpoint
loads with ``load_state_dict`` (:mod:`pvo_tpu_torch.utils.convert`).
The training forward of :mod:`pvo_tpu.vo.net.droidnet` is not ported
yet.
"""

from __future__ import annotations

import torch
from torch import nn

from .extractor import BasicEncoder
from .layers import init_conv_weights
from .update import DynamicUpdateModule

# ImageNet statistics used to normalize RGB inputs (values in [0,1]).
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)


def normalize_images(images_u8_rgb):
    """uint8 RGB (..., H, W, 3) -> normalized float32 (..., H, W, 3)."""
    x = images_u8_rgb.float() / 255.0
    mean = torch.tensor(RGB_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(RGB_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


class DroidNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(output_dim=128, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=256, norm_fn="none")
        self.update = DynamicUpdateModule()

    @classmethod
    def from_seed(cls, seed=0):
        """Random weights (kaiming-normal convs, zero biases) drawn from a
        ``torch.Generator`` seeded with ``seed``."""
        net = cls()
        init_conv_weights(net, torch.Generator().manual_seed(seed))
        return net
