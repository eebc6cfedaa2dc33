"""Field upsampling: learned convex upsampling and bilinear x8.

Port of :mod:`pvo_tpu.geom.upsample`, channels-last at the function
boundary as the rest of the port's geometry. The convex upsample is a
softmax over each pixel's 3x3 neighbourhood with learned weights for
each of the 8x8 sub-pixels; the bilinear resize has ``align_corners=
True`` semantics and repeats the JAX module's arithmetic (positions as
``arange * ((in-1)/(out-1))`` in f32) rather than calling
``F.interpolate``, whose positions round differently.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _neighborhood9(x):
    """3x3 shifted views of (B, H, W, C) with zero padding ->
    (B, 9, H, W, C), row-major in (dy, dx) as ``F.unfold`` orders them."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([xp[:, dy:dy + H, dx:dx + W]
                        for dy in range(3) for dx in range(3)], dim=1)


def cvx_upsample(data, mask):
    """Convex upsample of a field by 8x.

    data: (B, H, W, D); mask: (B, H, W, 9*8*8) logits laid out
    (9 taps, 8 rows, 8 columns). Returns (B, 8H, 8W, D).
    """
    B, H, W, D = data.shape
    m = torch.softmax(mask.reshape(B, H, W, 9, 8, 8), dim=3)
    nbh = _neighborhood9(data)  # (B, 9, H, W, D)
    up = torch.einsum("bkhwd,bhwkyx->bhywxd", nbh, m)
    return up.reshape(B, 8 * H, 8 * W, D)


def _resize_axis_align_corners(x, axis, out_size):
    in_size = x.shape[axis]
    if in_size == 1:
        reps = [1] * x.dim()
        reps[axis] = out_size
        return x.repeat(reps)
    pos = torch.arange(out_size, dtype=torch.float32, device=x.device) * \
        ((in_size - 1) / (out_size - 1))
    i0 = torch.floor(pos).long()
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    f = pos - i0.float()

    x0 = torch.index_select(x, axis, i0)
    x1 = torch.index_select(x, axis, i1)
    shape = [1] * x.dim()
    shape[axis] = out_size
    f = f.reshape(shape).to(x.dtype)
    return x0 * (1 - f) + x1 * f


def bilinear_resize_align_corners(x, out_h, out_w):
    """Bilinear resize of (..., H, W, C) where the grid's end points map
    to the end points (``align_corners=True``)."""
    x = _resize_axis_align_corners(x, x.dim() - 3, out_h)
    return _resize_axis_align_corners(x, x.dim() - 2, out_w)


def upsample_inter(field, factor=8):
    """Bilinear x8 upsample of (..., H, W, D) fields."""
    H, W = field.shape[-3], field.shape[-2]
    return bilinear_resize_align_corners(field, factor * H, factor * W)
