"""Shared layers: instance norm, gradient clipping, conv init, and the
convolution in front of an instance norm (without cuDNN under grad on
the card, B4).

Port of :mod:`pvo_tpu.vo.net.layers`. The modules of this package keep
the JAX package's channels-last (NHWC) layout at their public
``forward``; inside they run PyTorch's NCHW convolutions on permuted
views (the strides of a permuted NHWC tensor are PyTorch's
channels-last memory format, so no copy is made).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


def nchw(x):
    """(..., H, W, C) view -> (N, C, H, W) view."""
    return x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)


def nhwc(x, lead=None):
    """(N, C, H, W) -> (*lead, H, W, C) (``lead`` defaults to (N,))."""
    y = x.permute(0, 2, 3, 1)
    return y if lead is None else y.reshape(tuple(lead) + y.shape[1:])


class InstanceNorm(nn.Module):
    """InstanceNorm2d without affine parameters (torch default): each
    (sample, channel) normalized over H, W with biased variance."""

    def __init__(self, eps=1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        mean = x.mean(dim=(-2, -1), keepdim=True)
        var = torch.square(x - mean).mean(dim=(-2, -1), keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)


@contextlib.contextmanager
def cudnn_enabled(flag):
    """``torch.backends.cudnn.enabled`` for the block, and nothing else
    (``torch.backends.cudnn.flags()`` would also switch TF32 on: its
    ``allow_tf32`` defaults to True)."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = flag
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


class NativeConv(torch.autograd.Function):
    """A module's convolution without cuDNN in its forward and in its
    backward: PyTorch's own CUDA convolution (the backward reads the
    cuDNN flag when it runs, so the gradients are recomputed under it)."""

    @staticmethod
    def forward(ctx, x, w, b, module):
        ctx.module = module
        ctx.save_for_backward(x, w, b)
        with cudnn_enabled(False):
            return module._conv_forward(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        x, w, b = ctx.saved_tensors
        with torch.enable_grad(), cudnn_enabled(False):
            x, w = (t.detach().requires_grad_() for t in (x, w))
            b = None if b is None else b.detach().requires_grad_()
            leaves = [t for t in (x, w, b) if t is not None]
            grads = list(torch.autograd.grad(
                ctx.module._conv_forward(x, w, b), leaves, gy))
        return grads[0], grads[1], (grads[2] if b is not None else None), \
            None


class NormedConv2d(nn.Conv2d):
    """A convolution that an instance norm follows. Where gradients flow
    on the card it runs without cuDNN (:class:`NativeConv`; fault B4):
    the norm's backward makes the output gradient sum to zero over each
    channel, so the weight gradient is a small difference of large sums,
    and cuDNN's f32 weight-gradient kernels (2.6e-6-4e-6 relative on
    random data, PyTorch's own 1.5e-7) put fnet's first residual layers
    4.45e-3 from the CPU's gradient. Inference keeps cuDNN."""

    def forward(self, x):
        if x.is_cuda and torch.is_grad_enabled() and self.weight.requires_grad:
            return NativeConv.apply(x, self.weight, self.bias, self)
        return super().forward(x)


def make_conv(norm_fn: str, *args, **kwargs) -> nn.Conv2d:
    """The convolution in front of a ``make_norm(norm_fn)``."""
    cls = NormedConv2d if norm_fn == "instance" else nn.Conv2d
    return cls(*args, **kwargs)


def make_norm(norm_fn: str) -> nn.Module:
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "none":
        return nn.Identity()
    raise NotImplementedError(f"norm_fn={norm_fn!r}")


class _ClipGrad(torch.autograd.Function):
    """Identity forward; the backward zeroes gradient entries with
    |g| > clip or NaN (reference modules/clipping.py:7-24)."""

    @staticmethod
    def forward(ctx, x, clip):
        ctx.clip = clip
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        bad = torch.isnan(g) | (torch.abs(g) > ctx.clip)
        return torch.where(bad, torch.zeros_like(g), g), None


def grad_clip(x, clip=0.01):
    """The JAX module's ``grad_clip``: identity, clipped backward."""
    return _ClipGrad.apply(x, clip)


class GradientClip(nn.Module):
    """The reference's GradientClip: identity in the forward pass; in the
    backward, gradient entries above ``clip`` in magnitude or NaN are
    zeroed."""

    def __init__(self, clip=0.01):
        super().__init__()
        self.clip = clip

    def forward(self, x):
        return grad_clip(x, self.clip)


def init_conv_weights(module: nn.Module, generator: torch.Generator):
    """Kaiming-normal (fan_out, relu) conv weights and zero biases, drawn
    from ``generator`` (the JAX package's random init scheme)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu",
                                    generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
