"""Helpers of the comparison with the reference: the gaps compared, the
precision of the control and the frame's state copied out of the
program.

The control is the reference put in the program's place one precision
step below what the configuration states: the update operator (bf16 in
the configuration) with its weights and activations rounded to fp8
(e4m3, one scale a tensor), and the f32 stages (encoders, geometry,
DBA) with TF32 switched on.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def fp8(t):
    """``t`` rounded to float8 e4m3 with one scale for the tensor."""
    t = t.float()
    amax = t.abs().amax().clamp(min=1e-30)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


@contextlib.contextmanager
def tf32(on):
    """TF32 for matmuls and cuDNN convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def precision(control):
    """(op_cast, context) of the reference (None, TF32 off) or of the
    control (fp8, TF32 on)."""
    return (fp8 if control else None), tf32(bool(control))


def rel_gap(a, b):
    """max |a - b| / max |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def quantile(x, q):
    """The ``q`` quantile of the entries of ``x`` (nearest rank)."""
    x = x.flatten().float().sort().values
    return float(x[min(len(x) - 1, int(q * len(x)))])


def flow_gaps(a, b):
    """(median, 90th percentile, largest) of the pixel gaps |a - b| of
    (E, h, w, 2) targets, in pixels."""
    d = torch.linalg.norm(a.float() - b.float(), dim=-1)
    return quantile(d, 0.5), quantile(d, 0.9), float(d.max())


def abs_gaps(a, b):
    """(median, 90th percentile, largest) of the entries' gaps |a - b|."""
    d = (a.float() - b.float()).abs()
    return quantile(d, 0.5), quantile(d, 0.9), float(d.max())


def pose_gaps(a, b):
    """Per-pose largest entry gap of (N, 7) poses, the quaternions' signs
    aligned: (median over the poses, largest)."""
    a, b = a.float().clone(), b.float()
    flip = (a[:, 3:] * b[:, 3:]).sum(-1) < 0
    a[flip, 3:] = -a[flip, 3:]
    d = (a - b).abs().amax(1)
    return quantile(d, 0.5), float(d.max())


def disp_gaps(a, b):
    """(median, 90th percentile, largest) of the pixel gaps of (N, h, w)
    disparities, each over its frame's mean disparity in ``b``."""
    a, b = a.float(), b.float()
    m = b.abs().flatten(1).mean(1).clamp(min=1e-12)
    d = (a - b).abs() / m[:, None, None]
    return quantile(d, 0.5), quantile(d, 0.9), float(d.max())


def named(prefix, values, names):
    return {f"{prefix}_{n}": v for n, v in zip(names, values)}
