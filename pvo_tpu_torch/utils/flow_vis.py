"""Optical-flow visualization (Middlebury color wheel): the port's own
copy of :mod:`pvo_tpu.utils.flow_vis` (plain numpy, bit-equal to it).

Rebuild of reference VO_Module/evaluation_scripts/flow_vis_utils.py:
standard color-wheel encoding of 2D flow fields to RGB uint8.
"""

from __future__ import annotations

import numpy as np


def _make_colorwheel():
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_image(flow, clip_flow=None, rad_max=None):
    """flow: (H, W, 2) -> RGB uint8 (H, W, 3)."""
    u = np.asarray(flow[..., 0], np.float64)
    v = np.asarray(flow[..., 1], np.float64)
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)

    rad = np.sqrt(u ** 2 + v ** 2)
    if rad_max is None:
        rad_max = max(rad.max(), 1e-6)
    u = u / rad_max
    v = v / rad_max
    rad = rad / rad_max

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)          # saturate with radius
        img[..., c] = np.floor(255 * col)
    return img
