"""Stage 1 — flow tracking: warp fused panoptic maps forward by VO flow
(the port's own copy of :mod:`pvo_tpu.pipeline.tracking`).

Rebuild of reference VPS_Module/tools/1_tracking.py: for each frame
after the first of a sequence, forward-splat the PREVIOUS frame's fused
panoptic id map along the VO full flow (u1 = u + flow), optionally
resolving collisions by depth ordering (far written first).
"""

from __future__ import annotations

import numpy as np


def forward_splat_ids(segm, flow, depth=None):
    """segm: (H, W) int ids of the reference (previous) frame;
    flow: (H, W, 2) ref->cur pixel flow; depth: optional (H, W) ref
    depth (near surfaces win collisions).

    Returns the warped id map (H, W), zeros where nothing lands.
    """
    rows, cols = segm.shape
    out = np.zeros_like(segm)

    v, u = np.mgrid[0:rows, 0:cols]
    u1 = (u + flow[..., 0]).astype(np.int32).ravel()
    v1 = (v + flow[..., 1]).astype(np.int32).ravel()
    u = u.ravel()
    v = v.ravel()

    ok = (u1 >= 0) & (u1 < cols) & (v1 >= 0) & (v1 < rows)
    u1, v1, u, v = u1[ok], v1[ok], u[ok], v[ok]

    if depth is not None:
        d = depth.ravel()[ok]
        order = np.argsort(-d)  # far first, near overwrites
        u1, v1, u, v = u1[order], v1[order], u[order], v[order]

    out[v1, u1] = segm[v, u]
    return out


def track_sequence(segms, flows, depths=None):
    """segms: list of (H, W) fused id maps (time order); flows[i] maps
    frame i -> i+1. Returns warped maps aligned with segms (first is a
    copy, as the reference emits the first frame unchanged)."""
    out = [segms[0].copy()]
    for i in range(1, len(segms)):
        d = None if depths is None else depths[i - 1]
        out.append(forward_splat_ids(segms[i - 1], flows[i - 1], d))
    return out
