"""Multi-view depth consistency filtering + point back-projection.

Port of :mod:`pvo_tpu.geom.depth_filter`, plain torch. It rebuilds the
reference's CUDA depth_filter / iproj kernels: for each target
keyframe, count how many of its 6 temporal neighbours (i-3..i-1,
i+1..i+3) observe a consistent inverse depth (the projected depth
within ``thresh`` of the neighbour's own depth map at the nearest
pixel). Used by the visualizer to show only well-supported points.
"""

from __future__ import annotations

import torch

from pvo_tpu_torch.lie import se3

from .projective import MIN_DEPTH, iproj

OFFSETS = (-1, -2, -3, 1, 2, 3)


def _points(disps, intrinsics, inds):
    """Homogeneous camera points (M, h, w, 4) of frames ``inds``."""
    intr_b = intrinsics.expand(1, len(inds), 4)
    return iproj(disps[inds][None], intr_b)[0]


def depth_consistency_count(poses, disps, intrinsics, inds, thresh):
    """poses (F,7), disps (F,h,w), intrinsics (4,), inds (M,) target
    frames (long), thresh (M,) per-frame disparity tolerance.

    Returns counts (M, h, w) f32: the number of consistent neighbour
    views."""
    F, h, w = disps.shape
    fx, fy, cx, cy = intrinsics
    X0 = _points(disps, intrinsics, inds)                # (M, h, w, 4)
    counts = torch.zeros(X0.shape[:3], device=disps.device)
    for off in OFFSETS:
        j = inds + off
        ok_frame = (j >= 0) & (j < F)
        jx = j.clamp(0, F - 1)

        Gij = se3.mul(poses[jx], se3.inv(poses[inds]))
        X1 = se3.act4(Gij[:, None, None], X0)
        Z = X1[..., 2]
        zsafe = torch.where(Z < MIN_DEPTH, torch.ones_like(Z), Z)
        u = fx * X1[..., 0] / zsafe + cx
        v = fy * X1[..., 1] / zsafe + cy
        d_proj = X1[..., 3] / zsafe                      # inverse depth in j

        ui = torch.round(u).to(torch.int64)
        vi = torch.round(v).to(torch.int64)
        inb = ((ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) &
               (Z > MIN_DEPTH))
        flat = vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)
        d_obs = torch.gather(disps[jx].reshape(len(inds), h * w), 1,
                             flat.reshape(len(inds), -1)).reshape(flat.shape)
        consistent = torch.abs(d_proj - d_obs) < thresh[:, None, None]
        counts += (consistent & inb & ok_frame[:, None, None]).float()
    return counts


def backproject_points(poses, disps, intrinsics, inds):
    """Camera-frame points -> world points for the given frames
    (reference iproj_kernel). Returns (M, h, w, 3) world points."""
    X0 = _points(disps, intrinsics, inds)
    d = torch.clamp(X0[..., 3:4], min=1e-6)
    pts_cam = X0[..., :3] / d
    Ginv = se3.inv(poses[inds])
    return se3.act(Ginv[:, None, None], pts_cam)
