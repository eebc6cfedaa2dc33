"""Mean induced-flow frame distance, PyTorch.

Port of :mod:`pvo_tpu.geom.distance`: for each (i, j) pair, the mean
reprojection displacement of frame i's pixels into frame j, blended
between the full relative motion (weight beta) and a translation-only
model (1 - beta); pairs where fewer than 75% of pixels land in front
of the camera score 1000.
"""

from __future__ import annotations

import torch

from pvo_tpu_torch.lie import se3

from .projective import MIN_DEPTH, coords_grid, iproj


def _flow_dist(Xj, grid, intrinsics):
    fx, fy, cx, cy = intrinsics
    Z = Xj[..., 2]
    zsafe = torch.where(Z < MIN_DEPTH, torch.ones_like(Z), Z)
    u = fx * Xj[..., 0] / zsafe + cx
    v = fy * Xj[..., 1] / zsafe + cy
    d = torch.sqrt((u - grid[..., 0]) ** 2 + (v - grid[..., 1]) ** 2)
    valid = (Z > MIN_DEPTH).to(d.dtype)
    return d * valid, valid


def _blend(d_full, v_full, d_trans, v_trans, beta, npix):
    accum = (beta * torch.sum(d_full, dim=(-2, -1)) +
             (1 - beta) * torch.sum(d_trans, dim=(-2, -1)))
    valid = (beta * torch.sum(v_full, dim=(-2, -1)) +
             (1 - beta) * torch.sum(v_trans, dim=(-2, -1)))
    frac = valid / (npix + 1e-8)
    dist = accum / torch.clamp(valid, min=1e-8)
    return torch.where(frac < 0.75, torch.full_like(dist, 1000.0), dist)


def frame_distance(poses, disps, intrinsics, ii, jj, beta=0.3):
    """poses (F,7), disps (F,h,w), intrinsics (4,), ii/jj (N,) ->
    (N,) one-directional distances."""
    ht, wd = disps.shape[-2:]
    ii = torch.as_tensor(ii, dtype=torch.long, device=disps.device)
    jj = torch.as_tensor(jj, dtype=torch.long, device=disps.device)
    grid = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    Gij = se3.mul(poses[jj], se3.inv(poses[ii]))
    X0 = iproj(disps[ii][None],
               intrinsics.expand(1, ii.shape[0], 4))[0]

    X1 = se3.act4(Gij[:, None, None], X0)
    d_full, v_full = _flow_dist(X1, grid, intrinsics)

    tij = Gij[:, None, None, :3]
    X1t = torch.cat([X0[..., :3] + X0[..., 3:4] * tij, X0[..., 3:4]], -1)
    d_trans, v_trans = _flow_dist(X1t, grid, intrinsics)
    return _blend(d_full, v_full, d_trans, v_trans, beta, ht * wd)


def frame_distance_bidirectional(poses, disps, intrinsics, ii, jj,
                                 beta=0.3):
    d1 = frame_distance(poses, disps, intrinsics, ii, jj, beta)
    d2 = frame_distance(poses, disps, intrinsics, jj, ii, beta)
    return 0.5 * (d1 + d2)


def window_distance_matrix(poses, disps, intrinsics, d0, WD, beta=0.3):
    """Bidirectional (WD, WD) distance matrix over the window
    [d0, d0 + WD): each frame's cloud is back-projected once and
    broadcast over the pair axis. Like ``lax.dynamic_slice``, an origin
    past ``F - WD`` is clamped so the window stays inside the buffer.
    ``d0`` is an int, or a 0-d device tensor (the planner's: the window's
    rows are then gathered, and nothing reads the card)."""
    ht, wd = disps.shape[-2:]
    if torch.is_tensor(d0):
        rows = d0.clamp(0, poses.shape[0] - WD) + torch.arange(
            WD, device=poses.device)
        pw, dw = poses[rows], disps[rows]
    else:
        d0 = max(0, min(int(d0), poses.shape[0] - WD))
        pw = poses[d0:d0 + WD]
        dw = disps[d0:d0 + WD]
    grid = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    X0 = iproj(dw[None], intrinsics.expand(1, WD, 4))[0]
    # Gij[i, j] = pose[j] * inv(pose[i])  (frame i's cloud into j)
    Gij = se3.mul(pw[None, :], se3.inv(pw)[:, None])

    X0b = X0[:, None].expand((WD,) + X0.shape)
    X1 = se3.act4(Gij[:, :, None, None], X0b)
    d_full, v_full = _flow_dist(X1, grid, intrinsics)

    tij = Gij[:, :, None, None, :3]
    xyz_t = X0[:, None, ..., :3] + X0[:, None, ..., 3:4] * tij
    X1t = torch.cat([xyz_t, X0[:, None, ..., 3:4].expand(
        xyz_t.shape[:-1] + (1,))], dim=-1)
    d_trans, v_trans = _flow_dist(X1t, grid, intrinsics)
    d = _blend(d_full, v_full, d_trans, v_trans, beta, ht * wd)
    return 0.5 * (d + d.T)
