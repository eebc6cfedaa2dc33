"""Plain replays of the tracker's stages, from a state the harness
copied out of the program: one recurrent update over a set of edges,
the tracked frame's encoders and its updates, the backend's global
updates and the trajectory filler's motion-only refinement.

The reference takes the program's state where a stage starts (poses,
disparities, stored features, the edges it chose) and recomputes the
stage in f32 with plain operations; the harness compares what it gets
with what the program wrote. Nothing here imports the program.
"""

from __future__ import annotations

import torch

from . import ba, net
from .corr import lookup
from .geometry import coords_grid, reproject, se3_exp, se3_inv, se3_log, \
    se3_mul

DY_THRESH = 0.5


class Frames:
    """Per-frame tensors of a video, by absolute frame index: ``full``
    holds whole-buffer tensors (poses, disps, damping), ``rows`` the
    feature tensors of frames [lo, lo + n)."""

    def __init__(self, full, rows, lo, intr):
        self.full, self.rows, self.lo, self.intr = full, rows, lo, intr

    def feat(self, name, idx):
        return self.rows[name][idx - self.lo].float()


def segment_vote(bin_mask, segm, valid, S_MAX, seg_thresh):
    """A panoptic segment whose dynamic-pixel share exceeds
    ``seg_thresh`` is made wholly dynamic; id 0 is never voted."""
    E, h, w = segm.shape
    seg = segm.reshape(E, h * w).long()
    dyn = ((~bin_mask[..., 0]) | (~bin_mask[..., 1])).reshape(E, h * w)
    zeros = torch.zeros((E, S_MAX), device=seg.device)
    tot = zeros.scatter_add(1, seg, torch.ones_like(seg, dtype=zeros.dtype))
    cnt = zeros.scatter_add(1, seg, dyn.float())
    killed = ((cnt / tot.clamp(min=1.0)) > seg_thresh) & valid[:, None]
    killed[:, 0] = False
    kill = killed.gather(1, seg).reshape(E, h, w)
    return bin_mask & (~kill)[..., None]


def update_step(sd, vid, poses, disps, damping, edges, state, w0, K,
                damp_fac, EP, segm, op_cast=None, chunk=128):
    """One recurrent update over ``edges`` (ii, jj, valid), ``chunk``
    edges at a time: correlation, update operator, heads, segment vote,
    and the damping of frames [w0, w0 + K) from the mean hidden state of
    each frame's edges. ``state`` (net, target, raw, dy) is replaced;
    returns (state, weight, eta (K, h, w)); ``damping`` is written in
    place."""
    ii, jj, valid = edges
    h, w = disps.shape[-2:]
    coords0 = coords_grid(h, w, disps.device)
    parts = []
    for o in range(0, ii.shape[0], chunk):
        sl = slice(o, o + chunk)
        i, j, ok = ii[sl], jj[sl], valid[sl]
        netE, target, raw, dy = (t[sl] for t in state)
        coords1, _ = reproject(poses, disps, vid.intr, i, j)
        motn = torch.cat([target - coords0, target - coords0 + dy,
                          target - coords1, raw], dim=-1).clamp(-64.0, 64.0)
        corr = lookup(vid.feat("fmaps", i), vid.feat("fmaps", j), coords1)
        netE, delta, ddy, wlog, dmask = net.update_operator(
            sd, netE, vid.feat("inps", i), corr, motn, op_cast)
        raw = raw + dmask
        bin_mask = torch.sigmoid(raw) >= DY_THRESH
        if segm is not None:
            bin_mask = segment_vote(bin_mask, vid.rows["segms"][i - vid.lo],
                                    ok, *segm)
        bin_mask = bin_mask.float()
        weight = torch.sigmoid(wlog + (1.0 - bin_mask) * 10.0) * \
            ok[:, None, None, None].float()
        parts.append((netE, coords1 + delta, raw, ddy * (1.0 - bin_mask),
                      weight))
    netE, target, raw, dy, weight = (torch.cat(t) for t in zip(*parts))
    frame = torch.where(valid, ii - w0, torch.full_like(ii, K))
    eta, has = net.damping(sd, netE, frame, K, op_cast, chunk)
    rows = torch.arange(K, device=ii.device) + w0
    damping[rows] = torch.where(has[:, None, None], eta, damping[rows])
    eta_k = damp_fac * damping[rows] + EP
    return (netE, target, raw, dy), weight, eta_k


def fresh_state(vid, poses, disps, ii, jj):
    """A new edge's state: the reprojection as its target, its source
    frame's context hidden state, zeros elsewhere."""
    target, _ = reproject(poses, disps, vid.intr, ii, jj)
    z = torch.zeros_like(target)
    return vid.feat("nets", ii), target, z, z.clone()


def refine(sd, vid, edges, state, extras, window, steps, damp, ba_args,
           segm, op_cast=None, motion_only=False):
    """``steps`` updates, each followed by the DBA over the active edges
    and ``extras`` (ii, jj, target, weight) of earlier edges. ``window``:
    (t0, t1, w0, K). Returns (poses, disps, state, weight)."""
    t0, t1, w0, K = window
    poses = vid.full["poses"].clone()
    disps = vid.full["disps"].clone()
    damping = vid.full["damping"].clone()
    ii, jj, valid = edges
    x_ii, x_jj, x_t, x_w = extras
    weight = None
    for _ in range(steps):
        state, weight, eta = update_step(
            sd, vid, poses, disps, damping, edges, state, w0, K, *damp,
            segm, op_cast)
        keep = valid
        poses, disps = ba.dba(
            poses, disps, vid.intr,
            torch.cat([x_t, state[1][keep]]), torch.cat([x_w, weight[keep]]),
            eta, torch.cat([x_ii, ii[keep]]), torch.cat([x_jj, jj[keep]]),
            t0, t1, w0, K, motion_only=motion_only, **ba_args)
    return poses, disps, state, weight


def interpolate(poses, t0, t1, wfac):
    """The filler's starting poses: exp(w log(P1 P0^-1)) P0."""
    P0, P1 = poses[t0], poses[t1]
    dP = se3_mul(P1, se3_inv(P0))
    return se3_mul(se3_exp(se3_log(dP) * wfac[:, None]), P0)
