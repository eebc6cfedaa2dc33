"""Per-edge Gauss-Newton blocks of the reprojection objective.

Port of :func:`pvo_tpu.geom.ba._edge_blocks`, the linearization the
inference DBA (:mod:`pvo_tpu_torch.vo.dba`) assembles. The training BA
is not ported yet.
"""

from __future__ import annotations

import torch

from . import projective


def _edge_blocks(target, weight, poses, disps, intrinsics, ii, jj):
    """Linearize all edges; return per-edge Hessian/rhs/E/C blocks.

    Shapes: Hblk (B,N,12,12) ordered [xi_i (6), xi_j (6)];
    vblk (B,N,12); Ei/Ej (B,N,6,HW); Ck/wk (B,N,HW).
    """
    B, N = target.shape[0], target.shape[1]
    ht, wd = disps.shape[-2:]
    HW = ht * wd

    coords, valid, Ji_pl, Jj_pl, Jz_pl = \
        projective.projective_jacobian_planes(
            poses, disps, intrinsics, ii, jj)

    r = torch.movedim((target - coords).reshape(B, N, HW, 2), -1, 2)
    w = 0.001 * torch.movedim(
        (valid * weight).reshape(B, N, HW, 2), -1, 2)   # (B,N,2,HW)

    J = torch.cat([Ji_pl, Jj_pl], dim=3)               # (B,N,2,12,HW)
    wJ = w[:, :, :, None] * J

    Hblk = torch.einsum("bncdh,bnceh->bnde", wJ, J)
    vblk = torch.einsum("bncdh,bnch->bnd", wJ, r)
    Ei = torch.einsum("bncdh,bnch->bndh", wJ[:, :, :, :6], Jz_pl)
    Ej = torch.einsum("bncdh,bnch->bndh", wJ[:, :, :, 6:], Jz_pl)
    wk = torch.sum(w * r * Jz_pl, dim=2)
    Ck = torch.sum(w * Jz_pl * Jz_pl, dim=2)
    return Hblk, vblk, Ei, Ej, Ck, wk
