"""Plain all-pairs correlation and its windowed bilinear lookup.

For an edge (i, j) the volume holds every dot product of a feature of
frame i with every feature of frame j (both scaled by 1/4), against a
4-level pyramid of frame j's features (2x2 means, floor sizes); the
lookup samples a 7x7 window (radius 3) around each pixel's coordinates
at every level, bilinearly, dx-major, zero outside the frame. Features
are widened to f32 first.
"""

from __future__ import annotations

import torch


def _pyramid(f2, levels):
    out = [f2]
    for _ in range(levels - 1):
        E, H, W, C = f2.shape
        f2 = f2[:, :2 * (H // 2), :2 * (W // 2)].reshape(
            E, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))
        out.append(f2)
    return out


def _lookup_level(vol, coords, r):
    """vol (E, HW1, H2, W2), coords (E, HW1, 2) -> (E, HW1, (2r+1)^2)."""
    E, HW1, H2, W2 = vol.shape
    S = 2 * r + 2
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None, None], (y - y0)[..., None, None]
    idx = (lambda v: torch.nan_to_num(v, nan=-1e6).clamp(-1e6, 1e6).long())
    bx, by = idx(x0) - r, idx(y0) - r
    if H2 * W2 == 0:
        patch = vol.new_zeros((E, HW1, S, S))
    else:
        d = torch.arange(S, device=vol.device)
        ys = by[..., None, None] + d[:, None]
        xs = bx[..., None, None] + d[None, :]
        inb = (ys >= 0) & (ys < H2) & (xs >= 0) & (xs < W2)
        flat = ys.clamp(0, H2 - 1) * W2 + xs.clamp(0, W2 - 1)
        patch = torch.gather(vol.reshape(E, HW1, H2 * W2), 2,
                             flat.reshape(E, HW1, S * S)).reshape(
                                 E, HW1, S, S)
        patch = torch.where(inb, patch, 0.0)
    w = 2 * r + 1
    out = ((1 - fy) * (1 - fx) * patch[..., :w, :w] +
           (1 - fy) * fx * patch[..., :w, 1:] +
           fy * (1 - fx) * patch[..., 1:, :w] +
           fy * fx * patch[..., 1:, 1:])
    return out.transpose(-1, -2).reshape(E, HW1, w * w)


def lookup(fmap1, fmap2, coords, levels=4, radius=3, chunk=16):
    """fmap1, fmap2 (E, h, w, C) of each edge's two frames, coords
    (E, h, w, 2) [x, y] in frame j's level-0 pixels -> (E, h, w, 196)."""
    E, h, w, C = fmap1.shape
    outs = []
    for s in range(0, E, chunk):
        f1 = fmap1[s:s + chunk].float().reshape(-1, h * w, C) / 4.0
        c = coords[s:s + chunk].reshape(-1, h * w, 2).float()
        per = []
        for lvl, f2 in enumerate(_pyramid(fmap2[s:s + chunk].float(),
                                          levels)):
            n, H2, W2 = f2.shape[:3]
            vol = torch.bmm(f1, (f2.reshape(n, H2 * W2, C) / 4.0)
                            .transpose(1, 2)).reshape(n, h * w, H2, W2)
            per.append(_lookup_level(vol, c / (2 ** lvl), radius))
        outs.append(torch.cat(per, dim=-1).reshape(-1, h, w,
                                                   per[0].shape[-1] * levels))
    return torch.cat(outs)
