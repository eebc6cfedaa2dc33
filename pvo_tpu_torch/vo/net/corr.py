"""All-pairs correlation pyramid + windowed lookup, plain PyTorch.

Port of :mod:`pvo_tpu.vo.net.corr`. This is the plain version beside
the hand-written CUDA kernels of :mod:`.cuda_corr`: the path every call
site takes on the CPU, and the oracle the kernels are checked against.

* the all-pairs volume is one batched matmul (scaled by 1/16 like the
  reference); pyramid levels are 2x2 average pools (floor);
* the (2r+1)^2 bilinear window uses the shared-fraction patch trick:
  all taps share one fraction, so an (2r+2)^2 integer patch is gathered
  per query pixel and 4 shifted views are blended;
* out-of-bounds taps contribute zero;
* taps are emitted in the reference's dx-major order.
"""

from __future__ import annotations

import torch


def corr_volume(fmap1, fmap2):
    """fmap (E, H, W, C) -> (E, H*W, H, W) f32 volume, scaled by 1/16."""
    E, H, W, C = fmap1.shape
    f1 = fmap1.reshape(E, H * W, C).float() / 4.0
    f2 = fmap2.reshape(E, H * W, C).float() / 4.0
    return torch.bmm(f1, f2.transpose(1, 2)).reshape(E, H * W, H, W)


def avg_pool2(x):
    """2x2/stride-2 mean over dims (-2, -1) of (..., H, W); odd trailing
    rows/cols are dropped (torch avg_pool2d semantics)."""
    H2, W2 = x.shape[-2] // 2, x.shape[-1] // 2
    x = x[..., :2 * H2, :2 * W2]
    return x.reshape(x.shape[:-2] + (H2, 2, W2, 2)).mean(dim=(-3, -1))


def build_pyramid(fmap1, fmap2, num_levels=4):
    """Correlation pyramid: list of (E, HW, H/2^l, W/2^l) volumes."""
    vol = corr_volume(fmap1, fmap2)
    pyramid = [vol]
    for _ in range(num_levels - 1):
        vol = avg_pool2(vol)
        pyramid.append(vol)
    return pyramid


def _floor_index(v):
    """floor(v) as int64, with NaN and huge values sent far out of range
    (their taps read as out of bounds)."""
    return torch.nan_to_num(v, nan=-1e6).clamp(-1e6, 1e6).long()


def _lookup_level(vol, coords, radius):
    """Sample a (2r+1)^2 window from one level.

    vol: (E, HW1, H2, W2); coords: (E, HW1, 2) in this level's pixels.
    Returns (E, HW1, (2r+1)^2), dx-major.
    """
    E, HW1, H2, W2 = vol.shape
    r = radius
    S = 2 * r + 2
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None, None]
    fy = (y - y0)[..., None, None]
    bx = _floor_index(x0) - r
    by = _floor_index(y0) - r

    d = torch.arange(S, device=vol.device)
    ys = by[..., None, None] + d[:, None]
    xs = bx[..., None, None] + d[None, :]
    inb = (ys >= 0) & (ys < H2) & (xs >= 0) & (xs < W2)
    flat_idx = (ys.clamp(0, H2 - 1) * W2 + xs.clamp(0, W2 - 1))
    patch = torch.gather(vol.reshape(E, HW1, H2 * W2), 2,
                         flat_idx.reshape(E, HW1, S * S))
    patch = torch.where(inb, patch.reshape(E, HW1, S, S), 0.0)

    w = 2 * r + 1
    p00 = patch[..., :w, :w]
    p01 = patch[..., :w, 1:]
    p10 = patch[..., 1:, :w]
    p11 = patch[..., 1:, 1:]
    out = ((1 - fy) * (1 - fx) * p00 + (1 - fy) * fx * p01 +
           fy * (1 - fx) * p10 + fy * fx * p11)
    # reference tap order is dx-major (correlation_kernels.cu:46-66)
    return out.transpose(-1, -2).reshape(E, HW1, w * w)


def lookup(pyramid, coords, radius=3):
    """Sample every level at level-0 coords (E, H, W, 2) [x, y] ->
    (E, H, W, num_levels*(2r+1)^2), level-major channels."""
    E, H, W, _ = coords.shape
    c = coords.reshape(E, H * W, 2).float()
    outs = [_lookup_level(vol, c / (2 ** lvl), radius)
            for lvl, vol in enumerate(pyramid)]
    return torch.cat(outs, dim=-1).reshape(E, H, W, -1)


def corr_and_lookup(fmap1, fmap2, coords, num_levels=4, radius=3):
    """Fused build + sample for a set of edges whose volume is transient."""
    return lookup(build_pyramid(fmap1, fmap2, num_levels), coords, radius)


def chunked_corr_lookup(fmaps, ii, jj, coords, num_levels=4, radius=3,
                        chunk=8):
    """Lookup over many edges, ``chunk`` edges' volumes at a time.

    fmaps: (F, H, W, C) per-frame features; ii/jj: (E,) frame ids;
    coords: (E, H, W, 2)."""
    E = coords.shape[0]
    outs = []
    for s in range(0, E, chunk):
        i, j = ii[s:s + chunk], jj[s:s + chunk]
        outs.append(corr_and_lookup(fmaps[i], fmaps[j],
                                    coords[s:s + chunk], num_levels,
                                    radius))
    return torch.cat(outs, dim=0)
