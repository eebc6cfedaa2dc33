"""All-pairs correlation pyramid + windowed lookup, plain PyTorch.

Port of :mod:`pvo_tpu.vo.net.corr`. This is the plain version beside
the hand-written CUDA kernels of :mod:`.cuda_corr`: the path every call
site takes on the CPU, and the oracle the kernels are checked against.

* the all-pairs volume is one batched matmul (scaled by 1/16 like the
  reference); pyramid levels correlate against 2x2 average pools
  (floor) of fmap2, each pooled level rounded to the feature dtype and
  pooled from the rounded one, as ``pallas_corr.build_padded_pyramid``
  pools (for f32 features this equals pooling the volume);
* the (2r+1)^2 bilinear window uses the shared-fraction patch trick:
  all taps share one fraction, so an (2r+2)^2 integer patch is gathered
  per query pixel and 4 shifted views are blended;
* out-of-bounds taps contribute zero;
* taps are emitted in the reference's dx-major order.
"""

from __future__ import annotations

import torch


def corr_volume(fmap1, fmap2):
    """fmap1 (E, H, W, C), fmap2 (E, H2, W2, C) -> (E, H*W, H2, W2) f32
    volume, scaled by 1/16."""
    E, H, W, C = fmap1.shape
    H2, W2 = fmap2.shape[1:3]
    f1 = fmap1.reshape(E, H * W, C).float() / 4.0
    f2 = fmap2.reshape(E, H2 * W2, C).float() / 4.0
    return torch.bmm(f1, f2.transpose(1, 2)).reshape(E, H * W, H2, W2)


def pool_features(fmap, num_levels=4):
    """(E, H, W, C) -> ``num_levels`` f32 levels (E, H_l, W_l, C): level
    l+1 is the 2x2 mean (floor) of level l taken in f32 and rounded to
    fmap's dtype, so bf16 features pool as the JAX package's Pallas
    kernels pool them."""
    levels = [fmap.float()]
    f = fmap
    for _ in range(num_levels - 1):
        E, H, W, C = f.shape
        f = f[:, :2 * (H // 2), :2 * (W // 2)].float().reshape(
            E, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4)).to(fmap.dtype)
        levels.append(f.float())
    return levels


def build_pyramid(fmap1, fmap2, num_levels=4):
    """Correlation pyramid: list of (E, HW, H/2^l, W/2^l) volumes, level
    l against :func:`pool_features` level l of fmap2."""
    return [corr_volume(fmap1, f2) for f2 in pool_features(fmap2,
                                                          num_levels)]


def _floor_index(v):
    """floor(v) as int64, with NaN and huge values sent far out of range
    (their taps read as out of bounds)."""
    return torch.nan_to_num(v, nan=-1e6).clamp(-1e6, 1e6).long()


def gather_patch(vol, coords, radius):
    """The (2r+2)^2 integer taps under each query's window.

    vol: (E, HW1, H2, W2); coords: (E, HW1, 2) in this level's pixels.
    Returns (patch, fx, fy): patch (E, HW1, 2r+2, 2r+2) [dy, dx], tap
    (dy, dx) at (floor(y) - r + dy, floor(x) - r + dx), zero out of
    bounds; fx, fy (E, HW1) the bilinear fractions all taps share.
    """
    E, HW1, H2, W2 = vol.shape
    r = radius
    S = 2 * r + 2
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
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
    return patch, x - x0, y - y0


def _lookup_level(vol, coords, radius):
    """Sample a (2r+1)^2 window from one level.

    vol: (E, HW1, H2, W2); coords: (E, HW1, 2) in this level's pixels.
    Returns (E, HW1, (2r+1)^2), dx-major.
    """
    E, HW1 = vol.shape[:2]
    patch, fx, fy = gather_patch(vol, coords, radius)
    fx, fy = fx[..., None, None], fy[..., None, None]
    w = 2 * radius + 1
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
    coords: (E, H, W, 2). The features are widened to f32 before the
    pyramid, as the JAX package's XLA lookup (its path off the TPU)
    widens them."""
    E = coords.shape[0]
    outs = []
    for s in range(0, E, chunk):
        i, j = ii[s:s + chunk], jj[s:s + chunk]
        outs.append(corr_and_lookup(fmaps[i].float(), fmaps[j].float(),
                                    coords[s:s + chunk], num_levels,
                                    radius))
    return torch.cat(outs, dim=0)
