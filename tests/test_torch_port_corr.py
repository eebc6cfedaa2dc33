"""Port parity: plain PyTorch correlation (vo/net/corr.py and the plain
versions in vo/net/cuda_corr.py) against pvo_tpu's XLA corr and its
Pallas kernels run in interpret mode, as tests/test_pallas_corr.py runs
them.

Tolerances: 1e-5 against the XLA corr (same f32 math); 1e-4 against
the fused Pallas lookup (f32 path, other summation order); 2e-2 where
the volume is stored in bf16 (K1 + K2), as in tests/test_pallas_corr.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vo.net import corr as jcorr
from pvo_tpu.vo.net.pallas_corr import (build_corr_volumes,
                                        pallas_corr_extract,
                                        pallas_corr_lookup)
from pvo_tpu_torch.vo.net import corr as tcorr
from pvo_tpu_torch.vo.net import cuda_corr

C = 16


def make(E, H, W, seed, lo=-2.0, hi=1.0, band=None):
    """f1, f2 (E,H,W,C) and coords (E,H,W,2) as float32 numpy; ``band``
    = (axis, lo, hi) biases half the pixels' coords into a border band."""
    rng = np.random.RandomState(seed)
    f1 = rng.randn(E, H, W, C).astype(np.float32)
    f2 = rng.randn(E, H, W, C).astype(np.float32)
    cx = rng.uniform(lo, W + hi, (E, H, W))
    cy = rng.uniform(lo, H + hi, (E, H, W))
    if band is not None:
        axis, b0, b1 = band
        c = cx if axis == "x" else cy
        c[..., W // 2:] = rng.uniform(b0, b1, c[..., W // 2:].shape)
    coords = np.stack([cx, cy], -1).astype(np.float32)
    return f1, f2, coords


def close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def test_corr_volume_and_pyramid():
    f1, f2, _ = make(2, 8, 12, 0)
    pt = tcorr.build_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    pj = jcorr.build_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    for a, b in zip(pt, pj):
        close(a, b, 1e-5)


@pytest.mark.parametrize("num_levels", [1, 3, 4])
def test_lookup_matches_xla(num_levels):
    f1, f2, coords = make(2, 8, 12, num_levels)
    T, J = torch.from_numpy, jnp.asarray
    out_t = tcorr.corr_and_lookup(T(f1), T(f2), T(coords), num_levels)
    out_j = jcorr.corr_and_lookup(J(f1), J(f2), J(coords), num_levels)
    close(out_t, out_j, 1e-5)


def test_dx_major_tap_order():
    """Integer coords on the pixel grid: tap (dx, dy) of level 0 is the
    correlation with pixel (x + dx - 3, y + dy - 3), channel dx*7+dy."""
    f1, f2, _ = make(1, 8, 12, 7)
    yy, xx = np.meshgrid(np.arange(8), np.arange(12), indexing="ij")
    coords = np.stack([xx, yy], -1)[None].astype(np.float32)
    out = tcorr.corr_and_lookup(torch.from_numpy(f1), torch.from_numpy(f2),
                                torch.from_numpy(coords), 1).numpy()
    y, x, dx, dy = 4, 5, 2, 6          # asymmetric offsets
    ref = f1[0, y, x] @ f2[0, y + dy - 3, x + dx - 3] / 16.0
    np.testing.assert_allclose(out[0, y, x, dx * 7 + dy], ref, rtol=1e-5)
    # window beyond the top-left corner: out-of-bounds taps are zero
    assert out[0, 0, 0, 0] == 0.0


def test_chunked_lookup_matches_xla():
    rng = np.random.RandomState(8)
    fm = rng.randn(5, 8, 12, C).astype(np.float32)
    ii = np.array([0, 1, 2, 3, 4, 1, 0], np.int64)
    jj = np.array([1, 2, 3, 4, 0, 3, 2], np.int64)
    _, _, coords = make(7, 8, 12, 9)
    out_t = tcorr.chunked_corr_lookup(torch.from_numpy(fm),
                                      torch.from_numpy(ii),
                                      torch.from_numpy(jj),
                                      torch.from_numpy(coords), chunk=3)
    out_j = jcorr.chunked_corr_lookup(jnp.asarray(fm), jnp.asarray(ii),
                                      jnp.asarray(jj), jnp.asarray(coords),
                                      chunk=3)
    close(out_t, out_j, 1e-5)


@pytest.mark.parametrize("geom", [
    (2, 8, 12, None),                  # out-of-bounds taps on all sides
    (1, 8, 156, ("x", 150.0, 160.0)),  # wide, windows over the right edge
    (1, 128, 40, ("y", 122.0, 131.0)),  # tall, windows over the bottom edge
])
def test_corr_lookup_plain_matches_pallas_fused(geom):
    E, H, W, band = geom
    f1, f2, coords = make(E, H, W, H + W, band=band)
    out_t = cuda_corr.corr_lookup(torch.from_numpy(f1), torch.from_numpy(f2),
                                  torch.from_numpy(coords))
    out_j = pallas_corr_lookup(jnp.asarray(f1), jnp.asarray(f2),
                               jnp.asarray(coords), num_levels=4, blk=32,
                               interpret=True)
    close(out_t, out_j, 1e-4)


def test_build_extract_plain_match_pallas_volume_path():
    E, H, W, L = 2, 8, 12, 3
    f1, f2, coords = make(E, H, W, 11, lo=-1.0, hi=0.5)
    T = torch.from_numpy
    vol_t = cuda_corr.build_volumes(T(f1), T(f2), L)
    vols_j, shapes = build_corr_volumes(jnp.asarray(f1), jnp.asarray(f2),
                                        num_levels=L, blk=32)
    # volumes level by level: the JAX layout is (E, HWp, sum H_l, 128)
    vj = np.asarray(vols_j, np.float32)
    off_row = off_col = 0
    for (h_l, w_l) in cuda_corr.level_shapes(H, W, L):
        a = vol_t[:, :, off_col:off_col + h_l * w_l].float()
        b = vj[:, :H * W, off_row:off_row + h_l, :w_l].reshape(E, H * W, -1)
        close(a, b, 2e-2)
        off_row += h_l
        off_col += h_l * w_l
    out_t = cuda_corr.corr_extract(vol_t, T(coords), L)
    out_j = pallas_corr_extract(vols_j, tuple(tuple(s) for s in shapes),
                                jnp.asarray(coords), blk=32, interpret=True)
    close(out_t, out_j, 2e-2)
    # and against the f32 lookup, up to the bf16 volume rounding
    close(out_t, jcorr.corr_and_lookup(jnp.asarray(f1), jnp.asarray(f2),
                                       jnp.asarray(coords), L), 2e-2)


def test_level_shapes_and_pyramid_layout():
    assert cuda_corr.level_shapes(30, 101) == [(30, 101), (15, 50), (7, 25),
                                               (3, 12)]
    assert sum(h * w for h, w in cuda_corr.level_shapes(30, 101)) == 3991
    f = torch.arange(2 * 5 * 7 * 3, dtype=torch.float32).reshape(2, 5, 7, 3)
    pyr = cuda_corr.pool_pyramid(f, 2)
    assert pyr.shape == (2, 35 + 6, 3)
    ref = f.numpy()[:, :4, :6].reshape(2, 2, 2, 3, 2, 3).mean(axis=(2, 4))
    np.testing.assert_allclose(pyr[:, 35:].numpy(), ref.reshape(2, 6, 3))


# ---- bf16 features: the pyramid is pooled level by level in bf16, as
# pallas_corr.build_padded_pyramid pools it. Pooling in f32 instead (the
# port before this was fixed) misses the fused Pallas lookup by 2.3e-3 at
# level 1 and leaves only about half of K1's bf16 entries bit-equal at
# levels 1-3 (E=2, 24x40, C=128).

def make_bf16(E, H, W, seed):
    _, _, coords = make(E, H, W, seed)
    rng = np.random.RandomState(seed + 1)
    f1 = rng.randn(E, H, W, 128).astype(np.float32)
    f2 = rng.randn(E, H, W, 128).astype(np.float32)
    T = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    J = lambda a: jnp.asarray(a, jnp.bfloat16)
    return (T(f1), T(f2)), (J(f1), J(f2)), coords


def test_corr_lookup_plain_bf16_matches_pallas_fused():
    E, H, W = 2, 24, 40
    (t1, t2), (j1, j2), coords = make_bf16(E, H, W, 5)
    out_t = cuda_corr.corr_lookup(t1, t2, torch.from_numpy(coords))
    out_j = pallas_corr_lookup(j1, j2, jnp.asarray(coords), num_levels=4,
                               blk=64, interpret=True)
    a = out_t.numpy().reshape(E, H, W, 4, 49)
    b = np.asarray(out_j).reshape(E, H, W, 4, 49)
    err = [float(np.abs(a[..., l, :] - b[..., l, :]).max()) for l in range(4)]
    assert max(err) <= 1e-4, err
    # the plain correlation of corr.py pools the same way
    close(tcorr.corr_and_lookup(t1, t2, torch.from_numpy(coords)), out_t,
          1e-6)


def test_build_volumes_plain_bf16_bit_equal_to_jax():
    E, H, W = 2, 24, 40
    (t1, t2), (j1, j2), _ = make_bf16(E, H, W, 6)
    vol_t = cuda_corr.build_volumes(t1, t2)
    assert vol_t.dtype == torch.bfloat16
    vols_j, _ = build_corr_volumes(j1, j2, num_levels=4)
    vj = np.asarray(vols_j.astype(jnp.float32))
    vt = vol_t.float().numpy()
    off_row = off_col = 0
    for (h_l, w_l) in cuda_corr.level_shapes(H, W):
        a = vt[:, :, off_col:off_col + h_l * w_l]
        b = vj[:, :H * W, off_row:off_row + h_l, :w_l].reshape(E, H * W, -1)
        assert np.mean(a == b) >= 0.999, (h_l, w_l, np.mean(a == b))
        off_row += h_l
        off_col += h_l * w_l
