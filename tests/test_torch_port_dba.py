"""Port parity: pvo_tpu_torch.vo.dba against pvo_tpu.vo.dba on the
shapes of tests/test_dba.py (7 frames, 4x6, ring graph with padded
edges and pairs). Tolerance 1e-5 abs/rel on poses and disparities: both
sides run the same f32 assembly and Cholesky solve; only the summation
order of the scatters differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.geom import projective
from pvo_tpu.lie import se3
from pvo_tpu.vo import dba as jdba
from pvo_tpu_torch.vo import dba as tdba

F, H, W = 7, 4, 6


def scene(seed, noise=0.03):
    rng = np.random.RandomState(seed)
    base = np.array([0.12, 0.0, 0.03, 0.0, 0.015, 0.0])
    tang = base * np.arange(F)[:, None] + 0.01 * rng.randn(F, 6)
    poses_gt = np.array(se3.exp(jnp.asarray(tang, jnp.float32)), np.float32)
    disps_gt = (0.8 + 0.2 * rng.rand(F, H, W)).astype(np.float32)
    intr = np.array([10.0, 10.0, W / 2.0, H / 2.0], np.float32)
    dp = noise * rng.randn(F, 6)
    dp[0] = 0.0
    poses = np.array(se3.mul(se3.exp(jnp.asarray(dp, jnp.float32)),
                             jnp.asarray(poses_gt)), np.float32)
    disps = np.clip(disps_gt + noise * rng.randn(F, H, W), 0.1,
                    None).astype(np.float32)
    return poses_gt, disps_gt, poses, disps, intr


def ring(n, r=2):
    ii, jj = zip(*[(i, j) for i in range(n) for j in range(n)
                   if i != j and abs(i - j) <= r])
    return np.array(ii, np.int64), np.array(jj, np.int64)


def inputs(seed, pad=3):
    poses_gt, disps_gt, poses, disps, intr = scene(seed)
    ii, jj = ring(F)
    target, _ = projective.projective_transform(
        jnp.asarray(poses_gt)[None], jnp.asarray(disps_gt)[None],
        jnp.broadcast_to(jnp.asarray(intr), (1, F, 4)), ii, jj)
    E = len(ii)
    target = np.concatenate([np.asarray(target[0], np.float32),
                             np.zeros((pad, H, W, 2), np.float32)])
    valid = np.arange(E + pad) < E
    weight = (np.random.RandomState(seed + 1).rand(E + pad, H, W, 2) *
              valid[:, None, None, None]).astype(np.float32)
    ii = np.pad(ii, (0, pad))
    jj = np.pad(jj, (0, pad))
    pa, pb, pv = jdba.build_edge_pairs(ii, valid, max_pairs=200)
    eta = (1e-3 * np.ones((F, H, W))).astype(np.float32)
    return poses, disps, intr, target, weight, eta, ii, jj, valid, pa, pb, pv


def test_build_edge_pairs_matches():
    ii, jj = ring(F)
    valid = np.ones(len(ii), bool)
    valid[3] = False
    for a, b in zip(tdba.build_edge_pairs(ii, valid, 200),
                    jdba.build_edge_pairs(ii, valid, 200)):
        np.testing.assert_array_equal(a, b)
    pa, pb, pv = tdba.build_edge_pairs(ii, valid)     # unpadded
    assert pv.all() and len(pa) == int(jdba.build_edge_pairs(
        ii, valid, 200)[2].sum())


@pytest.mark.parametrize("case", [
    dict(t0=1, t1=F, w0=0, P=F, K=F, iters=1),
    dict(t0=1, t1=F, w0=0, P=F - 1, K=F, iters=2),
    dict(t0=2, t1=F, w0=0, P=F - 2, K=F, iters=2, motion_only=True),
    dict(t0=1, t1=F - 1, w0=0, P=F - 2, K=F, iters=2, ep=1e-2, lm=1e-5),
])
def test_dba_matches_jax(case):
    args = inputs(0)
    J = [jnp.asarray(a) for a in args]
    T = [torch.from_numpy(np.asarray(a)) for a in args]
    pj, dj = jdba.dba(*J, case["t0"], case["t1"], case["w0"],
                      **{k: v for k, v in case.items()
                         if k not in ("t0", "t1", "w0")})
    pt, dt = tdba.dba(*T, case["t0"], case["t1"], case["w0"],
                      **{k: v for k, v in case.items()
                         if k not in ("t0", "t1", "w0")})
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
