"""The port's Sim(3) group and depth filter against the JAX package.

Sim(3) (``pvo_tpu_torch/lie/sim3.py``) on the cases of
``tests/test_lie.py``'s ``TestSim3``, in f32, within 1e-6 of
:mod:`pvo_tpu.lie.sim3` on the same seeded inputs.
``depth_consistency_count`` and ``backproject_points``
(``pvo_tpu_torch/geom/depth_filter.py``, plain torch) on seeded poses and
disparities: counts exactly equal, points within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.geom import depth_filter as jdf
from pvo_tpu.lie import se3 as jse3
from pvo_tpu.lie import sim3 as jsim3
from pvo_tpu_torch.geom import depth_filter as tdf
from pvo_tpu_torch.lie import se3 as tse3
from pvo_tpu_torch.lie import sim3 as tsim3
from torch_one_thread import one_thread  # noqa: F401


TOL = 1e-6


def tangent(dim, n=32, sigma=1.0, seed=0):
    return (sigma * np.random.RandomState(seed).randn(n, dim)).astype(
        np.float32)


def both(fn_j, fn_t, *arrays):
    """(JAX result, port result) of the same f32 inputs, as numpy."""
    out_j = fn_j(*(jnp.asarray(a) for a in arrays))
    out_t = fn_t(*(torch.from_numpy(a) for a in arrays))
    return np.asarray(out_j), out_t.numpy()


SIM3_CASES = {
    # tests/test_lie.py TestSim3, each op on the case's inputs
    "exp": (lambda m: m.exp, (tangent(7, sigma=0.5),)),
    "exp_log_roundtrip": (lambda m: lambda x: m.log(m.exp(x)),
                          (tangent(7, sigma=0.5),)),
    "small_angle_roundtrip": (lambda m: lambda x: m.log(m.exp(x)),
                              (tangent(7, sigma=1e-7),)),
    "mul_inv": (lambda m: lambda x: m.mul(m.exp(x), m.inv(m.exp(x))),
                (tangent(7, sigma=0.5),)),
    "mul": (lambda m: lambda a, b: m.mul(m.exp(a), m.exp(b)),
            (tangent(7, sigma=0.5), tangent(7, sigma=0.5, seed=1))),
    "inv": (lambda m: lambda x: m.inv(m.exp(x)), (tangent(7, sigma=0.5),)),
    "act": (lambda m: lambda x, p: m.act(m.exp(x), p),
            (tangent(7, sigma=0.5), tangent(3, seed=2))),
    "act4": (lambda m: lambda x, p: m.act4(m.exp(x), p),
             (tangent(7, sigma=0.5), tangent(4, seed=3))),
}


@pytest.mark.parametrize("case", sorted(SIM3_CASES))
def test_sim3_matches_jax(case):
    make, inputs = SIM3_CASES[case]
    got_j, got_t = both(make(jsim3), make(tsim3), *inputs)
    assert got_t.dtype == np.float32
    np.testing.assert_allclose(got_t, got_j, rtol=0, atol=TOL)


def test_sim3_se3_embedding_matches_jax():
    """test_se3_embedding: an SE3 pose embedded with unit scale acts on
    points as the SE3 pose does, on both sides."""
    g, p = tangent(6), tangent(3, seed=1)
    want = np.asarray(jsim3.act(jsim3.from_se3(jse3.exp(jnp.asarray(g))),
                                jnp.asarray(p)))
    got = tsim3.act(tsim3.from_se3(tse3.exp(torch.from_numpy(g))),
                    torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    se3_only = tse3.act(tse3.exp(torch.from_numpy(g)),
                        torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, se3_only, rtol=0, atol=TOL)


def test_sim3_identity_and_scale_action_match_jax():
    """test_scale_action: the identity with scale 2 doubles points."""
    g_j = jsim3.identity((1,)).at[..., 7].set(2.0)
    g_t = tsim3.identity((1,))
    g_t[..., 7] = 2.0
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    p = np.ones((1, 3), np.float32)
    got = tsim3.act(g_t, torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsim3.act(g_j, p)),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(got, 2.0 * p)


# ------------------------------------------------ depth filter

F, HF, WF = 9, 12, 16


def video(seed):
    """Seeded keyframe poses (w2c, small motions) and disparities."""
    rng = np.random.RandomState(seed)
    tang = np.zeros((F, 6), np.float32)
    tang[:, 2] = 0.05 * np.arange(F)
    tang += 0.01 * rng.randn(F, 6).astype(np.float32)
    poses = np.array(jse3.exp(jnp.asarray(tang)), np.float32)
    disps = rng.uniform(0.2, 1.0, (F, HF, WF)).astype(np.float32)
    intr = np.array([12.0, 12.0, WF / 2, HF / 2], np.float32)
    return poses, disps, intr


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("frames", ["all", "inner"])
def test_depth_consistency_count_matches_jax(seed, frames):
    poses, disps, intr = video(seed)
    inds = np.arange(F) if frames == "all" else np.array([2, 4, 5])
    thresh = (0.05 * np.sqrt(disps[inds].mean(axis=(1, 2)))).astype(
        np.float32)
    want = np.asarray(jdf.depth_consistency_count(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(inds), jnp.asarray(thresh)))
    got = tdf.depth_consistency_count(
        torch.from_numpy(poses), torch.from_numpy(disps),
        torch.from_numpy(intr), torch.from_numpy(inds),
        torch.from_numpy(thresh)).numpy()
    assert got.shape == (len(inds), HF, WF) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the case is not trivial: some pixels are seen by some neighbours
    assert 0 < got.mean() < 6


@pytest.mark.parametrize("seed", [0, 1])
def test_backproject_points_matches_jax(seed):
    poses, disps, intr = video(seed)
    inds = np.array([0, 3, 8])
    want = np.asarray(jdf.backproject_points(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(inds)))
    got = tdf.backproject_points(
        torch.from_numpy(poses), torch.from_numpy(disps),
        torch.from_numpy(intr), torch.from_numpy(inds)).numpy()
    assert got.shape == (3, HF, WF, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
