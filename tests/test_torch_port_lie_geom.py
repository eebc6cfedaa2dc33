"""Port parity: pvo_tpu_torch.lie / geom against pvo_tpu.lie / geom.

The same float32 inputs (numpy, seeded) go through the JAX function and
its PyTorch port. Tolerance 1e-5 (abs and rel) throughout: both sides
run the same f32 formulas, so only summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.geom import ba as jba
from pvo_tpu.geom import chol as jchol
from pvo_tpu.geom import distance as jdist
from pvo_tpu.geom import projective as jproj
from pvo_tpu.lie import se3 as jse3
from pvo_tpu_torch.geom import ba as tba
from pvo_tpu_torch.geom import chol as tchol
from pvo_tpu_torch.geom import distance as tdist
from pvo_tpu_torch.geom import projective as tproj
from pvo_tpu_torch.lie import se3 as tse3

TOL = dict(rtol=1e-5, atol=1e-5)


def f32(a):
    return np.array(a, np.float32)


def close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)


def rand_poses(rng, n, scale=0.3):
    tau = f32(scale * rng.randn(n, 6))
    return f32(jse3.exp(jnp.asarray(tau)))


@pytest.mark.parametrize("op", ["mul", "inv", "act", "act4", "exp", "log",
                                "retr", "adj", "adjT", "identity"])
def test_se3_ops(op):
    rng = np.random.RandomState(0)
    g1, g2 = rand_poses(rng, 5), rand_poses(rng, 5)
    tau = f32(0.4 * rng.randn(5, 6))
    tau[0] = 1e-5 * tau[0]           # small-angle branch
    p3, p4 = f32(rng.randn(5, 3)), f32(rng.randn(5, 4))
    T = torch.from_numpy
    J = jnp.asarray
    cases = {
        "mul": (lambda m, a: m.mul(a(g1), a(g2))),
        "inv": (lambda m, a: m.inv(a(g1))),
        "act": (lambda m, a: m.act(a(g1), a(p3))),
        "act4": (lambda m, a: m.act4(a(g1), a(p4))),
        "exp": (lambda m, a: m.exp(a(tau))),
        "log": (lambda m, a: m.log(a(g1))),
        "retr": (lambda m, a: m.retr(a(g1), a(tau))),
        "adj": (lambda m, a: m.adj(a(g1), a(tau))),
        "adjT": (lambda m, a: m.adjT(a(g1), a(tau))),
        "identity": (lambda m, a: m.identity((3,))),
    }
    close(cases[op](tse3, T), cases[op](jse3, J))


def scene(rng, P=5, H=4, W=6):
    poses = rand_poses(rng, P, 0.1)
    disps = f32(0.5 + rng.rand(P, H, W))
    intr = f32([[10.0, 11.0, W / 2.0, H / 2.0]] * P)
    ii = np.array([0, 1, 2, 3, 4, 2], np.int64)
    jj = np.array([1, 0, 3, 2, 1, 4], np.int64)
    return poses, disps, intr, ii, jj


def test_coords_grid_iproj_proj():
    rng = np.random.RandomState(1)
    poses, disps, intr, ii, jj = scene(rng)
    close(tproj.coords_grid(4, 6), jproj.coords_grid(4, 6))
    X_t = tproj.iproj(torch.from_numpy(disps[None]),
                      torch.from_numpy(intr[None]))
    X_j = jproj.iproj(jnp.asarray(disps[None]), jnp.asarray(intr[None]))
    close(X_t, X_j)
    Xs = f32(np.asarray(X_j)) + f32(0.1 * rng.randn(*X_j.shape))
    for jac in (False, True):
        ct, Jt = tproj.proj(torch.from_numpy(Xs), torch.from_numpy(
            intr[None]), jacobian=jac)
        cj, Jj = jproj.proj(jnp.asarray(Xs), jnp.asarray(intr[None]),
                            jacobian=jac)
        close(ct, cj)
        if jac:
            close(Jt, Jj)


def test_act_se3_jacobian():
    rng = np.random.RandomState(2)
    G = rand_poses(rng, 3)[None]
    X0 = f32(rng.randn(1, 3, 4, 6, 4))
    Xt, Jt = tproj.act_se3(torch.from_numpy(G), torch.from_numpy(X0), True)
    Xj, Jj = jproj.act_se3(jnp.asarray(G), jnp.asarray(X0), True)
    close(Xt, Xj)
    close(Jt, Jj)


def test_projective_transform_and_planes():
    rng = np.random.RandomState(3)
    poses, disps, intr, ii, jj = scene(rng)
    args_t = [torch.from_numpy(a[None]) for a in (poses, disps, intr)]
    args_j = [jnp.asarray(a[None]) for a in (poses, disps, intr)]
    ct, vt, (Jit, Jjt, Jzt) = tproj.projective_transform(
        *args_t, ii, jj, jacobian=True)
    cj, vj, (Jij, Jjj, Jzj) = jproj.projective_transform(
        *args_j, ii, jj, jacobian=True)
    for a, b in ((ct, cj), (vt, vj), (Jit, Jij), (Jjt, Jjj), (Jzt, Jzj)):
        close(a, b)
    pt = tproj.projective_jacobian_planes(*args_t, ii, jj)
    pj = jproj.projective_jacobian_planes(*args_j, ii, jj)
    for a, b in zip(pt, pj):
        close(a, b)


def test_solve_psd_and_schur():
    rng = np.random.RandomState(4)
    A = f32(rng.randn(2, 6, 6))
    H = f32(A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6))
    b = f32(rng.randn(2, 6, 1))
    H_bad = H.copy()
    H_bad[1] = -H_bad[1]             # not PSD: zero solution
    close(tchol.solve_psd(torch.from_numpy(H_bad), torch.from_numpy(b)),
          jchol.solve_psd(jnp.asarray(H_bad), jnp.asarray(b)))

    B, P, M, D, HW = 1, 3, 2, 6, 5
    Hb = f32(rng.randn(B, P * D, P * D))
    Hb = f32(Hb @ Hb.transpose(0, 2, 1) + 30 * np.eye(P * D))
    Hb = Hb.reshape(B, P, D, P, D).transpose(0, 1, 3, 2, 4)
    E = f32(0.3 * rng.randn(B, P, M, D, HW))
    C = f32(1.0 + rng.rand(B, M, HW))
    v = f32(rng.randn(B, P, D))
    w = f32(rng.randn(B, M, HW))
    out_t = tchol.schur_solve(*[torch.from_numpy(a) for a in (Hb, E, C, v,
                                                                w)])
    out_j = jchol.schur_solve(*[jnp.asarray(a) for a in (Hb, E, C, v, w)])
    for a, b_ in zip(out_t, out_j):
        close(a, b_)


def test_edge_blocks():
    rng = np.random.RandomState(5)
    poses, disps, intr, ii, jj = scene(rng)
    N, H, W = len(ii), 4, 6
    target = f32(rng.uniform(0, 6, (1, N, H, W, 2)))
    weight = f32(rng.rand(1, N, H, W, 2))
    out_t = tba._edge_blocks(*[torch.from_numpy(a) for a in (
        target, weight, poses[None], disps[None], intr[None])], ii, jj)
    out_j = jba._edge_blocks(*[jnp.asarray(a) for a in (
        target, weight, poses[None], disps[None], intr[None])], ii, jj)
    for a, b in zip(out_t, out_j):
        close(a, b)


def test_frame_distance_and_window_matrix():
    rng = np.random.RandomState(6)
    F = 9
    poses = rand_poses(rng, F, 0.05)
    disps = f32(0.5 + rng.rand(F, 4, 6))
    intr = f32([10.0, 11.0, 3.0, 2.0])
    ii = np.array([0, 2, 5, 7]), np.array([1, 4, 3, 8])
    T = [torch.from_numpy(a) for a in (poses, disps, intr)]
    J = [jnp.asarray(a) for a in (poses, disps, intr)]
    close(tdist.frame_distance(*T, *ii), jdist.frame_distance(*J, *ii))
    close(tdist.frame_distance_bidirectional(*T, *ii),
          jdist.frame_distance_bidirectional(*J, *map(jnp.asarray, ii)))
    for d0 in (0, 3, 7):             # 7: origin clamped like dynamic_slice
        close(tdist.window_distance_matrix(*T, d0, 4),
              jdist.window_distance_matrix(*J, d0, 4))
