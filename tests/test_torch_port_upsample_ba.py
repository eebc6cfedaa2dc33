"""Port parity: upsampling, the BA steps and this slice's repairs in
pvo_tpu_torch.geom / lie against pvo_tpu.geom / lie.

The same float32 inputs (numpy, seeded) go through the JAX function and
its PyTorch port. Tolerance 1e-5 (abs and rel) where both sides run the
same f32 formulas and only the summation order differs; the BA steps,
which solve a damped linear system, are held to 1e-4 (stated per test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.geom import ba as jba
from pvo_tpu.geom import chol as jchol
from pvo_tpu.geom import projective as jproj
from pvo_tpu.geom import upsample as jup
from pvo_tpu.lie import se3 as jse3
from pvo_tpu.vo.video import DepthVideo as JaxDepthVideo
from pvo_tpu_torch.geom import ba as tba
from pvo_tpu_torch.geom import chol as tchol
from pvo_tpu_torch.geom import projective as tproj
from pvo_tpu_torch.geom import upsample as tup
from pvo_tpu_torch.lie import se3 as tse3
from pvo_tpu_torch.vo.video import DepthVideo

TOL = dict(rtol=1e-5, atol=1e-5)
BA_TOL = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy
J = jnp.asarray


def f32(a):
    return np.array(a, np.float32)


def close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **tol)


def rand_poses(rng, n, scale=0.3):
    return f32(jse3.exp(J(f32(scale * rng.randn(n, 6)))))


# ------------------------------------------------------------ repairs

@pytest.mark.parametrize("op", ["matrix", "from_matrix", "normalize",
                                "roundtrip"])
def test_se3_matrix_ops(op):
    """from_matrix is fed rotations about every axis by up to pi, so that
    each of its four pivot branches is taken."""
    rng = np.random.RandomState(0)
    tau = f32(rng.randn(12, 6))
    tau[:4, 3:] = f32(np.pi * np.eye(4, 3, k=-1) + 0.01 * rng.randn(4, 3))
    g = f32(jse3.exp(J(tau)))
    mats = f32(jse3.matrix(J(g)))
    if op == "matrix":
        close(tse3.matrix(T(g)), jse3.matrix(J(g)))
        close(tse3.matrix(T(g))[..., 3, :], np.tile([0, 0, 0, 1.0], (12, 1)))
    elif op == "from_matrix":
        close(tse3.from_matrix(T(mats)), jse3.from_matrix(J(mats)))
    elif op == "normalize":
        q = g * f32(1.0 + rng.rand(12, 1))
        close(tse3.normalize(T(q)), jse3.normalize(J(q)))
    else:
        close(tse3.matrix(tse3.from_matrix(T(mats))), mats)


def scene(rng, P=5, H=4, W=6):
    poses = rand_poses(rng, P, 0.1)
    disps = f32(0.5 + rng.rand(P, H, W))
    intr = f32([[10.0, 11.0, W / 2.0, H / 2.0]] * P)
    return poses, disps, intr


def test_jacobian_planes_without_pose_jacobians():
    rng = np.random.RandomState(3)
    poses, disps, intr = scene(rng)
    ii, jj = np.array([0, 1, 2, 3, 4, 2]), np.array([1, 0, 3, 2, 1, 4])
    pt = tproj.projective_jacobian_planes(
        *[T(a[None]) for a in (poses, disps, intr)], ii, jj, pose_jac=False)
    pj = jproj.projective_jacobian_planes(
        *[J(a[None]) for a in (poses, disps, intr)], ii, jj, pose_jac=False)
    assert pt[2] is None and pt[3] is None
    assert pj[2] is None and pj[3] is None
    for k in (0, 1, 4):
        close(pt[k], pj[k])
    full = tproj.projective_jacobian_planes(
        *[T(a[None]) for a in (poses, disps, intr)], ii, jj)
    assert torch.equal(full[4], pt[4]) and full[2] is not None


def test_induced_flow():
    rng = np.random.RandomState(4)
    poses, disps, intr = scene(rng)
    ii, jj = np.array([0, 1, 4]), np.array([1, 3, 2])
    ft, vt = tproj.induced_flow(*[T(a[None]) for a in (poses, disps, intr)],
                                ii, jj)
    fj, vj = jproj.induced_flow(*[J(a[None]) for a in (poses, disps, intr)],
                                ii, jj)
    assert ft.shape == (1, 3, 4, 6, 2)
    close(ft, fj)
    close(vt, vj)


def test_video_has_the_full_flow_buffer():
    """Ones, (buffer, h, w, 2) f32, as the JAX DepthVideo allocates it."""
    vt = DepthVideo(image_size=(32, 48), buffer=6)
    vj = JaxDepthVideo(image_size=(32, 48), buffer=6)
    assert vt.full_flow.dtype == torch.float32
    assert tuple(vt.full_flow.shape) == tuple(vj.full_flow.shape) == \
        (6, 4, 6, 2)
    close(vt.full_flow, vj.full_flow)


# ------------------------------------------------------------ upsample

@pytest.mark.parametrize("shape", [(2, 5, 7, 1), (1, 3, 4, 2)])
def test_cvx_upsample(shape):
    """A wrong tap, sub-pixel or axis order still gives a plausible map;
    only this comparison sees it. Unequal H, W and D, random logits."""
    rng = np.random.RandomState(sum(shape))
    B, H, W, D = shape
    data = f32(rng.randn(B, H, W, D))
    mask = f32(2.0 * rng.randn(B, H, W, 576))
    up = tup.cvx_upsample(T(data), T(mask))
    assert up.shape == (B, 8 * H, 8 * W, D)
    close(up, jup.cvx_upsample(J(data), J(mask)))


@pytest.mark.parametrize("shape", [(2, 3, 5, 2), (1, 2, 1, 4, 3),
                                   (1, 1, 6, 2), (2, 4, 1, 1)],
                         ids=["BHWD", "BEHWD", "H1", "W1"])
def test_upsample_inter(shape):
    """Bilinear x8 with end points mapped to end points, and its
    ``in_size == 1`` branch on either axis. The port repeats the JAX
    arithmetic, so 1e-5 holds."""
    rng = np.random.RandomState(len(shape))
    x = f32(rng.randn(*shape))
    up = tup.upsample_inter(T(x))
    assert up.shape == shape[:-3] + (8 * shape[-3], 8 * shape[-2], shape[-1])
    close(up, jup.upsample_inter(J(x)))
    H, W = shape[-3:-1]
    close(up[..., 0, 0, :], x[..., 0, 0, :])
    close(up[..., -1, -1, :], x[..., -1, -1, :])
    close(tup.bilinear_resize_align_corners(T(x), 11, 13),
          jup.bilinear_resize_align_corners(J(x), 11, 13))


def test_upsample_inter_is_torch_align_corners_interpolate():
    """Within 1e-5 of F.interpolate(align_corners=True), whose positions
    round differently."""
    x = f32(np.random.RandomState(9).randn(2, 5, 6, 3))
    ref = torch.nn.functional.interpolate(
        T(x).permute(0, 3, 1, 2), scale_factor=8, mode="bilinear",
        align_corners=True).permute(0, 2, 3, 1)
    close(tup.upsample_inter(T(x)), ref)


# ------------------------------------------------------------ solves, BA

def test_block_solve():
    rng = np.random.RandomState(5)
    B, N, D = 2, 3, 6
    A = f32(rng.randn(B, N * D, N * D))
    H = f32(A @ A.transpose(0, 2, 1) + 5 * np.eye(N * D))
    H[1] = -H[1]                     # not PSD: zero solution
    Hb = H.reshape(B, N, D, N, D).transpose(0, 1, 3, 2, 4).copy()
    b = f32(rng.randn(B, N, D))
    xt = tchol.block_solve(T(Hb), T(b))
    assert xt.shape == (B, N, D) and not xt[1].any()
    close(xt, jchol.block_solve(J(Hb), J(b)), BA_TOL)
    close(tchol.block_solve(T(Hb), T(b), ep=0.5, lm=1e-2),
          jchol.block_solve(J(Hb), J(b), ep=0.5, lm=1e-2), BA_TOL)


def ba_case(rng, F, ii, jj, H=6, W=8):
    """A window of F frames with targets near the true reprojection."""
    poses = rand_poses(rng, F, 0.05)
    disps = f32(0.5 + rng.rand(F, H, W))
    intr = f32([[12.0, 13.0, W / 2.0, H / 2.0]] * F)
    N = len(ii)
    coords, _ = jproj.projective_transform(
        J(poses[None]), J(disps[None]), J(intr[None]), ii, jj)
    target = f32(coords) + f32(0.3 * rng.randn(1, N, H, W, 2))
    weight = f32(rng.rand(1, N, H, W, 2))
    eta = f32(0.01 + 0.1 * rng.rand(1, len(np.unique(ii)), H, W))
    return target, weight, eta, poses[None], disps[None], intr[None]


RING4 = (np.array([0, 1, 1, 2, 2, 3, 3, 0, 0, 2]),
         np.array([1, 0, 2, 1, 3, 2, 0, 3, 2, 0]))


@pytest.mark.parametrize("F, edges, fixedp", [
    (2, (np.array([0, 1]), np.array([1, 0])), 2),
    (4, RING4, 2),
    (4, RING4, 1),
    (3, (np.array([2, 2, 1, 1]), np.array([0, 1, 2, 0])), 2),
], ids=["depth-only-F2", "ring-F4", "ring-F4-fixed1", "missing-source"])
def test_bundle_adjust(F, edges, fixedp):
    """The depth-only special case (no free pose: the export's 2-frame
    window), the full Schur step on a 4-ring with repeated source frames
    (the scatters must accumulate, and rows of fixed poses, whose free
    index is negative, must be dropped, not wrapped to the end), and a
    graph where one frame is no edge's source. 1e-4: a damped solve."""
    ii, jj = edges
    args = ba_case(np.random.RandomState(10 + F + fixedp), F, ii, jj)
    pt, dt = tba.bundle_adjust(*map(T, args), ii, jj, fixedp=fixedp)
    pj, dj = jba.bundle_adjust(*map(J, args), ii, jj, fixedp=fixedp)
    assert pt.shape == (1, F, 7) and dt.shape == args[4].shape
    close(pt, pj, BA_TOL)
    close(dt, dj, BA_TOL)
    moved = np.abs(np.asarray(pt) - args[3]).max(axis=-1)[0]
    assert not moved[:fixedp].any()
    assert (moved[fixedp:] > 0).all()
    assert np.abs(np.asarray(dt) - args[4]).max() > 1e-3


def test_bundle_adjust_depth_tail_resets_and_clamps():
    """Disparities pushed above 10 become 0 and negative ones clamp to
    0, as the JAX step's tail does."""
    ii, jj = np.array([0, 1]), np.array([1, 0])
    args = list(ba_case(np.random.RandomState(2), 2, ii, jj))
    args[0] = args[0] + f32(40.0)    # far targets: large depth steps
    args[1] = f32(1000.0 * args[1])
    _, dt = tba.bundle_adjust(*map(T, args), ii, jj, fixedp=2)
    _, dj = jba.bundle_adjust(*map(J, args), ii, jj, fixedp=2)
    close(dt, dj, BA_TOL)
    dt = dt.numpy()
    assert (dt == 0).any() and dt.min() >= 0 and dt.max() <= 10.0


@pytest.mark.parametrize("fixedp", [1, 2])
def test_motion_only_ba(fixedp):
    ii, jj = RING4
    args = ba_case(np.random.RandomState(20 + fixedp), 4, ii, jj)
    pt = tba.motion_only_ba(*map(T, args), ii, jj, fixedp=fixedp)
    pj = jba.motion_only_ba(*map(J, args), ii, jj, fixedp=fixedp)
    close(pt, pj, BA_TOL)
    assert not np.abs(pt.numpy() - args[3])[0, :fixedp].any()


def test_bundle_adjust_is_differentiable():
    """Out-of-place ops only: a gradient reaches target, weight and disps
    through the full step (values are not tested here)."""
    ii, jj = RING4
    args = [T(a).requires_grad_(k in (0, 1, 4)) for k, a in enumerate(
        ba_case(np.random.RandomState(7), 4, ii, jj))]
    poses, disps = tba.bundle_adjust(*args, ii, jj, fixedp=2)
    (poses.sum() + disps.sum()).backward()
    for k in (0, 1, 4):
        assert torch.isfinite(args[k].grad).all() and args[k].grad.any()
