"""Backward passes of the port's training path against ``jax.grad``.

(a) ``GradientClip``: identity forward; the backward zeroes entries
    with |g| > clip and NaN entries.
(b) ``chol.solve_psd``: values and gradients against the JAX
    ``custom_vjp`` within 1e-5 (float64), on a batch with PSD entries
    and entries whose factorization fails (indefinite, and NaN): a zero
    solution, zero ``db`` and no NaN in ``dH`` there. Autograd through
    the factorization, as the port had it, gives a symmetrized ``dH``
    and NaN on the NaN entry.
(c) ``geom.ba.bundle_adjust`` gradients (w.r.t. target, weight, eta,
    poses and disparities) against ``jax.grad`` of the JAX function on
    the losses of tests/test_ba.py (``test_gradients_flow``: full BA
    with two fixed poses; ``test_grads_flow_depth_only``: every pose
    fixed), float64, within 1e-4 relative.
(d) se3/sim3 ``log``/``exp`` gradients at the identity and near pi:
    finite and equal to JAX's (1e-6 relative, float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.geom import projective as jproj
from pvo_tpu.geom.ba import bundle_adjust as jax_ba
from pvo_tpu.geom.chol import solve_psd as jax_solve_psd
from pvo_tpu.lie import se3 as jse3
from pvo_tpu.lie import sim3 as jsim3
from pvo_tpu_torch.geom.ba import bundle_adjust
from pvo_tpu_torch.geom.chol import solve_psd
from pvo_tpu_torch.lie import se3, sim3
from pvo_tpu_torch.vo.net.layers import GradientClip, grad_clip

from test_ba import P, graph_all_pairs, make_scene
from torch_one_thread import one_thread  # noqa: F401


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64,
                        requires_grad=True)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---- (a) GradientClip

def test_gradient_clip_zeroes_large_and_nan_entries():
    x = torch.randn(2, 3, 4, 5, requires_grad=True)
    g = torch.full_like(x, 0.005)
    g[0, 0, 0, 0] = 0.02
    g[0, 1, 0, 0] = -0.5
    g[1, 0, 0, 0] = float("nan")
    g[1, 1, 0, 0] = -0.01          # |g| == clip: kept
    y = GradientClip()(x)
    assert torch.equal(y, x)
    y.backward(g)
    want = g.clone()
    want[0, 0, 0, 0] = want[0, 1, 0, 0] = want[1, 0, 0, 0] = 0.0
    assert torch.equal(x.grad, want)
    # the clip is a parameter of the module and of the function
    x.grad = None
    grad_clip(x, 1.0).backward(g)
    assert x.grad[0, 1, 0, 0] == -0.5 and x.grad[1, 0, 0, 0] == 0


def test_update_heads_clip_their_gradients():
    """Every head's output and GraphAgg's eta sit behind a clip of 0.01
    (update.py:31-39, :71)."""
    from pvo_tpu_torch.vo.net.update import DynamicUpdateModule
    upd = DynamicUpdateModule(use_aff_bri=True)
    for head in ("delta", "delta_dy", "weight", "delta_mask"):
        assert isinstance(getattr(upd, head)[-1], GradientClip)
        assert getattr(upd, head)[-1].clip == 0.01
    assert isinstance(upd.agg.eta[1], GradientClip)
    assert isinstance(upd.global_avg_pool[-1], GradientClip)


# ---- (b) solve_psd

def psd_batch(seed=0, M=6, K=2):
    """Two PSD entries, one indefinite, one with a NaN entry."""
    rng = np.random.RandomState(seed)
    A = rng.randn(4, M, M)
    H = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(M)
    H[2] = -H[2]
    H[3, 1, 2] = H[3, 2, 1] = np.nan
    b = rng.randn(4, M, K)
    w = rng.randn(4, M, K)
    return H, b, w


def test_solve_psd_values_and_implicit_backward_match_jax():
    H, b, w = psd_batch()

    def jloss(H, b):
        return jnp.sum(jax_solve_psd(H, b) * w)

    xj = np.asarray(jax_solve_psd(jnp.asarray(H), jnp.asarray(b)))
    gH, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(H), jnp.asarray(b))

    Ht, bt = t64(H), t64(b)
    x = solve_psd(Ht, bt)
    (x * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.detach().numpy(), xj, rtol=1e-5,
                               atol=1e-12)
    assert not x[2:].detach().any()
    np.testing.assert_allclose(Ht.grad.numpy(), np.asarray(gH), rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), rtol=1e-5,
                               atol=1e-12)
    # the failed entries: zero db, zero dH, nothing non-finite
    assert torch.isfinite(Ht.grad).all() and torch.isfinite(bt.grad).all()
    assert not bt.grad[2:].any() and not Ht.grad[2:].any()
    # the implicit dH = -x dz^T is not symmetric
    assert not torch.allclose(Ht.grad[0], Ht.grad[0].T)


# ---- (c) bundle_adjust

def ba_case(kind):
    """tests/test_ba.py's scenes and losses: (JAX args, loss kwargs)."""
    if kind == "full":
        poses_gt, disps_gt, poses, disps, intr = make_scene(
            jax.random.PRNGKey(6))
        ii, jj = graph_all_pairs()
        target, _ = jproj.projective_transform(poses_gt, disps_gt, intr,
                                               ii, jj)
        weight = jnp.ones_like(target)
        fixedp = 2
    else:
        poses_gt, disps_gt, poses, disps, intr = make_scene(
            jax.random.PRNGKey(11))
        ii, jj = graph_all_pairs()
        target, _ = jproj.projective_transform(poses_gt, disps_gt, intr,
                                               ii, jj)
        target = target + 0.3
        weight = 0.5 + 0.5 * jax.random.uniform(
            jax.random.PRNGKey(12), target.shape, dtype=target.dtype)
        fixedp = P
    eta = 1e-4 * jnp.ones((1, len(np.unique(ii))) + disps.shape[2:],
                          dtype=jnp.float64)
    return (target, weight, eta, poses, disps, intr), poses_gt, ii, jj, \
        fixedp


@pytest.mark.parametrize("kind", ["full", "depth_only"])
def test_bundle_adjust_gradients_match_jax(kind):
    args, poses_gt, ii, jj, fixedp = ba_case(kind)
    intr = args[-1]

    def jloss(t, w, e, p, d):
        p1, d1 = jax_ba(t, w, e, p, d, intr, ii, jj, fixedp=fixedp)
        return jnp.sum((p1 - poses_gt) ** 2) + 1e-3 * jnp.sum(d1 ** 2)

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(*args[:5])
    tt = [t64(a) for a in args[:5]]
    p1, d1 = bundle_adjust(*tt, torch.from_numpy(np.asarray(intr)), ii, jj,
                           fixedp=fixedp)
    loss = ((p1 - torch.from_numpy(np.asarray(poses_gt))) ** 2).sum() + \
        1e-3 * (d1 ** 2).sum()
    loss.backward()
    for name, a, g in zip(("target", "weight", "eta", "poses", "disps"),
                          tt, gj):
        assert torch.isfinite(a.grad).all(), name
        g = np.asarray(g)
        if not np.any(g):
            assert not a.grad.any(), name
            continue
        assert rel(a.grad.numpy(), g) < 1e-4, (name, rel(a.grad.numpy(), g))
    assert float(np.abs(np.asarray(gj[0])).max()) > 0


# ---- (d) Lie group gradients at the identity and near pi

NEAR_PI = np.pi - 1e-3


def tangents(kind, dim, seed=0):
    """Three tangents [rho, phi(, sigma)]: zero, or a rotation of
    NEAR_PI about a random axis with small rho and sigma."""
    if kind == "identity":
        return np.zeros((3, dim))
    rng = np.random.RandomState(seed)
    x = 0.3 * rng.randn(3, dim)
    axis = rng.randn(3, 3)
    x[:, 3:6] = NEAR_PI * axis / np.linalg.norm(axis, axis=-1,
                                                keepdims=True)
    return x


@pytest.mark.parametrize("group", ["se3", "sim3"])
@pytest.mark.parametrize("kind", ["identity", "near_pi"])
def test_lie_log_exp_gradients_match_jax(group, kind):
    mods = {"se3": (jse3, se3, 6), "sim3": (jsim3, sim3, 7)}
    jm, tm, dim = mods[group]
    tau = tangents(kind, dim)
    w = np.random.RandomState(1).randn(3, dim + 1)
    w2 = np.random.RandomState(2).randn(3, dim)

    def jloss(x):
        g = jm.exp(x)
        return jnp.sum(g * w) + jnp.sum(jm.log(g) * w2)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(tau)))
    x = t64(tau)
    g = tm.exp(x)
    ((g * torch.from_numpy(w)).sum() +
     (tm.log(g) * torch.from_numpy(w2)).sum()).backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), gj, rtol=1e-6, atol=1e-9)
    # log alone on the group elements, at those points
    gx = jm.exp(jnp.asarray(tau))
    gl = np.asarray(jax.grad(lambda y: jnp.sum(jm.log(y) * w2))(gx))
    y = t64(gx)
    (tm.log(y) * torch.from_numpy(w2)).sum().backward()
    assert torch.isfinite(y.grad).all()
    np.testing.assert_allclose(y.grad.numpy(), gl, rtol=1e-6, atol=1e-9)
