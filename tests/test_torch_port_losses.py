"""The port's training losses (pvo_tpu_torch/vo/losses.py) against the
JAX module on the same numpy inputs from seeds.

Every loss's value within 1e-5 relative of the JAX function's (float64
on both sides), both branches of ``mean_on_mask`` (more and fewer than
its ``min_count`` of valid entries), and the gradients of
``geodesic_loss`` (both ``do_scale``: its ``fit_scale`` and metrics
detach, which only a gradient can show), ``cam_flow_loss``,
``photo_loss_full`` (with and without ``aff_params``),
``photo_loss_cam``, ``ssim_loss`` and ``gt_label_loss`` within 1e-5
relative L2. ``ssim_loss`` is also held against the reference SSIM
module re-derived in torch (tests/test_missing_features.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.lie import se3 as jse3
from pvo_tpu.vo import losses as jl
from pvo_tpu_torch.vo import losses as tl

from torch_one_thread import one_thread  # noqa: F401

RTOL = 1e-5
F = 3
# full-res frames: 4 ring edges of 40x64x3 = 30720 entries > min_count
H, W = 40, 64
II = np.array([0, 1, 1, 2, 2, 0])
JJ = np.array([1, 0, 2, 1, 0, 2])


def t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64,
                        requires_grad=grad)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close(a, b, rtol=RTOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert rel(a, b) <= rtol, rel(a, b)


def poses(seed, n=F, scale=0.1):
    tau = scale * np.random.RandomState(seed).randn(1, n, 6)
    return np.asarray(jse3.exp(jnp.asarray(tau)))


def images(seed, h=H, w=W):
    """A smooth texture shifted per frame (0..255, float64)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(h + 8, w + 8, 3)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(np.convolve, ax, base, k, mode="same")
    return 255.0 * np.stack([base[t:t + h, 2 * t:2 * t + w]
                             for t in range(F)])[None]


def intrinsics(h, w):
    return np.tile(np.array([0.8 * w, 0.8 * w, w / 2, h / 2]), (1, F, 1))


def disps(seed, h=H, w=W, n=2):
    rng = np.random.RandomState(seed)
    return [0.5 + rng.rand(1, F, h, w) for _ in range(n)]


def grads_match(tfn, jfn, args, argnums, rtol=RTOL):
    """The value and the gradients w.r.t. ``argnums`` of a scalar loss:
    ``tfn`` on float64 torch tensors, ``jfn`` on jnp arrays."""
    jv, jg = jax.jit(jax.value_and_grad(jfn, argnums=argnums))(
        *map(jnp.asarray, args))
    tt = [t(a, grad=i in argnums) for i, a in enumerate(args)]
    v = tfn(*tt)
    v.backward()
    close(v, jv, rtol)
    for i, g in zip(argnums, jg):
        assert torch.isfinite(tt[i].grad).all()
        close(tt[i].grad, g, rtol)


# ---- pose and flow losses

@pytest.mark.parametrize("do_scale", [True, False])
def test_geodesic_loss_and_gradients(do_scale):
    Ps = poses(0)
    Gs = [poses(s) for s in (1, 2)]

    def jfn(g0, g1):
        return jl.geodesic_loss(jnp.asarray(Ps), [g0, g1], II, JJ,
                                do_scale=do_scale)[0]

    def tfn(g0, g1):
        return tl.geodesic_loss(t(Ps), [g0, g1], II, JJ,
                                do_scale=do_scale)[0]

    grads_match(tfn, jfn, Gs, (0, 1))
    _, mj = jl.geodesic_loss(jnp.asarray(Ps), list(map(jnp.asarray, Gs)),
                             II, JJ, do_scale=do_scale)
    _, mt = tl.geodesic_loss(t(Ps), [t(g) for g in Gs], II, JJ,
                             do_scale=do_scale)
    assert mt.keys() == mj.keys()
    for k in mj:
        close(mt[k], mj[k])


def test_fit_scale():
    a, b = poses(3), poses(4)
    close(tl.fit_scale(t(a), t(b)), jl.fit_scale(jnp.asarray(a),
                                                 jnp.asarray(b)))


def test_residual_and_flow_losses():
    rng = np.random.RandomState(5)
    res = [rng.randn(1, 6, 5, 8, 2) for _ in range(3)]
    vt, mt = tl.residual_loss([t(r) for r in res])
    vj, mj = jl.residual_loss(list(map(jnp.asarray, res)))
    close(vt, vj)
    close(mt["residual"], mj["residual"])
    fo = np.concatenate([rng.randn(1, F - 1, 5, 8, 2),
                         rng.rand(1, F - 1, 5, 8, 1) > 0.3], -1)
    ba = np.concatenate([rng.randn(1, F - 1, 5, 8, 2),
                         rng.rand(1, F - 1, 5, 8, 1) > 0.3], -1)
    full = [rng.randn(1, 2 * (F - 1), 5, 8, 2) for _ in range(2)]
    vt, mt = tl.flow_loss(t(fo), t(ba), [t(f) for f in full])
    vj, mj = jl.flow_loss(jnp.asarray(fo), jnp.asarray(ba),
                          list(map(jnp.asarray, full)))
    close(vt, vj)
    close(mt["pure_f_error"], mj["pure_f_error"])


def test_cam_flow_loss_and_gradients():
    h, w = 16, 24
    Ps = poses(6, scale=0.05)
    dgt = disps(7, h, w, 1)[0]
    intr = intrinsics(h, w)
    est_p = [poses(s, scale=0.05) for s in (8, 9)]
    est_d = disps(10, h, w, 2)

    def jfn(p0, p1, d0, d1):
        return jl.cam_flow_loss(jnp.asarray(Ps), jnp.asarray(dgt), [p0, p1],
                                [d0, d1], jnp.asarray(intr))[0]

    def tfn(p0, p1, d0, d1):
        return tl.cam_flow_loss(t(Ps), t(dgt), [p0, p1], [d0, d1],
                                t(intr))[0]

    grads_match(tfn, jfn, est_p + est_d, (0, 1, 2, 3))
    _, mj = jl.cam_flow_loss(jnp.asarray(Ps), jnp.asarray(dgt),
                             list(map(jnp.asarray, est_p)),
                             list(map(jnp.asarray, est_d)), jnp.asarray(intr))
    _, mt = tl.cam_flow_loss(t(Ps), t(dgt), [t(p) for p in est_p],
                             [t(d) for d in est_d], t(intr))
    for k in mj:
        close(mt[k], mj[k])


# ---- photometric

def test_ssim_and_avg_pool_match_jax_and_the_reference_module():
    import torch.nn as tnn
    rng = np.random.RandomState(0)
    x = rng.rand(2, 16, 20, 3)
    y = x + 0.1 * rng.randn(2, 16, 20, 3)
    close(tl._avg3_reflect(t(x)), jl._avg3_reflect(jnp.asarray(x)))
    close(tl.ssim_loss(t(x), t(y)), jl.ssim_loss(jnp.asarray(x),
                                                 jnp.asarray(y)))
    # the reference SSIM module (tests/test_missing_features.py:154)
    pool, pad = tnn.AvgPool2d(3, 1), tnn.ReflectionPad2d(1)
    xr, yr = (pad(t(a).permute(0, 3, 1, 2)) for a in (x, y))
    mx, my = pool(xr), pool(yr)
    sx, sy = pool(xr ** 2) - mx ** 2, pool(yr ** 2) - my ** 2
    sxy = pool(xr * yr) - mx * my
    n = (2 * mx * my + 0.01 ** 2) * (2 * sxy + 0.03 ** 2)
    d = (mx ** 2 + my ** 2 + 0.01 ** 2) * (sx + sy + 0.03 ** 2)
    ref = torch.clamp((1 - n / d) / 2, 0, 1).permute(0, 2, 3, 1)
    torch.testing.assert_close(tl.ssim_loss(t(x), t(y)), ref, rtol=0,
                               atol=1e-12)
    flat = torch.full((1, 8, 8, 3), 0.5, dtype=torch.float64)
    assert tl.ssim_loss(flat, flat).abs().max() == 0
    grads_match(lambda a, b: (tl.ssim_loss(a, b) * t(x)).sum(),
                lambda a, b: jnp.sum(jl.ssim_loss(a, b) * x), (x, y), (0, 1))


@pytest.mark.parametrize("pad_mode", ["zeros", "border"])
def test_bilinear_sample(pad_mode):
    rng = np.random.RandomState(1)
    img = rng.rand(2, 7, 9, 3)
    coords = np.stack([rng.uniform(-2, 10, (2, 7, 9)),
                       rng.uniform(-2, 8, (2, 7, 9))], -1)
    grads_match(
        lambda a, c: (tl.bilinear_sample(a, c, pad_mode) ** 2).sum(),
        lambda a, c: jnp.sum(jl.bilinear_sample(a, c, pad_mode) ** 2),
        (img, coords), (0, 1))


@pytest.mark.parametrize("n_valid", [20000, 4000], ids=["mean", "masked"])
def test_mean_on_mask_both_branches(n_valid):
    rng = np.random.RandomState(2)
    diff = rng.rand(4, 40, 64, 3)
    mask = np.zeros(4 * 40 * 64)
    mask[rng.permutation(mask.size)[:n_valid // 3]] = 1.0
    mask = mask.reshape(4, 40, 64, 1)
    vt = tl.mean_on_mask(t(diff), t(mask))
    close(vt, jl.mean_on_mask(jnp.asarray(diff), jnp.asarray(mask)))
    assert (float(vt) > 0) == (n_valid > 10000)


def flows(seed, h, w, n=2, scale=1.5):
    rng = np.random.RandomState(seed)
    return [scale * rng.randn(1, len(II), h, w, 2) for _ in range(n)]


@pytest.mark.parametrize("aff", [False, True], ids=["plain", "aff"])
@pytest.mark.parametrize("use_ssim", [False, True], ids=["l1", "ssim"])
def test_photo_loss_full_and_gradients(aff, use_ssim):
    """At full resolution (downsample=False: 6 edges of 40x64 pixels, the
    masked mean's branch) with GT validity."""
    imgs = images(3)
    vals = (np.random.RandomState(4).rand(1, F, H, W) > 0.2).astype(float)
    fl = flows(5, H, W)
    affs = [0.5 + 0.5 * np.random.RandomState(s).rand(1, len(II), 2)
            for s in (6, 7)]

    def jfn(f0, f1, a0, a1):
        return jl.photo_loss_full(
            jnp.asarray(imgs), [f0, f1], jnp.asarray(vals), II, JJ,
            use_ssim=use_ssim, aff_params=[a0, a1] if aff else None,
            downsample=False)[0]

    def tfn(f0, f1, a0, a1):
        return tl.photo_loss_full(
            t(imgs), [f0, f1], t(vals), II, JJ, use_ssim=use_ssim,
            aff_params=[a0, a1] if aff else None, downsample=False)[0]

    grads_match(tfn, jfn, fl + affs, (0, 1, 2, 3) if aff else (0, 1))
    assert float(tfn(*map(t, fl + affs))) > 0


def test_photo_loss_full_downsampled_is_masked_out():
    """The training call (downsample=True, no vals): at 40x64 the 1/8
    frames hold 6x5x8x3 = 720 entries, below min_count: 0, as in JAX."""
    imgs = images(8)
    fl = flows(9, H // 8, W // 8)
    vt, mt = tl.photo_loss_full(t(imgs), [t(f) for f in fl], None, II, JJ)
    vj, mj = jl.photo_loss_full(jnp.asarray(imgs),
                                list(map(jnp.asarray, fl)), None, II, JJ)
    close(vt, vj)
    assert float(vt) == 0.0 and float(mt["ph_error"]) == 0.0


def test_photo_loss_cam_and_gradients():
    imgs = images(10)
    intr = intrinsics(H, W)
    masks = (np.random.RandomState(11).rand(1, F, H, W) > 0.1).astype(float)
    est_p = [poses(s, scale=0.02) for s in (12, 13)]
    est_d = disps(14)

    def jfn(p0, p1, d0, d1):
        return jl.photo_loss_cam(jnp.asarray(imgs), [p0, p1], [d0, d1],
                                 jnp.asarray(intr), jnp.asarray(masks))[0]

    def tfn(p0, p1, d0, d1):
        return tl.photo_loss_cam(t(imgs), [p0, p1], [d0, d1], t(intr),
                                 t(masks))[0]

    grads_match(tfn, jfn, est_p + est_d, (0, 1, 2, 3))
    assert float(tfn(*map(t, est_p + est_d))) > 0


def test_unsup_occlusion_and_dynamic_vals():
    h, w = 16, 24
    intr = intrinsics(h, w)
    est_p = [poses(s, scale=0.02) for s in (15, 16)]
    est_d = disps(17, h, w)
    rii, rjj = tl.ring_graph(F)
    occ_t = tl.unsup_occ_vals([t(p) for p in est_p], [t(d) for d in est_d],
                              t(intr), rii, rjj)
    occ_j = jl.unsup_occ_vals(list(map(jnp.asarray, est_p)),
                              list(map(jnp.asarray, est_d)),
                              jnp.asarray(intr), rii, rjj)
    close(occ_t, occ_j)
    assert 0 < float(occ_t.mean()) < 1
    rng = np.random.RandomState(18)
    dy = (rng.rand(1, F, 8 * h, 8 * w) > 0.5).astype(float)
    close(tl.unsup_dy_vals(occ_t, t(dy), rii),
          jl.unsup_dy_vals(occ_j, jnp.asarray(dy), rii))
    dyl = [(rng.rand(1, len(rii), h, w) > 0.5).astype(float)
           for _ in range(2)]
    out_t = tl.unsup_dy_vals([occ_t, occ_t], [t(d) for d in dyl], rii)
    out_j = jl.unsup_dy_vals([occ_j, occ_j], list(map(jnp.asarray, dyl)),
                             rii)
    for a, b in zip(out_t, out_j):
        close(a, b)


@pytest.mark.parametrize("occ", [False, True], ids=["all", "occ"])
def test_photo_loss(occ):
    rng = np.random.RandomState(19)
    src, dst = rng.rand(1, 6, 40, 64, 3), rng.rand(1, 6, 40, 64, 3)
    fl = [rng.randn(1, 6, 40, 64, 2) for _ in range(2)]
    om = (rng.rand(1, 6, 40, 64) > 0.3).astype(float) if occ else None
    vt, _ = tl.photo_loss((t(src), t(dst)), [t(f) for f in fl],
                          occ_masks=None if om is None else t(om))
    vj, _ = jl.photo_loss((jnp.asarray(src), jnp.asarray(dst)),
                          list(map(jnp.asarray, fl)),
                          occ_masks=None if om is None else jnp.asarray(om))
    close(vt, vj)
    assert float(vt) > 0


# ---- dynamic-mask labels

def mask_probs(seed, n=2, N=len(II), h=H, w=W):
    rng = np.random.RandomState(seed)
    return [rng.rand(1, N, h, w, 2) for _ in range(n)]


def test_gt_label_loss_and_gradients():
    rng = np.random.RandomState(20)
    gm = (rng.rand(1, F, H, W) > 0.4).astype(float)
    gv = (rng.rand(1, F, H, W) > 0.1).astype(float)
    m = mask_probs(21)
    grads_match(
        lambda a, b: tl.gt_label_loss(t(gm), t(gv), [a, b], II)[0],
        lambda a, b: jl.gt_label_loss(jnp.asarray(gm), jnp.asarray(gv),
                                      [a, b], II)[0], m, (0, 1))


def test_label_regularizers_and_self_labels():
    rng = np.random.RandomState(22)
    m = mask_probs(23)
    ff, cf = rng.randn(1, 6, 5, 8, 2), rng.randn(1, 6, 5, 8, 2)
    art_t = tl.self_label_masks(t(ff), t(cf))
    art_j = jl.self_label_masks(jnp.asarray(ff), jnp.asarray(cf))
    close(art_t, art_j)
    assert 0 < float(art_t.mean()) < 1
    m8 = mask_probs(24, h=5, w=8)
    pairs = [
        (tl.art_label_loss(art_t, [t(x) for x in m8]),
         jl.art_label_loss(art_j, list(map(jnp.asarray, m8)))),
        (tl.ce_reg_loss([t(x) for x in m]),
         jl.ce_reg_loss(list(map(jnp.asarray, m)))),
        (tl.consistency_loss([t(x) for x in m]),
         jl.consistency_loss(list(map(jnp.asarray, m))))]
    for (vt, mt), (vj, mj) in pairs:
        close(vt, vj)
        assert mt.keys() == mj.keys()
