"""The port's VPS training losses (``pvo_tpu_torch.vps.losses``) against
:mod:`pvo_tpu.vps.losses` on numpy inputs from seeds, on the CPU.

Each loss within 1e-5 of the JAX function (relative to the larger of 1
and its value) and its gradient within 1e-5 of ``jax.grad``'s (relative
to the gradient's largest entry). ``subsample_labels`` takes the very
priorities that ``jax.random.uniform`` draws and selects the same
anchors; its semantics as
``tests/test_vps_train.py::test_rpn_subsample_labels_matches_reference_semantics``
holds them, on a ``torch.Generator``. ``crop_and_resize_masks``: the
alignment case of ``tests/test_vps_train.py`` and equality with the JAX
crop on random boxes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vps import losses as jlosses
from pvo_tpu_torch.vps import losses

from torch_one_thread import one_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _no_x64():
    """f32 on both sides (tests/conftest.py turns x64 on)."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def assert_close(got, ref, tol=TOL, floor=1.0):
    """max |got - ref| <= tol * max(floor, max |ref|): ``floor`` 1 for a
    loss, 0 for a gradient (relative to its largest entry)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(floor, np.abs(ref).max())
    assert scale > 0
    err = np.abs(got - ref).max()
    assert err <= tol * scale, (err, scale)


def boxes(rng, n, H=64, W=96, min_wh=2.0):
    xy = rng.uniform(0, [W - 8, H - 8], (n, 2))
    wh = rng.uniform(min_wh, [W / 2, H / 2], (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def gt_case(rng, G=4, n_valid=2):
    gt = boxes(rng, G, min_wh=8.0)
    gt[n_valid:] = [0.0, 0.0, 1.0, 1.0]
    valid = np.arange(G) < n_valid
    classes = np.r_[rng.randint(0, 3, n_valid),
                    np.zeros(G - n_valid)].astype(np.int32)
    return gt, classes, valid


def test_smooth_l1():
    x = np.random.RandomState(0).randn(50).astype(np.float32)
    for beta in (0.0, 0.5):
        assert_close(losses.smooth_l1(t(x), beta).numpy(),
                     jlosses.smooth_l1(jnp.asarray(x), beta))


def anchors_case(seed):
    from pvo_tpu_torch.vps.rpn import LEVELS, generate_anchors
    rng = np.random.RandomState(seed)
    sizes = {"p2": (16, 24), "p3": (8, 12), "p4": (4, 6), "p5": (2, 3),
             "p6": (1, 2)}
    anchors = np.concatenate([generate_anchors(lvl, sizes[lvl]).numpy()
                              for lvl in LEVELS], 0)
    return rng, anchors


@pytest.mark.parametrize("seed", [0, 1])
def test_match_anchors(seed):
    rng, anchors = anchors_case(seed)
    gt, _, valid = gt_case(rng)
    m, lab = losses.match_anchors(t(anchors), t(gt), t(valid))
    jm, jlab = jlosses.match_anchors(jnp.asarray(anchors), jnp.asarray(gt),
                                     jnp.asarray(valid))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert (lab.numpy() == 1).any() and (lab.numpy() == 0).any()


def jax_draws(labels, seed=0):
    key = jax.random.fold_in(jax.random.PRNGKey(17), seed)
    return key, np.asarray(jax.random.uniform(key, labels.shape))


@pytest.mark.parametrize("counts", [(10, 5000, 100), (500, 5000, 0),
                                    (0, 300, 20)])
def test_subsample_labels_on_the_jax_draws(counts):
    labels = np.r_[np.ones(counts[0]), np.zeros(counts[1]),
                   -np.ones(counts[2])].astype(np.int32)
    labels = np.random.RandomState(3).permutation(labels)
    key, r = jax_draws(labels)
    sp, sn = losses.subsample_labels(t(labels), t(r))
    jsp, jsn = jlosses.subsample_labels(jnp.asarray(labels), key)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(sn.numpy(), np.asarray(jsn))


def test_subsample_labels_semantics_on_a_generator():
    """<= 128 random positives, negatives fill to 256, ignores never
    selected (the JAX test's cases)."""
    g = torch.Generator().manual_seed(0)
    labels = t(np.r_[np.ones(10), np.zeros(5000),
                     -np.ones(100)].astype(np.int32))
    sp, sn = losses.subsample_labels(labels, g)
    assert int(sp.sum()) == 10 and int(sn.sum()) == 246
    assert not bool((sp | sn)[-100:].any())

    labels2 = t(np.r_[np.ones(500), np.zeros(5000)].astype(np.int32))
    sp, sn = losses.subsample_labels(labels2, g)
    assert int(sp.sum()) == 128 and int(sn.sum()) == 128
    assert not bool((sp & sn).any())
    # another draw picks other anchors
    sp2, _ = losses.subsample_labels(labels2, g)
    assert not torch.equal(sp, sp2)

    sp, sn = losses.subsample_labels(t(-np.ones(50, np.int32)), g)
    assert int(sp.sum()) == 0 and int(sn.sum()) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_rpn_loss_and_gradient(seed):
    rng, anchors = anchors_case(seed)
    gt, _, valid = gt_case(rng)
    A = len(anchors)
    logits = (3 * rng.randn(A)).astype(np.float32)
    deltas = (0.5 * rng.randn(A, 4)).astype(np.float32)
    key, r = jax_draws(np.zeros(A), seed)

    def jloss(lg, d):
        o, l = jlosses.rpn_loss(jnp.asarray(anchors), lg, d,
                                jnp.asarray(gt), jnp.asarray(valid),
                                rng=key)
        return o + 2.0 * l, (o, l)

    (_, (jo, jl)), (jg_lg, jg_d) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(logits),
                                             jnp.asarray(deltas))
    lg, d = t(logits, True), t(deltas, True)
    o, l = losses.rpn_loss(t(anchors), lg, d, t(gt), t(valid), t(r))
    (o + 2.0 * l).backward()
    assert_close(o.item(), float(jo))
    assert_close(l.item(), float(jl))
    assert float(jl) > 0
    assert_close(lg.grad.numpy(), jg_lg, floor=0)
    assert_close(d.grad.numpy(), jg_d, floor=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_rcnn_loss_and_gradient(seed):
    rng = np.random.RandomState(seed)
    gt, classes, valid = gt_case(rng)
    K, R = 3, 40
    props = boxes(rng, R)
    props[:4] = gt + rng.uniform(-1, 1, gt.shape).astype(np.float32)
    props[-4:] = gt
    pvalid = np.r_[np.ones(R - 2, bool), valid[2:]]
    scores = rng.randn(R, K + 1).astype(np.float32)
    deltas = rng.randn(R, K * 4).astype(np.float32)

    def jloss(s, d):
        ce, loc, fg, best = jlosses.fast_rcnn_loss(
            jnp.asarray(props), jnp.asarray(pvalid), s, d, jnp.asarray(gt),
            jnp.asarray(classes), jnp.asarray(valid), K)
        return ce + 3.0 * loc, (ce, loc, fg, best)

    (_, (jce, jloc, jfg, jbest)), (jgs, jgd) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(scores),
                                             jnp.asarray(deltas))
    s, d = t(scores, True), t(deltas, True)
    ce, loc, fg, best = losses.fast_rcnn_loss(
        t(props), t(pvalid), s, d, t(gt), t(classes), t(valid), K)
    (ce + 3.0 * loc).backward()
    np.testing.assert_array_equal(fg.numpy(), np.asarray(jfg))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    assert fg.numpy().any()
    assert_close(ce.item(), float(jce))
    assert_close(loc.item(), float(jloc))
    assert_close(s.grad.numpy(), jgs, floor=0)
    assert_close(d.grad.numpy(), jgd, floor=0)


def test_crop_and_resize_masks_alignment():
    """A box covering exactly the mask extent -> near-all-ones target; a
    box over background -> zeros (tests/test_vps_train.py's case)."""
    gm = np.zeros((2, 32, 48), np.float32)
    gm[0, 8:24, 8:40] = 1.0
    bx = np.asarray([[8., 8., 40., 24.], [0., 0., 8., 8.]], np.float32)
    out = losses.crop_and_resize_masks(t(gm), t(np.asarray([0, 0])), t(bx),
                                       out_size=8).numpy()
    assert out.shape == (2, 8, 8)
    assert out[0].mean() > 0.9, out[0]
    assert out[1].sum() == 0.0, out[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_crop_and_resize_masks_match_jax(seed):
    rng = np.random.RandomState(seed)
    G, H, W, R = 3, 64, 96, 30
    gm = np.zeros((G, H, W), np.float32)
    for g, b in enumerate(boxes(rng, G, min_wh=10.0).astype(int)):
        gm[g, b[1]:b[3], b[0]:b[2]] = 1.0
    bx = boxes(rng, R)
    bx[:3] -= 10.0  # boxes across the border
    idx = rng.randint(0, G, R)
    got = losses.crop_and_resize_masks(t(gm), t(idx), t(bx))
    ref = jlosses.crop_and_resize_masks(jnp.asarray(gm), jnp.asarray(idx),
                                        jnp.asarray(bx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.numpy().mean() < 1


def test_mask_loss_and_gradient():
    rng = np.random.RandomState(0)
    R = 12
    p = (4 * rng.randn(R, 28, 28)).astype(np.float32)
    y = (rng.rand(R, 28, 28) > 0.5).astype(np.float32)
    fg = rng.rand(R) > 0.4
    jl, jg = jax.value_and_grad(jlosses.mask_loss)(
        jnp.asarray(p), jnp.asarray(fg), jnp.asarray(y))
    pt = t(p, True)
    loss = losses.mask_loss(pt, t(fg), t(y))
    loss.backward()
    assert_close(loss.item(), float(jl))
    assert_close(pt.grad.numpy(), jg, floor=0)


def test_semseg_loss_and_gradient():
    rng = np.random.RandomState(0)
    B, S, H, W = 1, 12, 16, 24
    logits = (3 * rng.randn(B, H, W, S)).astype(np.float32)
    labels = rng.randint(0, S, (B, H, W)).astype(np.int32)
    labels[:, :4] = 255
    jl, jg = jax.value_and_grad(jlosses.semseg_loss)(
        jnp.asarray(logits), jnp.asarray(labels))
    lt = t(np.transpose(logits, (0, 3, 1, 2)).copy(), True)
    loss = losses.semseg_loss(lt, t(labels))
    loss.backward()
    assert_close(loss.item(), float(jl))
    assert_close(lt.grad.numpy(), np.transpose(np.asarray(jg), (0, 3, 1, 2)),
                 floor=0)
