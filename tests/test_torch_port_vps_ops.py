"""The port's detection ops (``pvo_tpu_torch.vps.ops``, the anchors and
proposals of ``vps.rpn``, the level assignment and pooling of
``vps.roi_heads``) against :mod:`pvo_tpu.vps` on the same numpy inputs
from seeds, on the CPU.

Box transforms, IoU and ROIAlign within 1e-6 (the port forms each bin as
one weighted bag of rows, the JAX package as a blend of four gathers then
a mean: another f32 summation order). NMS and the proposals' keep lists
exactly, ties included (both sort stably). The cases of
tests/test_vps_ops.py and tests/test_roi_align_sampling.py, mirrored.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vps import ops as jops
from pvo_tpu.vps import roi_heads as jrh
from pvo_tpu.vps import rpn as jrpn
from pvo_tpu_torch.vps import ops, roi_heads, rpn

from test_roi_align_sampling import _boxes, roi_align_adaptive_np

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the tests run in six processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def random_boxes(rng, n, img_h, img_w, lo=4, hi=120):
    sides = rng.uniform(lo, hi, (n, 2))
    cx = rng.uniform(0, img_w, n)
    cy = rng.uniform(0, img_h, n)
    return np.stack([cx - sides[:, 0] / 2, cy - sides[:, 1] / 2,
                     cx + sides[:, 0] / 2, cy + sides[:, 1] / 2],
                    1).astype(np.float32)


# ------------------------------------------------------------ boxes

def test_encode_decode_match_jax_and_roundtrip():
    rng = np.random.RandomState(0)
    src = np.abs(rng.rand(10, 4)).astype(np.float32) * 50
    src[:, 2:] = src[:, :2] + 10 + 20 * rng.rand(10, 2)
    tgt = (src + rng.randn(10, 4) * 3).astype(np.float32)
    tgt[:, 2:] = np.maximum(tgt[:, 2:], tgt[:, :2] + 1)
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        d = ops.encode_boxes(t(src), t(tgt), w)
        np.testing.assert_allclose(
            d.numpy(), np.asarray(jops.encode_boxes(
                jnp.asarray(src), jnp.asarray(tgt), w)), **TOL)
        back = ops.decode_boxes(d, t(src), w)
        np.testing.assert_allclose(back.numpy(), tgt, atol=1e-4)
    # large deltas: dw/dh clamped at log(1000/16)
    deltas = (rng.randn(20, 4) * 6).astype(np.float32)
    np.testing.assert_allclose(
        ops.decode_boxes(t(deltas), t(src[:1].repeat(20, 0))).numpy(),
        np.asarray(jops.decode_boxes(jnp.asarray(deltas),
                                     jnp.asarray(src[:1].repeat(20, 0)))),
        rtol=1e-6, atol=1e-4)


def test_clip_area_iou_match_jax():
    rng = np.random.RandomState(1)
    a = random_boxes(rng, 30, 64, 96)
    b = random_boxes(rng, 20, 64, 96)
    np.testing.assert_array_equal(
        ops.clip_boxes(t(a), 64, 96).numpy(),
        np.asarray(jops.clip_boxes(jnp.asarray(a), 64, 96)))
    np.testing.assert_allclose(ops.box_iou(t(a), t(b)).numpy(),
                               np.asarray(jops.box_iou(jnp.asarray(a),
                                                       jnp.asarray(b))),
                               **TOL)
    iou = ops.box_iou(t([[0., 0., 10., 10.], [5., 5., 15., 15.]]),
                      t([[0., 0., 10., 10.], [5., 5., 15., 15.]]))
    np.testing.assert_allclose(np.diag(iou.numpy()), 1.0)
    assert 0.1 < float(iou[0, 1]) < 0.2  # 25/175


# -------------------------------------------------------------- NMS

def jax_nms(boxes, scores, thr, max_out):
    keep, valid = jax.jit(jops.nms, static_argnums=(2, 3))(
        jnp.asarray(boxes), jnp.asarray(scores), thr, max_out)
    return np.asarray(keep), np.asarray(valid)


def test_nms_suppresses_overlaps():
    boxes = np.array([[0., 0., 10., 10.], [1., 1., 11., 11.],
                      [50., 50., 60., 60.]], np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    keep, valid = ops.nms(t(boxes), t(scores), 0.5, 3)
    assert set(keep.numpy()[valid.numpy()].tolist()) == {0, 2}
    jk, jv = jax_nms(boxes, scores, 0.5, 3)
    np.testing.assert_array_equal(keep.numpy(), jk)
    np.testing.assert_array_equal(valid.numpy(), jv)


def test_batched_nms_keeps_cross_class():
    boxes = t([[0., 0., 10., 10.], [1., 1., 11., 11.]])
    keep, valid = ops.batched_nms(boxes, t([0.9, 0.8]),
                                  t(np.array([0, 1])), 0.5, 2)
    assert int(valid.sum()) == 2


def test_nms_ignores_non_finite_scores():
    boxes = np.array([[0., 0., 10., 10.], [20., 20., 30., 30.],
                      [40., 40., 50., 50.]], np.float32)
    scores = np.array([0.9, -np.inf, np.nan], np.float32)
    keep, valid = ops.nms(t(boxes), t(scores), 0.5, 3)
    assert int(valid.sum()) == 1 and int(keep[0]) == 0
    # padded outputs carry the best box's index, as the JAX package
    assert keep.numpy().tolist() == [0, 0, 0]


@pytest.mark.parametrize("n,max_out,thr,ties", [
    (300, 100, 0.5, False), (400, 1000, 0.7, False), (300, 50, 0.5, True),
    (64, 64, 0.3, True)])
def test_nms_equals_jax(n, max_out, thr, ties):
    """Random overlapping boxes, some scores -inf; with ``ties`` the
    scores take few distinct values, so the keep list depends on the
    sort's order among equal scores (input order, both sides)."""
    rng = np.random.RandomState(n + max_out)
    boxes = random_boxes(rng, n, 64, 96)
    scores = (rng.randint(0, 5, n) / 5.0 if ties
              else rng.rand(n)).astype(np.float32)
    scores[rng.rand(n) < 0.1] = -np.inf
    keep, valid = ops.nms(t(boxes), t(scores), thr, max_out)
    jk, jv = jax_nms(boxes, scores, thr, max_out)
    np.testing.assert_array_equal(valid.numpy(), jv)
    np.testing.assert_array_equal(keep.numpy(), jk)


def test_batched_nms_equals_jax():
    rng = np.random.RandomState(7)
    boxes = random_boxes(rng, 600, 64, 96)
    scores = rng.rand(600).astype(np.float32)
    scores[scores < 0.3] = -np.inf
    cls = rng.randint(0, 3, 600).astype(np.int32)
    keep, valid = ops.batched_nms(t(boxes), t(scores), t(cls), 0.5, 100)
    jk, jv = jax.jit(jops.batched_nms, static_argnums=(3, 4))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls), 0.5, 100)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))


def test_packed_sweep_equals_a_plain_greedy_loop():
    """The host sweep over packed bits against the loop it replaces."""
    rng = np.random.RandomState(3)
    m = 77
    sup = np.triu(rng.rand(m, m) < 0.05, 1)
    alive = rng.rand(m) > 0.1
    rows = ops._pack_rows(torch.from_numpy(sup)).numpy()
    assert rows.shape == (m, 10)
    np.testing.assert_array_equal(
        np.unpackbits(rows, axis=1, bitorder="little")[:, :m], sup)
    for max_out in (5, 100):
        keep, dead = [], ~alive
        for i in range(m):
            if dead[i]:
                continue
            keep.append(i)
            if len(keep) == max_out:
                break
            dead = dead | sup[i]
        assert ops.greedy_sweep(rows, alive, max_out) == keep


# --------------------------------------------------------- ROIAlign

def test_roi_align_constant_map():
    feat = torch.full((3, 16, 16), 5.0)
    out = ops.roi_align(feat, t([[2., 2., 10., 10.]]), out_size=4)
    assert out.shape == (1, 3, 4, 4)
    np.testing.assert_allclose(out.numpy(), 5.0, atol=1e-5)


def test_roi_align_gradient_map():
    """A linear ramp in x pools to its bin-centre averages."""
    W = 32
    feat = torch.arange(W, dtype=torch.float32)[None, None, :].expand(
        1, W, W).contiguous()
    out = ops.roi_align(feat, t([[4., 4., 28., 28.]]), out_size=6)[0, 0]
    expected = 4.0 + 4.0 * (np.arange(6) + 0.5) - 0.5
    np.testing.assert_allclose(out.numpy().mean(axis=0), expected,
                               atol=0.1)


@pytest.mark.parametrize("out_size,samples,scale", [
    (7, 4, 1 / 8), (14, 2, 1 / 4), (7, 2, 1.0)])
def test_roi_align_equals_jax(out_size, samples, scale):
    """Boxes inside, straddling and outside the map."""
    rng = np.random.RandomState(out_size + samples)
    feat = rng.randn(20, 28, 8).astype(np.float32)
    boxes = random_boxes(rng, 24, 20 / scale + 40, 28 / scale + 40,
                         lo=2, hi=30 / scale) - 20
    got = ops.roi_align(t(np.transpose(feat, (2, 0, 1))), t(boxes),
                        out_size=out_size, spatial_scale=scale,
                        samples=samples)
    # eager, as tests/test_vps_ops.py runs it (jit fuses the blend into
    # another rounding, 3e-6 apart)
    ref = jops.roi_align(jnp.asarray(feat), jnp.asarray(boxes),
                         out_size=out_size, spatial_scale=scale,
                         samples=samples)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_top_of_range_bins_match_adaptive_exactly():
    """As tests/test_roi_align_sampling.py: bins in (3, 4] with 4x4
    samples and in (1, 2] with 2x2 equal sampling_ratio=0's grid."""
    rng = np.random.RandomState(0)
    feat = rng.randn(40, 56, 8).astype(np.float32)
    stride = 8
    img_h, img_w = 40 * stride, 56 * stride
    for out, samples, lo, hi in ((7, 4, 3.2, 4.0), (14, 2, 1.2, 2.0)):
        boxes = _boxes(rng, 6, lo * out * stride, hi * out * stride,
                       img_h, img_w)
        ref = roi_align_adaptive_np(feat, boxes, out, 1.0 / stride)
        got = ops.roi_align(t(np.transpose(feat, (2, 0, 1))), t(boxes),
                            out_size=out, spatial_scale=1.0 / stride,
                            samples=samples)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=3e-5, atol=3e-5)


def test_lower_range_bins_bounded_on_smooth_features():
    rng = np.random.RandomState(1)
    yy, xx = np.meshgrid(np.arange(40), np.arange(56), indexing="ij")
    feat = np.stack([np.sin(xx / 3.0 + p) * np.cos(yy / 4.0 - p)
                     for p in np.linspace(0, 2, 8)], -1).astype(np.float32)
    boxes = _boxes(rng, 8, 2.05 * 7 * 8, 2.9 * 7 * 8, 320, 448)
    ref = roi_align_adaptive_np(feat, boxes, 7, 1.0 / 8)
    got = ops.roi_align(t(np.transpose(feat, (2, 0, 1))), t(boxes),
                        out_size=7, spatial_scale=1.0 / 8,
                        samples=4).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).mean() < 0.05


def level_feats(rng, H0=64, W0=96, C=8):
    return {lvl: rng.randn(1, H0 * 4 // s, W0 * 4 // s, C).astype(np.float32)
            for lvl, s in zip(jrh.BOX_LEVELS, jrh.BOX_STRIDES)}


def spanning_boxes(rng, n=24, H0=64, W0=96):
    """Boxes whose sides (8..600 px) span all four assigned levels."""
    sides = rng.uniform(8, 600, (n, 2))
    cx = rng.uniform(0, 4 * W0, n)
    cy = rng.uniform(0, 4 * H0, n)
    return np.stack([cx - sides[:, 0] / 2, cy - sides[:, 1] / 2,
                     cx + sides[:, 0] / 2, cy + sides[:, 1] / 2],
                    1).astype(np.float32)


def test_assign_levels_equals_jax():
    rng = np.random.RandomState(5)
    boxes = spanning_boxes(rng, 200)
    got = roi_heads.assign_levels(t(boxes)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jrh.assign_levels(jnp.asarray(boxes))))
    assert set(got.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("out_size", [7, 14])
def test_multilevel_roi_align_equals_jax(out_size):
    rng = np.random.RandomState(out_size)
    feats = level_feats(rng)
    boxes = spanning_boxes(rng)
    got = roi_heads.multilevel_roi_align(
        {k: t(np.transpose(v, (0, 3, 1, 2))) for k, v in feats.items()},
        t(boxes), out_size=out_size)
    ref = jrh.multilevel_roi_align(
        {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(boxes),
        out_size=out_size)
    assert got.shape == (24, 8, out_size, out_size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_multilevel_matches_per_level_select():
    """The single-buffer pooler equals pooling every box from every level
    and selecting its own level afterwards."""
    rng = np.random.RandomState(0)
    feats = {k: t(np.transpose(v, (0, 3, 1, 2)))
             for k, v in level_feats(rng).items()}
    boxes = t(spanning_boxes(rng))
    got = roi_heads.multilevel_roi_align(feats, boxes, out_size=7)
    lvl = roi_heads.assign_levels(boxes)
    pooled = torch.stack([
        ops.roi_align(feats[k][0], boxes, out_size=7,
                      spatial_scale=1.0 / s, samples=4)
        for k, s in zip(roi_heads.BOX_LEVELS, roi_heads.BOX_STRIDES)])
    ref = pooled[lvl, torch.arange(len(boxes))]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_roi_align_bf16_levels_pool_in_f32():
    """A bf16 model's levels pool from an f32 copy: the same numbers as
    pooling the bf16 values in f32."""
    rng = np.random.RandomState(2)
    feats = {k: t(np.transpose(v, (0, 3, 1, 2))).bfloat16()
             for k, v in level_feats(rng).items()}
    boxes = t(spanning_boxes(rng))
    flat = roi_heads.flat_levels(feats, torch.float32)
    assert flat[0].dtype == torch.float32
    got = roi_heads.multilevel_roi_align(feats, boxes, flat=flat)
    ref = roi_heads.multilevel_roi_align(
        {k: v.float() for k, v in feats.items()}, boxes)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


# -------------------------------------------------- anchors, proposals

@pytest.mark.parametrize("level", jrpn.LEVELS)
def test_anchors_equal_jax(level):
    got = rpn.generate_anchors(level, (5, 7)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jrpn.generate_anchors(level, (5, 7))))


@pytest.mark.parametrize("ties", [False, True])
def test_generate_proposals_equals_jax(ties):
    """Per-level top-k, decode, clip and the joint NMS from random RPN
    outputs at 64x96 (levels 16x24 .. 1x2). With ``ties`` the logits take
    few values: ``jax.lax.top_k`` keeps the lower index first, and so does
    the port's stable sort."""
    rng = np.random.RandomState(11 + ties)
    H, W = 64, 96
    logits, regs = {}, {}
    for lvl in jrpn.LEVELS:
        s = jrpn.STRIDES[lvl]
        h, w = -(-H // s), -(-W // s)
        lg = rng.randn(h, w, 3).astype(np.float32)
        if ties:
            lg = np.round(lg * 2) / 2
        logits[lvl] = lg
        regs[lvl] = (0.3 * rng.randn(h, w, 12)).astype(np.float32)
    boxes, scores, valid = rpn.generate_proposals(
        {k: t(np.transpose(v, (2, 0, 1))) for k, v in logits.items()},
        {k: t(np.transpose(v, (2, 0, 1))) for k, v in regs.items()},
        (H, W), pre_nms_topk=300, post_nms_topk=200)
    jb, js, jv = jax.jit(functools.partial(
        jrpn.generate_proposals, image_hw=(H, W), pre_nms_topk=300,
        post_nms_topk=200))(
        {k: jnp.asarray(v) for k, v in logits.items()},
        {k: jnp.asarray(v) for k, v in regs.items()})
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(js))
