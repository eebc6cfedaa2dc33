"""The port's Panoptic FPN modules (``pvo_tpu_torch.vps``) against
:mod:`pvo_tpu.vps` on the same weights (``panoptic_fpn_from_jax``) and
numpy inputs from seeds, on the CPU, at 64x96 with the 1-block backbone.

Each module within 1e-4 of the largest JAX output (f32): ResNet, FPN,
semantic head, RPN head, box and mask heads, the fusion conv (the whole
dense path is held in tests/test_torch_port_vps_predictor.py). The flow
warp as tests/test_vps_model.py and tests/test_missing_features.py hold
it: identity, shift, bitcompat, the f16 staging, ``pose_transport_depth``;
against the JAX warp, splat targets equal for >= 99.9% of pixels and the
warped features bit-equal wherever the targets agree. The stitch
(``paste_masks``, ``combine_panoptic``) equal to the JAX one. The weight
loader: a detectron2-named state dict loads strictly, an unexpected key
raises. And the JAX box head's flattening fault, which the port does not
copy (ROADMAP.md Queue 3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.utils import convert_vps as jconvert
from pvo_tpu.vps import panoptic_fpn as jpfpn
from pvo_tpu.vps.fpn import FPN as JaxFPN
from pvo_tpu.vps.resnet import ResNet50 as JaxResNet50
from pvo_tpu.vps.roi_heads import BoxHead as JaxBoxHead
from pvo_tpu.vps.roi_heads import MaskHead as JaxMaskHead
from pvo_tpu.vps.rpn import RPNHead as JaxRPNHead
from pvo_tpu.vps.semseg import SemSegFPNHead as JaxSemSeg
from pvo_tpu_torch.utils import convert_vps
from pvo_tpu_torch.vps import panoptic_fpn as pfpn
from pvo_tpu_torch.vps.roi_heads import BoxHead, BoxPredictor

from test_convert_vps import synth_detectron2_sd

H, W = 64, 96
BLOCKS = (1, 1, 1, 1)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the tests run in six processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def nchw(a):
    return t(np.transpose(np.asarray(a), (0, 3, 1, 2)))


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def assert_rel(got, ref, rel=1e-4):
    """max |got - ref| <= rel * max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def models():
    """(JAX variables of a 1-block PanopticFPN, the port's model on them)."""
    jm = jpfpn.PanopticFPN(backbone_blocks=BLOCKS)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, H, W, 3), jnp.float32))
    params = jax.tree.map(np.asarray, params)
    return params, convert_vps.panoptic_fpn_from_jax(params).eval()


def apply(module, params, *args, **kw):
    return jax.jit(functools.partial(module.apply, **kw))(
        {"params": params}, *args)


# ------------------------------------------------------------ modules

def test_backbone_matches_jax(models):
    params, model = models
    x = (np.random.RandomState(0).randn(1, H, W, 3) * 50).astype(np.float32)
    ref = apply(JaxResNet50(stage_blocks=BLOCKS),
                params["params"]["backbone"], jnp.asarray(x))
    with torch.no_grad():
        got = model.backbone.bottom_up(nchw(x))
    for k, shape in (("res2", (1, H // 4, W // 4, 256)),
                     ("res5", (1, H // 32, W // 32, 2048))):
        assert nhwc(got[k]).shape == shape
    for k in ref:
        assert_rel(nhwc(got[k]), ref[k])


def test_fpn_levels_match_jax(models):
    params, model = models
    rng = np.random.RandomState(1)
    feats = {f"res{i}": rng.randn(1, H // s, W // s, c).astype(np.float32)
             for i, s, c in ((2, 4, 256), (3, 8, 512), (4, 16, 1024),
                             (5, 32, 2048))}
    ref = apply(JaxFPN(), params["params"]["fpn"],
                {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        got = model.backbone.top_down({k: nchw(v) for k, v in feats.items()})
    assert nhwc(got["p2"]).shape == (1, H // 4, W // 4, 256)
    # p6 = stride-2 subsample of p5 (torch floor((n-1)/2)+1)
    assert nhwc(got["p6"]).shape == (1, (H // 32 - 1) // 2 + 1,
                                     (W // 32 - 1) // 2 + 1, 256)
    for k in ref:
        assert_rel(nhwc(got[k]), ref[k])


def p_feats(seed, levels=("p2", "p3", "p4", "p5", "p6")):
    rng = np.random.RandomState(seed)
    strides = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
    return {k: rng.randn(1, -(-H // strides[k]), -(-W // strides[k]),
                         256).astype(np.float32) for k in levels}


def test_semseg_head_matches_jax(models):
    params, model = models
    feats = p_feats(2, ("p2", "p3", "p4", "p5"))
    ref = apply(JaxSemSeg(12), params["params"]["sem_seg_head"],
                {k: jnp.asarray(v) for k, v in feats.items()},
                out_hw=(H, W))
    with torch.no_grad():
        got = model.sem_seg_head({k: nchw(v) for k, v in feats.items()},
                                 (H, W))
    assert_rel(nhwc(got), ref)


def test_rpn_head_matches_jax(models):
    params, model = models
    feats = p_feats(3)
    rl, rd = apply(JaxRPNHead(), params["params"]["rpn_head"],
                   {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        gl, gd = model.proposal_generator.rpn_head(
            {k: nchw(v) for k, v in feats.items()})
    for k in feats:
        assert_rel(nhwc(gl[k]), rl[k])
        assert_rel(nhwc(gd[k]), rd[k])


def test_box_head_matches_jax_through_the_bridge(models):
    """The JAX BoxHead on the (R, 7, 7, C) pool, as ROIHeads feeds it,
    against the port's on the NCHW pool: the bridge permutes fc1."""
    params, model = models
    pooled = np.random.RandomState(4).randn(6, 7, 7, 256).astype(np.float32)
    rs, rd = apply(JaxBoxHead(3), params["params"]["roi_heads"]["box_head"],
                   jnp.asarray(pooled))
    rh = model.roi_heads
    with torch.no_grad():
        gs, gd = rh.box_predictor(rh.box_head(nchw(pooled)))
    assert_rel(gs.numpy(), rs)
    assert_rel(gd.numpy(), rd)


def test_mask_head_matches_jax(models):
    """The deconv: flax convolves with the flipped kernel, the bridge
    flips it back."""
    params, model = models
    x = np.random.RandomState(5).randn(3, 14, 14, 256).astype(np.float32)
    ref = apply(JaxMaskHead(3), params["params"]["roi_heads"]["mask_head"],
                jnp.asarray(x))
    with torch.no_grad():
        got = model.roi_heads.mask_head(nchw(x))
    assert nhwc(got).shape == (3, 28, 28, 3)
    assert_rel(nhwc(got), ref)


def test_fusion_conv_matches_jax(models):
    params, model = models
    cur, warp = p_feats(6), p_feats(7)
    jm = jpfpn.PanopticFPN(backbone_blocks=BLOCKS)
    ref = jax.jit(functools.partial(jm.apply, method=jm.fuse))(
        params, {k: jnp.asarray(v) for k, v in cur.items()},
        {k: jnp.asarray(v) for k, v in warp.items()})
    with torch.no_grad():
        got = model.fuse({k: nchw(v) for k, v in cur.items()},
                         {k: nchw(v) for k, v in warp.items()})
    for k in cur:
        assert_rel(nhwc(got[k]), ref[k])


def test_box_head_flattening_fault_of_the_jax_package():
    """detectron2's fc1 reads the (C, 7, 7) pool flattened NCHW. The port
    flattens so and equals a plain Linear over the checkpoint's weights;
    the JAX ROIHeads hands BoxHead the (7, 7, C) pool with the same
    converted weights (pvo_tpu/vps/roi_heads.py:81-82, :120-121) and does
    not; fed the NCHW flattening it does (tests/test_vps_parity.py), and
    on bridged weights the two packages agree
    (test_box_head_matches_jax_through_the_bridge)."""
    g = torch.Generator().manual_seed(0)
    sd = {}
    for name, shape in (("box_head.fc1", (1024, 256 * 49)),
                        ("box_head.fc2", (1024, 1024)),
                        ("box_predictor.cls_score", (4, 1024)),
                        ("box_predictor.bbox_pred", (12, 1024))):
        sd[f"roi_heads.{name}.weight"] = \
            torch.randn(shape, generator=g) * shape[1] ** -0.5
        sd[f"roi_heads.{name}.bias"] = 0.1 * torch.randn(shape[0],
                                                         generator=g)
    head, pred = BoxHead(), BoxPredictor(3)
    head.load_state_dict({k.split("box_head.")[1]: v for k, v in sd.items()
                          if "box_head" in k})
    pred.load_state_dict({k.split("box_predictor.")[1]: v
                          for k, v in sd.items() if "box_predictor" in k})
    pooled = torch.randn(5, 256, 7, 7, generator=g)

    def plain(x):  # detectron2's FastRCNNConvFCHead + outputs
        x = torch.relu(x @ sd["roi_heads.box_head.fc1.weight"].T +
                       sd["roi_heads.box_head.fc1.bias"])
        x = torch.relu(x @ sd["roi_heads.box_head.fc2.weight"].T +
                       sd["roi_heads.box_head.fc2.bias"])
        return x @ sd["roi_heads.box_predictor.cls_score.weight"].T + \
            sd["roi_heads.box_predictor.cls_score.bias"]

    with torch.no_grad():
        ref = plain(pooled.flatten(1)).numpy()
        got = pred(head(pooled))[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    conv = {"box_head": {
        "fc1": jconvert._dense({k.replace("roi_heads.", ""): v.numpy()
                                for k, v in sd.items()}, "box_head.fc1"),
        "fc2": jconvert._dense({k.replace("roi_heads.", ""): v.numpy()
                                for k, v in sd.items()}, "box_head.fc2"),
        "cls_score": jconvert._dense(
            {k.replace("roi_heads.", ""): v.numpy() for k, v in sd.items()},
            "box_predictor.cls_score"),
        "bbox_pred": jconvert._dense(
            {k.replace("roi_heads.", ""): v.numpy() for k, v in sd.items()},
            "box_predictor.bbox_pred")}}
    pooled_nhwc = np.transpose(pooled.numpy(), (0, 2, 3, 1))
    jax_roi_heads = np.asarray(JaxBoxHead(3).apply(
        {"params": conv["box_head"]}, jnp.asarray(pooled_nhwc))[0])
    assert np.abs(jax_roi_heads - ref).max() > 0.1 * np.abs(ref).max()
    jax_nchw = np.asarray(JaxBoxHead(3).apply(
        {"params": conv["box_head"]},
        jnp.asarray(pooled.numpy().reshape(5, -1)))[0])
    np.testing.assert_allclose(jax_nchw, ref, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------- flow warp

def test_flow_warp_identity():
    feats = {"p2": torch.randn(1, 4, 8, 12,
                               generator=torch.Generator().manual_seed(0))}
    out = pfpn.flow_warp_features(feats, torch.zeros(32, 48, 2))
    np.testing.assert_array_equal(out["p2"].numpy(), feats["p2"].numpy())


def test_flow_warp_shift():
    f = torch.zeros(1, 1, 8, 8)
    f[0, 0, 2, 2] = 5.0
    flow = torch.zeros(8, 8, 2)
    flow[..., 0] = 2.0  # shift +2 x
    out = pfpn.flow_warp_features({"p2": f}, flow)
    assert float(out["p2"][0, 0, 2, 4]) == 5.0


def test_bitcompat_uint16_matches_numpy_cast():
    vals = np.array([0.0, 0.4, 1.9, 7.0, -0.3, -1.7, -100.2, 300.9],
                    np.float32)
    with np.errstate(invalid="ignore"):
        expect = vals.astype(np.uint16).astype(np.float32)
    np.testing.assert_array_equal(pfpn._bitcompat_uint16(t(vals)).numpy(),
                                  expect)


def test_flow_warp_bitcompat_drops_negative_flow():
    h, w = 8, 8
    feat = t(np.random.RandomState(5).rand(1, 3, h, w).astype(np.float32))
    flow = torch.zeros(h, w, 2)
    flow[..., 0] = -2.0
    fix = pfpn.flow_warp_features({"p2": feat}, flow)["p2"]
    bc = pfpn.flow_warp_features({"p2": feat}, flow, bitcompat=True)["p2"]
    np.testing.assert_array_equal(fix[0, :, :, :w - 2].numpy(),
                                  feat[0, :, :, 2:].numpy())
    np.testing.assert_array_equal(bc.numpy(), np.zeros_like(feat))


def test_flow_warp_bitcompat_positive_flow_unscaled():
    feat = t(np.random.RandomState(6).rand(1, 2, 4, 4).astype(np.float32))
    flow = torch.zeros(8, 8, 2)
    flow[..., 1] = 1.0  # +1 full-res row, applied unscaled at half res
    out = pfpn.flow_warp_features({"p3": feat}, flow, bitcompat=True)["p3"]
    np.testing.assert_array_equal(out[0, :, 1:].numpy(),
                                  feat[0, :, :-1].numpy())
    np.testing.assert_array_equal(out[0, :, 0].numpy(), 0)


def rand_w2c(seed):
    r = np.random.RandomState(seed)
    aa = 0.1 * r.randn(3)
    th = np.linalg.norm(aa)
    k = aa / max(th, 1e-9)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    T[:3, 3] = 0.3 * r.randn(3)
    return T.astype(np.float32)


def test_pose_transport_depth_vs_numpy_oracle_and_jax():
    rng = np.random.RandomState(2)
    h, w = 5, 7
    intr = (50.0, 55.0, w / 2.0, h / 2.0)
    depth = (1.0 + rng.rand(h, w)).astype(np.float32)
    E0, E1 = rand_w2c(3), rand_w2c(4)
    got = pfpn.pose_transport_depth(t(depth), t(E0), t(E1), intr).numpy()
    v = np.repeat(np.arange(h).reshape(h, 1), w, axis=1)
    u = np.tile(np.arange(w), (h, 1))
    pts = np.array([(u - intr[2]) / intr[0] * depth,
                    (v - intr[3]) / intr[1] * depth, depth,
                    np.ones((h, w))]).reshape(4, -1)
    expect = ((E1 @ np.linalg.inv(E0)) @ pts)[2].reshape(h, w)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)
    ref = jpfpn.pose_transport_depth(jnp.asarray(depth), jnp.asarray(E0),
                                     jnp.asarray(E1), intr)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    E = np.eye(4, dtype=np.float32)
    np.testing.assert_allclose(
        pfpn.pose_transport_depth(t(depth), t(E), t(E), intr).numpy(),
        depth, rtol=1e-6)


@pytest.mark.parametrize("src,dst", [((375, 1242), (96, 312)),
                                     ((384, 1248), (12, 39)),
                                     ((64, 96), (16, 24)),
                                     ((8, 12), (16, 24)),
                                     ((47, 156), (96, 312))])
def test_resize_matches_jax_image_resize(src, dst):
    """Antialiased when it shrinks, plain bilinear when it grows: on a
    flow-like field (smooth, +-10 px, a little noise) within 3e-6 of the
    largest value (f32 sums in another order)."""
    yy, xx = np.meshgrid(np.arange(src[0]), np.arange(src[1]),
                         indexing="ij")
    x = np.stack([6 * np.sin(xx / 17.0) + 4 * np.cos(yy / 11.0),
                  3 * np.sin(yy / 13.0) + np.cos(xx / 7.0)]) + \
        0.1 * np.random.RandomState(0).randn(2, *src)
    x = x.astype(np.float32)
    got = pfpn.resize_bilinear(t(x), dst).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + dst,
                                      "bilinear"))
    assert_rel(got, ref, 3e-6)


def smooth_flow(h, w, seed=0, amp=(6.0, 3.0)):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    p = np.random.RandomState(seed).rand(4) * 6
    return np.stack([amp[0] * np.sin(xx / 17.0 + p[0]) +
                     4 * np.cos(yy / 11.0 + p[1]),
                     amp[1] * np.sin(yy / 13.0 + p[2]) +
                     np.cos(xx / 7.0 + p[3])], -1).astype(np.float32)


def jax_targets(flow, hw, bitcompat=False):
    h, w = hw
    Hf, Wf = flow.shape[:2]
    f = jax.image.resize(jnp.asarray(flow), (h, w, 2), "bilinear")
    f = (jpfpn._bitcompat_uint16(f) if bitcompat
         else f * jnp.array([w / Wf, h / Hf], f.dtype))
    f = np.asarray(f)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u1 = (gx + f[..., 0]).astype(np.int32).reshape(-1)
    v1 = (gy + f[..., 1]).astype(np.int32).reshape(-1)
    inb = (u1 >= 0) & (u1 < w) & (v1 >= 0) & (v1 < h)
    return np.where(inb, v1 * w + u1, h * w)


@pytest.mark.parametrize("depth,bitcompat", [(False, False), (True, False),
                                             (False, True)])
def test_flow_warp_matches_jax(depth, bitcompat):
    """Smooth flow up to ~12 px (and its 1/8-res-style depth): targets
    equal for >= 99.9% of pixels; the warped features bit-equal at every
    target that no disagreeing source reaches on either side."""
    rng = np.random.RandomState(9)
    feats = p_feats(10, ("p2", "p3", "p4"))
    flow = smooth_flow(H, W)
    if bitcompat:
        # positive full-res values: they stay in bounds at p2
        flow = np.abs(flow) * 0.5
    d = None
    if depth:
        yy, xx = np.meshgrid(np.arange(H // 8), np.arange(W // 8),
                             indexing="ij")
        d = (5 + 3 * np.sin(xx / 3.0) + yy / 4.0 +
             0.1 * rng.rand(H // 8, W // 8)).astype(np.float32)
    ref = jpfpn.flow_warp_features(
        {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(flow),
        None if d is None else jnp.asarray(d), bitcompat=bitcompat)
    got = pfpn.flow_warp_features(
        {k: nchw(v) for k, v in feats.items()}, t(flow),
        None if d is None else t(d), bitcompat=bitcompat)
    for k, v in feats.items():
        h, w = v.shape[1:3]
        mine = pfpn.splat_targets(t(flow).permute(2, 0, 1), (h, w),
                                  bitcompat).numpy()
        theirs = jax_targets(flow, (h, w), bitcompat)
        same = mine == theirs
        assert same.mean() >= 0.999, (k, same.mean())
        bad = np.zeros(h * w + 1, bool)
        bad[mine[~same]] = True
        bad[theirs[~same]] = True
        ok = ~bad[:h * w]
        a = nhwc(got[k]).reshape(h * w, -1)
        b = np.asarray(ref[k]).reshape(h * w, -1)
        np.testing.assert_array_equal(a[ok], b[ok])
        if k == "p2":
            assert (np.abs(a).sum(1) > 0).mean() > 0.5


@pytest.mark.parametrize("depth", [False, True])
def test_flow_warp_duplicate_targets_pick_the_jax_winner(depth):
    """Every pixel of a row lands on one of two targets: without depth the
    last in raster order wins, with depth the nearest (ties in depth keep
    raster order), as the JAX scatter."""
    h, w = 4, 6
    feat = np.random.RandomState(3).randn(1, h, w, 2).astype(np.float32)
    flow = np.zeros((h, w, 2), np.float32)
    flow[1, :, 0] = -np.arange(w) + (np.arange(w) % 2) * 3
    flow[2, :, 1] = -1.0
    d = None
    if depth:
        d = np.array([[3., 1., 4., 1., 5., 9.]] * h, np.float32)
    ref = np.asarray(jpfpn.flow_warp_features(
        {"p2": jnp.asarray(feat)}, jnp.asarray(flow),
        None if d is None else jnp.asarray(d))["p2"])
    got = pfpn.flow_warp_features({"p2": nchw(feat)}, t(flow),
                                  None if d is None else t(d))["p2"]
    np.testing.assert_array_equal(nhwc(got), ref)


def test_file_protocol_f16_staging_semantics():
    """stage_inputs rounds flow and depth through f16 (f32 for bitcompat
    or depth_proj), as submit rounds a host array: a staged flow warps
    bit-identically to the inline one; the f16 rounding keeps >= 99.9% of
    the splat targets of a smooth flow, and all of them when the values
    are f16-representable."""
    rng = np.random.RandomState(0)
    feats = {"p2": t(rng.randn(1, 8, H // 4, W // 4).astype(np.float32))}
    flow = smooth_flow(H, W)
    pred = pfpn.PanopticPredictor.__new__(pfpn.PanopticPredictor)
    pred.device = torch.device("cpu")
    pred.bitcompat_flow = False
    pred.depth_proj = False
    fl, d = pred.stage_inputs(flow, rng.rand(H // 8, W // 8))
    assert fl.dtype == d.dtype == torch.float32
    assert d.shape == (H // 8, W // 8)
    np.testing.assert_array_equal(fl.numpy(),
                                  flow.astype(np.float16).astype(np.float32))
    inline = pred._upload(flow, pred._flow_dtype())
    np.testing.assert_array_equal(
        pfpn.flow_warp_features(feats, fl)["p2"].numpy(),
        pfpn.flow_warp_features(feats, inline)["p2"].numpy())
    pred.depth_proj = True
    assert pred.stage_inputs(None, np.full((2, 2), 1 / 3))[1].numpy()[0, 0] \
        == np.float32(1 / 3)

    def targets(f):
        return pfpn.splat_targets(t(f).permute(2, 0, 1), (H // 4, W // 4))

    f16 = flow.astype(np.float16).astype(np.float32)
    assert (targets(flow) == targets(f16)).float().mean() >= 0.999
    np.testing.assert_array_equal(
        targets(f16), targets(f16.astype(np.float16).astype(np.float32)))


# ------------------------------------------------------------ stitch

def test_combine_ids():
    D = 4
    dets = {
        "boxes": np.array([[8., 8., 40., 40.]] * D, np.float32),
        "scores": np.array([0.9, 0.4, 0.0, 0.0], np.float32),
        "classes": np.array([1, 0, 0, 0]),  # contiguous -> Car=13
        "mask_logits": np.full((D, 28, 28), 8.0, np.float32),
        "valid": np.array([True, True, False, False]),
    }
    sem = np.full((64, 64), 6, np.int64)  # Road (stuff contiguous 6)
    pan, segs = pfpn.combine_panoptic(dets, sem, stuff_area_thresh=64)
    cats = {s["category_id"] for s in segs}
    assert 13 in cats and 6 in cats
    thing_ids = [s["id"] for s in segs if s["isthing"]]
    assert len(thing_ids) == 1
    assert all(i // 10000 == 13 and i % 10000 > 0 for i in thing_ids)


def test_stitch_equals_jax_on_random_detections():
    rng = np.random.RandomState(12)
    D = 20
    x0 = rng.uniform(-10, 90, D)
    y0 = rng.uniform(-10, 60, D)
    dets = {"boxes": np.stack([x0, y0, x0 + rng.uniform(2, 40, D),
                               y0 + rng.uniform(2, 30, D)],
                              1).astype(np.float32),
            "scores": rng.rand(D).astype(np.float32),
            "classes": rng.randint(0, 3, D).astype(np.int32),
            "mask_logits": rng.randn(D, 28, 28).astype(np.float32),
            "valid": rng.rand(D) > 0.2}
    sem = rng.randint(0, 12, (H, W)).astype(np.uint8)
    sem[:32] = 4
    np.testing.assert_array_equal(
        pfpn.paste_masks(dets["mask_logits"], dets["boxes"], (H, W)),
        jpfpn.paste_masks(dets["mask_logits"], dets["boxes"], (H, W)))
    pan, segs = pfpn.combine_panoptic(dets, sem, stuff_area_thresh=64)
    jpan, jsegs = jpfpn.combine_panoptic(dets, sem, stuff_area_thresh=64)
    np.testing.assert_array_equal(pan, jpan)
    assert segs == jsegs
    assert any(s["isthing"] for s in segs)


# ------------------------------------------------------------ weights

@pytest.fixture(scope="module")
def detectron2_sd():
    return {k: torch.from_numpy(v) for k, v in
            synth_detectron2_sd(np.random.RandomState(0)).items()}


def test_detectron2_checkpoint_loads_strict(detectron2_sd, tmp_path):
    """A reference-named state dict under ``model`` with DDP prefixes
    loads with every key used; the fc1 and deconv weights land as they
    are (no flip, no permutation)."""
    path = tmp_path / "panfpn.pth"
    sd = {f"module.{k}": v for k, v in detectron2_sd.items()}
    torch.save({"model": sd}, path)
    model = convert_vps.load_panoptic_fpn_torch(str(path))
    assert model.has_fusion
    assert model.backbone.bottom_up.stage_blocks == (3, 4, 6, 3)
    got = model.state_dict()
    assert set(got) == set(detectron2_sd)
    for k in ("roi_heads.box_head.fc1.weight",
              "roi_heads.mask_head.deconv.weight",
              "sem_seg_head.p5.4.norm.weight",
              "backbone.bottom_up.res4.5.conv2.norm.running_var"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      detectron2_sd[k].numpy())


def test_checkpoint_with_unknown_or_missing_keys_raises(detectron2_sd,
                                                        tmp_path):
    path = tmp_path / "bad.pth"
    torch.save(dict(detectron2_sd, **{"roi_heads.extra.weight":
                                      torch.zeros(3)}), path)
    with pytest.raises(KeyError, match="does not model"):
        convert_vps.load_panoptic_fpn_torch(str(path))
    sd = dict(detectron2_sd)
    del sd["backbone.fpn_output3.bias"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="lacks"):
        convert_vps.load_panoptic_fpn_torch(str(path))


def test_checkpoint_without_fusion_conv_runs_plain_only(detectron2_sd,
                                                        tmp_path):
    path = tmp_path / "nofusion.pth"
    torch.save({k: v for k, v in detectron2_sd.items()
                if not k.startswith("fusion_conv1")}, path)
    model = convert_vps.load_panoptic_fpn_torch(str(path))
    assert not model.has_fusion
    f = {"p2": torch.zeros(1, 256, 4, 4)}
    with pytest.raises(RuntimeError, match="fusion_conv1"):
        model.fuse(f, f)


def test_random_weights_are_seeded():
    a = pfpn.init_weights(pfpn.PanopticFPN(backbone_blocks=BLOCKS), 3)
    b = pfpn.init_weights(pfpn.PanopticFPN(backbone_blocks=BLOCKS), 3)
    c = pfpn.init_weights(pfpn.PanopticFPN(backbone_blocks=BLOCKS), 4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["fusion_conv1.weight"],
                           sc["fusion_conv1.weight"])
