"""The port's ``PanopticPredictor`` (dense path on the device, host stitch,
fusion state per video) against :class:`pvo_tpu.vps.panoptic_fpn.
PanopticPredictor` on the same tamed weights and numpy inputs from seeds,
on the CPU: 64x96, the 1-block backbone, 20 detections.

The weights are random, tamed by ``benchmark_vps.tame_weights`` (frozen-BN
scales cut, class logits standardized on a calibration image, mask logits
biased away from the 0.5 threshold) so that detections clear the stitch's
0.5 score and masks are pasted; the JAX side gets the same tamed values.
Three frames of one video: plain; fusion with flow and depth (rounded
through f16 as both packages ship them); fusion with ``depth_proj`` and
``bitcompat_flow``. Each frame: ``sem`` equal on >= 99.9% of pixels, the
same valid detections (classes equal, boxes within 1e-3 px, scores within
1e-5), ``pan`` equal on >= 99.5% of pixels. Then the port against itself:
bf16 against f32 (tests/test_vps_model.py's gate), device-style tensors
against host arrays, pipelined against sequential, padding and crop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vps import panoptic_fpn as jpfpn
from pvo_tpu_torch.scripts.benchmark_vps import tame_weights
from pvo_tpu_torch.utils import convert_vps
from pvo_tpu_torch.vps import panoptic_fpn as pfpn

H, W = 64, 96
BLOCKS = (1, 1, 1, 1)
MAX_DETS = 20
INTR = (40.0, 40.0, W / 2, H / 2)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the tests run in six processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def hwio(w):
    return np.transpose(w.numpy(), (2, 3, 1, 0))


def write_back_tamed(params, model):
    """The leaves ``tame_weights`` changes, copied from the port's model
    into the JAX tree."""
    sd = model.state_dict()
    p = params["params"]
    bb, bu = p["backbone"], "backbone.bottom_up"
    bb["stem_conv1_norm"]["weight"] = sd[f"{bu}.stem.conv1.norm.weight"] \
        .numpy()
    for key, blk in bb.items():
        if key.startswith("res"):
            s, b = key[3], key.split("_")[1]
            for cv in ("conv3", "shortcut"):
                if cv in blk:
                    blk[f"{cv}_norm"]["weight"] = \
                        sd[f"{bu}.res{s}.{b}.{cv}.norm.weight"].numpy()
    bh = p["roi_heads"]["box_head"]
    for name in ("cls_score", "bbox_pred"):
        w = f"roi_heads.box_predictor.{name}"
        bh[name] = {"kernel": sd[f"{w}.weight"].numpy().T.copy(),
                    "bias": sd[f"{w}.bias"].numpy()}
    mp = p["roi_heads"]["mask_head"]["predictor"]["Conv_0"]
    mp["kernel"] = hwio(sd["roi_heads.mask_head.predictor.weight"])
    mp["bias"] = sd["roi_heads.mask_head.predictor.bias"].numpy()
    p["rpn_head"]["anchor_deltas"]["Conv_0"]["kernel"] = hwio(
        sd["proposal_generator.rpn_head.anchor_deltas.weight"])
    p["fusion_conv1"]["Conv_0"]["kernel"] = hwio(sd["fusion_conv1.weight"])
    sp = p["sem_seg_head"]["predictor"]["Conv_0"]
    sp["kernel"] = hwio(sd["sem_seg_head.predictor.weight"])
    sp["bias"] = sd["sem_seg_head.predictor.bias"].numpy()
    return params


@pytest.fixture(scope="module", autouse=True)
def f32_jax():
    """The JAX predictor as it runs outside the tests: 64-bit types off
    (tests/conftest.py turns them on; under them its dense path runs some
    20x slower on the CPU)."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def weights():
    """(tamed JAX variables, the port's model on the same values)."""
    jm = jpfpn.PanopticFPN(backbone_blocks=BLOCKS)
    params = jax.tree.map(np.array, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3), jnp.float32)))
    model = tame_weights(convert_vps.panoptic_fpn_from_jax(params).eval(),
                         calib_hw=(H, W))
    params = write_back_tamed(params, model)
    back = convert_vps.panoptic_fpn_from_jax(params).state_dict()
    assert all(torch.equal(v, back[k]) for k, v in model.state_dict().items())
    return params, model


def frames(seed=0, n=3):
    """Images, a smooth flow (+-10 px), a depth map and w2c poses."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (H + 8, W + 8, 3)).astype(np.uint8)
    imgs = [base[t:t + H, 2 * t:2 * t + W].copy() for t in range(n)]
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    flow = np.stack([-2 + 6 * np.sin(xx / 17.0) + 3 * np.cos(yy / 11.0),
                     -1 + 3 * np.sin(yy / 13.0)], -1).astype(np.float32)
    depth = (4 + 2 * np.sin(xx / 9.0) + yy / 16.0 +
             0.3 * rng.rand(H, W)).astype(np.float32)
    poses = []
    for t in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.05 * t, 0.0, 0.2 * t]
        poses.append(T)
    return imgs, flow, depth, poses


def run_sequence(pred, data):
    """plain; fusion + depth; fusion + depth_proj + bitcompat_flow."""
    imgs, flow, depth, poses = data
    pred._video_id = None
    pred.bitcompat_flow = pred.depth_proj = False
    outs = [pred(imgs[0], video_id="v", pose_w2c=poses[0])]
    outs.append(pred(imgs[1], video_id="v", flow=flow, depth=depth,
                     pose_w2c=poses[1]))
    pred.bitcompat_flow = pred.depth_proj = True
    pred.intrinsics = INTR
    outs.append(pred(imgs[2], video_id="v", flow=np.abs(flow), depth=depth,
                     pose_w2c=poses[2]))
    return outs


@pytest.fixture(scope="module")
def sequences(weights):
    params, model = weights
    data = frames()
    jpred = jpfpn.PanopticPredictor(
        params=jax.tree.map(jnp.asarray, params), image_hw=(H, W),
        max_dets=MAX_DETS, model_kwargs={"backbone_blocks": BLOCKS})
    ours = pfpn.PanopticPredictor(model, max_dets=MAX_DETS,
                                  device="cpu")
    return run_sequence(ours, data), run_sequence(jpred, data)


def assert_same_frame(ours, theirs, tol_box=1e-3, tol_score=1e-5,
                      sem_equal=0.999, pan_equal=0.995):
    pan, segs, sem, dets = ours
    jpan, jsegs, jsem, jdets = theirs
    assert sem.dtype == jsem.dtype == np.uint8 and sem.shape == jsem.shape
    assert (sem == jsem).mean() >= sem_equal
    valid = np.asarray(jdets["valid"])
    np.testing.assert_array_equal(dets["valid"], valid)
    np.testing.assert_array_equal(dets["classes"][valid],
                                  np.asarray(jdets["classes"])[valid])
    np.testing.assert_allclose(dets["boxes"][valid],
                               np.asarray(jdets["boxes"])[valid],
                               rtol=0, atol=tol_box)
    np.testing.assert_allclose(dets["scores"][valid],
                               np.asarray(jdets["scores"])[valid],
                               rtol=0, atol=tol_score)
    assert pan.shape == jpan.shape and (pan == jpan).mean() >= pan_equal


@pytest.mark.parametrize("frame", [0, 1, 2],
                         ids=["plain", "fusion_depth", "depth_proj_bitcompat"])
def test_predictor_matches_jax(sequences, frame):
    ours, theirs = sequences
    assert_same_frame(ours[frame], theirs[frame])
    dets = ours[frame][3]
    assert dets["valid"].sum() > 0
    # the tamed weights exercise the stitch's thing path
    assert (dets["scores"][dets["valid"]] > 0.5).any()
    assert any(s["isthing"] for s in ours[frame][1])


def test_fusion_changes_the_frame(sequences, weights):
    """Frame 1 runs through the fusion conv: its detections are not those
    of the plain path on the same image, and its semantic map has more
    than one class."""
    ours, _ = sequences
    imgs = frames()[0]
    plain = pfpn.PanopticPredictor(weights[1], max_dets=MAX_DETS,
                                   device="cpu")(imgs[1])
    assert not np.array_equal(plain[3]["boxes"], ours[1][3]["boxes"])
    assert len(np.unique(ours[1][2])) > 1


@pytest.fixture(scope="module")
def plain_model(weights):
    return weights[1]


def test_bf16_matches_f32(plain_model):
    """bf16 (weights and image) against f32 on the port, plain and fusion:
    the semantic map agrees on >= 90% of pixels; f32's top detection has a
    bf16 twin (same class, box within 2 px, score within 0.1: the tamed
    scores of neighbouring boxes lie closer than bf16's rounding, so the
    order among them may change); sem stays uint8, detections f32."""
    imgs, flow, _, _ = frames(1, 2)
    kw = dict(max_dets=10, device="cpu")
    p32 = pfpn.PanopticPredictor(plain_model, **kw)
    p16 = pfpn.PanopticPredictor(plain_model, bf16=True, **kw)
    assert next(p16.model.parameters()).dtype == torch.bfloat16
    assert next(plain_model.parameters()).dtype == torch.float32
    # frame 0 plain, frame 1 fused with frame 0
    runs = [[p(imgs[0], video_id="v"), p(imgs[1], video_id="v", flow=flow)]
            for p in (p32, p16)]
    for fusion in (False, True):
        (_, _, sem32, d32), (_, _, sem16, d16) = (r[fusion] for r in runs)
        assert sem16.dtype == np.uint8
        assert d16["boxes"].dtype == d16["scores"].dtype == np.float32
        assert (sem32 == sem16).mean() >= 0.9, fusion
        assert d32["valid"][0]
        twin = (d16["valid"] & (d16["classes"] == d32["classes"][0]) &
                (np.abs(d16["boxes"] - d32["boxes"][0]).max(1) <= 2.0) &
                (np.abs(d16["scores"] - d32["scores"][0]) < 0.1))
        assert twin.any(), fusion


def test_device_tensors_equal_host_arrays(plain_model):
    """The loop mode hands flow and depth over as tensors: the flow is
    rounded through f16 as a host array is, the depth taken in f32 (as the
    JAX package takes a device array)."""
    imgs, flow, depth, _ = frames(2, 2)
    depth16 = depth.astype(np.float16).astype(np.float32)
    outs = []
    for fl, d in ((flow, depth), (torch.from_numpy(flow),
                                  torch.from_numpy(depth16))):
        p = pfpn.PanopticPredictor(plain_model, max_dets=10, device="cpu")
        p(imgs[0], video_id="v")
        outs.append(p(imgs[1], video_id="v", flow=fl, depth=d))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    for k in outs[0][3]:
        np.testing.assert_array_equal(outs[0][3][k], outs[1][3][k])


def test_new_video_and_pipelining(plain_model):
    """A frame of another video takes the plain path; submitting frame t+1
    before resolving frame t gives the sequential results."""
    imgs, flow, _, _ = frames(3, 3)
    kw = dict(max_dets=10, device="cpu")
    seq = pfpn.PanopticPredictor(plain_model, **kw)
    want = [seq(imgs[0], video_id="a"), seq(imgs[1], video_id="a", flow=flow),
            seq(imgs[2], video_id="b", flow=flow)]
    fresh = pfpn.PanopticPredictor(plain_model, **kw)(imgs[2])
    np.testing.assert_array_equal(want[2][0], fresh[0])
    pipe = pfpn.PanopticPredictor(plain_model, **kw)
    pend = [pipe.submit(imgs[0], video_id="a")]
    pend.append(pipe.submit(imgs[1], video_id="a", flow=flow))
    got = [pipe.result(pend[0])]
    pend.append(pipe.submit(imgs[2], video_id="b", flow=flow))
    got += [pipe.result(pend[1]), pipe.result(pend[2])]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[2], w[2])


def test_padding_and_crop(plain_model):
    """A 60x90 image is zero-padded to 64x96: pan and sem come back at
    60x90, boxes are clipped to the padded size."""
    img = np.random.RandomState(4).randint(0, 255, (60, 90, 3)) \
        .astype(np.uint8)
    pan, _, sem, dets = pfpn.PanopticPredictor(
        plain_model, max_dets=10, device="cpu")(img)
    assert pan.shape == sem.shape == (60, 90) and pan.dtype == np.int32
    b = dets["boxes"][dets["valid"]]
    assert b.size and (b >= 0).all() and (b[:, 2] <= 96).all() \
        and (b[:, 3] <= 64).all()


def test_predictor_never_picks_the_cpu_by_itself(plain_model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfpn.PanopticPredictor(plain_model)
