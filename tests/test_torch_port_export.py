"""Slice-level tests of the port: the flow/depth export.

(a) ``DroidNet.forward`` against the JAX ``DroidNet.apply`` on the same
    weights (``droidnet_from_jax``) and numpy inputs from a seed, 48x64,
    3 iterations, ``ret_flow=True, downsample=True``: a 2-frame window
    (both poses fixed: the depth-only BA step) and a 3-frame ring (one
    free pose: the full Schur step). Every per-step output within 1e-4
    abs (measured: 4e-6). The JAX side runs ``corr_impl="xla"``; its
    Pallas route does not run on the CPU through this forward, and the
    kernels' own modules are held in tests/test_torch_port_corr.py.
(b) ``final_only=True`` gives the last step of ``final_only=False`` bit
    for bit.
(c) ``export_pair`` and the CLIs on the synthetic vkitti2 scene: file
    names, shapes and dtypes of the artifacts, the export math against
    the JAX forward, and a finite trajectory file.

On the weights: the flow and mask heads' last convs are scaled by 0.01
and the mask head's bias is lowered by 2 (``chip_smoke.tame_net``'s
``mask_bias``). With unscaled random weights the recurrence is chaotic,
and with the scaled heads alone the mask logits sit at the
static/dynamic threshold (``sigmoid(raw_mask) >= 0.5`` gates the BA
weight by +10), where a pixel's decision follows rounding.
"""

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.lie import se3 as jse3
from pvo_tpu.vo import system as jsys
from pvo_tpu.vo.net.droidnet import DroidNet as JaxDroidNet
from pvo_tpu_torch.scripts import bench_vo2_export, test_vo, test_vo2
from pvo_tpu_torch.utils.convert import droidnet_from_jax

from test_torch_port_system import tame_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64
TOL = dict(rtol=0, atol=1e-4)
KEYS = ("poses", "disps_up", "residuals", "masks_up", "flows")


@pytest.fixture(scope="module")
def weights():
    """(JAX variables of DroidNet.apply, the port's DroidNet) on the same
    tamed random weights."""
    params = tame_params(jsys.init_params(jsys.make_modules(),
                                          image_size=(H, W), seed=0))
    conv = params["update"]["params"]["delta_mask"]["conv1"]["Conv_0"]
    conv["bias"] = conv["bias"] - np.float32(2.0)
    variables = {"params": {
        k: jax.tree.map(jnp.asarray, params[k]["params"])
        for k in ("fnet", "cnet", "update", "agg")}}
    return variables, droidnet_from_jax(params).eval()


def window(F, seed):
    """A moving random texture, small random poses (frame 0 at the
    origin), unit disparities, intrinsics at 1/8 res."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (H + 16, W + 16, 3), np.uint8)
    images = np.stack([base[2 * t:2 * t + H, 3 * t:3 * t + W]
                       for t in range(F)])[None]
    tau = (0.02 * rng.randn(F, 6)).astype(np.float32)
    tau[0] = 0
    poses = np.array(jse3.exp(jnp.asarray(tau)))[None]
    disps = np.ones((1, F, H // 8, W // 8), np.float32)
    intr = np.tile(np.array([40.0, 40.0, W / 2, H / 2], np.float32) / 8,
                   (1, F, 1))
    return poses, images, disps, intr


@pytest.mark.parametrize("F, ii, jj", [
    (2, [0, 1], [1, 0]),
    (3, [0, 1, 1, 2, 2, 0], [1, 0, 2, 1, 0, 2])], ids=["pair", "ring3"])
def test_forward_matches_jax(weights, F, ii, jj):
    variables, net = weights
    args = window(F, seed=F)
    kw = dict(num_steps=3, ret_flow=True, downsample=True)
    oj = JaxDroidNet().apply(variables, *map(jnp.asarray, args),
                             np.array(ii), np.array(jj), corr_impl="xla",
                             **kw)
    targs = [torch.from_numpy(a.copy()) for a in args]
    with torch.no_grad():
        ot = net(*targs, ii, jj, **kw)
        last = net(*targs, ii, jj, final_only=True, **kw)
        full = net(*targs, ii, jj, num_steps=1, ret_flow=True)
    E, h, w = len(ii), H // 8, W // 8
    shapes = {"poses": (1, F, 7), "disps_up": (1, F, H, W),
              "residuals": (1, E, h, w, 2), "masks_up": (1, E, H, W, 2),
              "flows": (1, E, h, w, 2)}
    for k in KEYS:
        assert len(ot[k]) == len(oj[k]) == 3
        for a, b in zip(ot[k], oj[k]):
            assert tuple(a.shape) == shapes[k]
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        # (b): the last step only, bit for bit
        assert len(last[k]) == (3 if k in ("poses", "residuals") else 1)
        assert torch.equal(last[k][-1], ot[k][-1])
    assert torch.equal(last["poses"][0], ot["poses"][0])
    # the fixed poses stay; in the ring the third one moves
    moved = (ot["poses"][-1] - targs[0]).abs().amax(dim=-1)[0]
    assert not moved[:2].any() and (F == 2 or moved[2] > 0)
    # without downsample the flow comes upsampled, in full-res pixels
    assert tuple(full["flows"][0].shape) == (1, E, H, W, 2)
    np.testing.assert_allclose(full["flows"][0][0, :, 0, 0].numpy(),
                               8.0 * ot["flows"][0][0, :, 0, 0].numpy(),
                               **TOL)


def test_forward_rejects_batches_and_unknown_corr(weights):
    _, net = weights
    args = [torch.from_numpy(a.copy()) for a in window(2, seed=1)]
    with pytest.raises(ValueError, match="corr_impl"):
        net(*args, [0, 1], [1, 0], num_steps=1, corr_impl="pallas")
    args[1] = args[1].repeat(2, 1, 1, 1, 1)
    with pytest.raises(ValueError, match="per sample"):
        net(*args, [0, 1], [1, 0], num_steps=1)


def test_forward_bf16_compute_stays_finite_and_close(weights):
    """``compute_dtype=torch.bfloat16`` on a module converted to bf16:
    the encoders and the update operator run in bf16, what the BA
    consumes is f32 again. Outputs are f32 and within 5e-2 of the f32
    forward's disparities after 2 steps (bf16 has 8 bits: measured
    about 1e-2)."""
    import copy
    _, net = weights
    args = [torch.from_numpy(a.copy()) for a in window(2, seed=2)]
    kw = dict(num_steps=2, ret_flow=True, downsample=True)
    with torch.no_grad():
        ref = net(*args, [0, 1], [1, 0], **kw)
        out = copy.deepcopy(net).to(torch.bfloat16)(
            *args, [0, 1], [1, 0], compute_dtype=torch.bfloat16, **kw)
    for k in KEYS:
        assert out[k][-1].dtype == torch.float32
        assert torch.isfinite(out[k][-1]).all()
    np.testing.assert_allclose(out["disps_up"][-1].numpy(),
                               ref["disps_up"][-1].numpy(), rtol=0,
                               atol=5e-2)


# ------------------------------------------------ (c) scene and CLIs

N_FRAMES = 6


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    pytest.importorskip("cv2")
    from pvo_tpu.data.synth_scene import write_synth_scene
    root = tmp_path_factory.mktemp("vkitti")
    return write_synth_scene(str(root), views=("15-deg-left",),
                             n_frames=N_FRAMES)


def run_cli(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_export_pair_matches_jax_through_the_export_math(weights, scene):
    """The CLI's per-pair work on the scene's first pair against the JAX
    forward fed the same arrays, as scripts/test_vo2.py feeds it:
    1/8-res flow of edge 0 -> 1 and the sliced disparity within 1e-4,
    the resized full flow within 1e-3 (x8, resized to 375x1242)."""
    import cv2
    from pvo_tpu.utils.io import vkitti_poses_tq as jax_poses_tq
    variables, net = weights
    base = os.path.join(scene, "15-deg-left")
    files = sorted(glob.glob(os.path.join(
        base, "frames/rgb/Camera_0/*.jpg")))[:2]
    ext = os.path.join(base, "extrinsic.txt")
    poses = test_vo2.vkitti_poses_tq(ext)
    np.testing.assert_allclose(poses, jax_poses_tq(ext), rtol=0, atol=1e-6)
    imgs, (h0, w0) = test_vo2.read_pair(files, (H, W))
    assert imgs.shape == (2, H, W, 3) and (h0, w0) == (375, 1242)
    intr8 = test_vo2.VKITTI_INTRINSICS * np.array(
        [W / w0, H / h0, W / w0, H / h0], np.float32) / 8.0

    flow8, disp = test_vo2.export_pair(net, imgs, poses[:2], intr8, iters=2)
    assert flow8.shape == (H // 8, W // 8, 2) and flow8.dtype == np.float32
    assert disp.shape == (H // 8, W // 8) and disp.dtype == np.float32

    out = JaxDroidNet().apply(
        variables, jnp.asarray(poses[:2][None]), jnp.asarray(imgs[None]),
        jnp.ones((1, 2, H // 8, W // 8), jnp.float32),
        jnp.asarray(np.tile(intr8, (1, 2, 1))), np.array([0, 1]),
        np.array([1, 0]), num_steps=2, ret_flow=True, downsample=True,
        final_only=True, corr_impl="xla")
    jflow = np.asarray(out["flows"][-1][0, 0])
    np.testing.assert_allclose(flow8, jflow, **TOL)
    np.testing.assert_allclose(
        disp, np.asarray(out["disps_up"][-1][0, 0, 3::8, 3::8]), **TOL)

    want = cv2.resize(jflow * 8.0, (1242, 375)) * \
        np.array([1242 / W, 375 / H], np.float32)
    got = test_vo2.full_flow(flow8, (H, W), (375, 1242))
    assert got.shape == (375, 1242, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_vo2_cli_writes_the_flow_and_depth_files(scene, tmp_path):
    out = run_cli("pvo_tpu_torch.scripts.test_vo2",
                  ["--datapath", scene, "--device", "cpu", "--image_size",
                   str(H), str(W), "--iters", "2", "--shared_data",
                   str(tmp_path / "shared_data")], str(tmp_path))
    assert "Scene02 frame 0/5" in out
    names = [f"Scene02_rgb_{t:05d}.npy" for t in range(N_FRAMES - 1)]
    for kind, shape in (("full_flow", (375, 1242, 2)),
                        ("depth", (H // 8, W // 8))):
        files = sorted(glob.glob(str(tmp_path / "shared_data" / kind /
                                     "*.npy")))
        assert [os.path.basename(f) for f in files] == names
        for f in files:
            a = np.load(f)
            assert a.shape == shape and a.dtype == np.float32
            assert np.isfinite(a).all()
    d = np.load(tmp_path / "shared_data" / "depth" / names[0])
    assert d.min() >= 0 and np.ptp(d) > 0


def test_vo_cli_writes_a_finite_trajectory(weights, scene, tmp_path):
    """The tracking CLI on the scene at 64x96 with the tamed weights from
    a checkpoint file: every frame's pose in KITTI format (warmup 4: the
    initialization seeds the next disparity from the last 4 frames)."""
    _, net = weights
    ckpt = tmp_path / "droid.pth"
    torch.save({f"module.{k}": v for k, v in net.state_dict().items()},
               ckpt)
    out = run_cli("pvo_tpu_torch.scripts.test_vo",
                  ["--datapath", scene, "--device", "cpu", "--image_size",
                   "64", "96", "--weights", str(ckpt), "--warmup", "4",
                   "--filter_thresh", "0.0", "--keyframe_thresh", "0.0",
                   "--shared_data", str(tmp_path / "shared_data")],
                  str(tmp_path))
    assert "keyframes:" in out and "rmse" in out
    rows = np.loadtxt(tmp_path / "shared_data" / "traj" / "Scene02" /
                      "15-deg-left" / "pvo_traj.txt")
    assert rows.shape == (N_FRAMES, 12)
    assert np.isfinite(rows).all()


@pytest.mark.parametrize("main", [test_vo2.main, test_vo.main,
                                  bench_vo2_export.main],
                         ids=["test_vo2", "test_vo", "bench_vo2_export"])
def test_entry_points_never_pick_the_cpu_by_themselves(main, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [] if main is bench_vo2_export.main else \
        ["--datapath", str(tmp_path / "Scene02")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)


def test_bench_prints_one_json_line_and_writes_no_file(tmp_path,
                                                       monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    bench_vo2_export.main(["--device", "cpu", "--image_size", str(H),
                           str(W), "--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "vo2_export_seconds_per_pair"
    assert rec["value"] > 0 and rec["device"] == "cpu"
    assert f"@{H}x{W}, 1 iters" in rec["unit"]
    assert os.listdir(tmp_path) == []
