"""The port's training data path, checkpoints and the two training CLIs.

(a) ``data/graph_utils``: the flow distance matrix (1e-5 relative), the
    co-visibility graph, its edge list and the clip sampler equal to the
    JAX module's.
(b) ``data/augmentation`` bit-equal to the JAX module's under one rng.
(c) ``VKitti2Dataset.sample_clip`` on the port's synthetic scene (with
    GT dynamic masks from ``prepare_vkitti``) equal to the JAX class's
    clips for 5 draws from one seed: every array exact.
(d) TartanAir's pose conversion and the TartanAir / Replica indexes
    against the JAX classes.
(e) J3: the JAX class names its index cache by class, split and
    ``aug_graph`` alone, so a second dataset root reads the first root's
    index; the port's class keys the cache by the absolute root too.
(f) ``utils/checkpoint``: save / load / resume_or_load round trips, a
    reference-keyed ``.pth`` through ``load_droidnet_torch``.
(g) ``train_vo --device cpu`` and ``bench_train_vo --device cpu --steps
    3`` as subprocesses at tiny sizes: their JSON keys, a checkpoint
    file, no ``BENCH_*.json`` written.
"""

import glob
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from pvo_tpu.data import augmentation as jaug
from pvo_tpu.data import graph_utils as jgu
from pvo_tpu.data import tartan as jtartan
from pvo_tpu.data.vkitti2 import VKitti2Dataset as JaxVKitti2
from pvo_tpu_torch.data import augmentation as taug
from pvo_tpu_torch.data import graph_utils as tgu
from pvo_tpu_torch.data import tartan as ttartan
from pvo_tpu_torch.data.synth_scene import write_synth_scene
from pvo_tpu_torch.data.vkitti2 import VKitti2Dataset
from pvo_tpu_torch.scripts.prepare_vkitti import generate_dynamic_masks
from pvo_tpu_torch.utils import checkpoint
from pvo_tpu_torch.utils.convert import load_droidnet_torch
from pvo_tpu_torch.utils.io import VKITTI_INTRINSICS, vkitti_poses_tq
from pvo_tpu_torch.vo.net.droidnet import DroidNet

from torch_one_thread import one_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
N_FRAMES = 12


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 12-frame synthetic vkitti2 scene (clone view) with GT dynamic
    masks."""
    root = str(tmp_path_factory.mktemp("vkitti"))
    write_synth_scene(root, views=("clone",), n_frames=N_FRAMES, workers=4)
    assert generate_dynamic_masks(osp.join(root, "Scene02", "clone"),
                                  device="cpu") == N_FRAMES
    return root


# ---- (a) graph utilities

def scene_depths(scene):
    import cv2

    from pvo_tpu_torch.utils.io import decode_vkitti_depth
    base = osp.join(scene, "Scene02", "clone")
    files = sorted(glob.glob(osp.join(base, "frames/depth/Camera_0/*.png")))
    d = [decode_vkitti_depth(cv2.imread(f, cv2.IMREAD_ANYCOLOR |
                                        cv2.IMREAD_ANYDEPTH))[::16, ::16]
         for f in files]
    return vkitti_poses_tq(osp.join(base, "extrinsic.txt")), np.stack(d)


def test_graph_utils_match_jax(scene):
    poses, depths = scene_depths(scene)
    intr = VKITTI_INTRINSICS / 16.0
    disps = 1.0 / np.maximum(depths, 1e-3)
    dt = tgu.compute_distance_matrix_flow(poses, disps, intr)
    dj = jgu.compute_distance_matrix_flow(poses, disps, intr)
    np.testing.assert_allclose(dt, dj, rtol=1e-5)
    gt = tgu.build_frame_graph(poses, depths, intr)
    gj = jgu.build_frame_graph(poses, depths, intr)
    assert gt == gj and sum(map(len, gt.values())) > N_FRAMES
    for a, b in zip(tgu.graph_to_edge_list(gt), jgu.graph_to_edge_list(gj)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tgu.keyframe_indices(gt),
                                  jgu.keyframe_indices(gj))
    for seed in range(3):
        np.testing.assert_array_equal(
            tgu.sample_training_graph(dj, 4, rng=np.random.default_rng(seed)),
            jgu.sample_training_graph(dj, 4, rng=np.random.default_rng(seed)))


# ---- (b) augmentation

def test_augmentation_is_bit_equal():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (3, 60, 90, 3)).astype(np.float32)
    depths = (1.0 + 20 * rng.rand(3, 60, 90)).astype(np.float32)
    intr = np.array([50.0, 50.0, 45.0, 30.0], np.float32)
    segs = rng.randint(0, 9, (3, 60, 90))
    masks = (rng.rand(3, 60, 90, 2) > 0.5).astype(np.float32)
    for seed in range(4):
        a = taug.augment_clip(images, depths, intr, (40, 64),
                              np.random.default_rng(seed), segments=segs,
                              masks=masks)
        b = jaug.augment_clip(images, depths, intr, (40, 64),
                              np.random.default_rng(seed), segments=segs,
                              masks=masks)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        taug.color_jitter(images, np.random.default_rng(9)),
        jaug.color_jitter(images, np.random.default_rng(9)))


# ---- (c) the vkitti2 dataset

def test_sample_clip_matches_jax(scene, tmp_path):
    kw = dict(n_frames=4, mode="semisup", crop_size=(200, 400), seed=7)
    dt = VKitti2Dataset(scene, cache_dir=str(tmp_path / "t"), **kw)
    dj = JaxVKitti2(scene, cache_dir=str(tmp_path / "j"), **kw)
    assert dt.scene_info.keys() == dj.scene_info.keys() == {"Scene02"}
    assert dt.scene_info["Scene02"]["graph"] == \
        dj.scene_info["Scene02"]["graph"]
    for _ in range(5):
        a, b = dt.sample_clip(), dj.sample_clip()
        assert a.keys() == b.keys()
        assert {"gt_masks", "gt_vals", "poses_init"} <= set(a)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the GT dynamic masks are not all static (the scene has a moving car)
    assert 0 < a["gt_masks"].mean() < 1


def test_motion_masks_match_jax(scene, tmp_path):
    dt = VKitti2Dataset(scene, cache_dir=str(tmp_path / "t"))
    dj = JaxVKitti2(scene, cache_dir=str(tmp_path / "j"))
    rng = np.random.RandomState(1)
    poses, depths = scene_depths(scene)
    disps = 1.0 / np.maximum(depths, 1e-3)
    F, h, w = disps.shape
    flows = rng.randn(F - 1, h, w, 2).astype(np.float32)
    a = dt.build_motion_masks(poses, disps, VKITTI_INTRINSICS / 16, flows)
    b = dj.build_motion_masks(poses, disps, VKITTI_INTRINSICS / 16, flows)
    np.testing.assert_array_equal(a, b)


# ---- (d) TartanAir and Replica

def test_tartan_pose_conversion_matches_jax():
    rng = np.random.RandomState(2)
    q = rng.randn(6, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    traj = np.concatenate([rng.randn(6, 3), q], -1)
    np.testing.assert_allclose(ttartan.tartan_pose_to_w2c(traj),
                               jtartan.tartan_pose_to_w2c(traj), rtol=0,
                               atol=1e-6)


def test_tartan_and_replica_indexes_match_jax(tmp_path):
    import cv2
    rng = np.random.RandomState(3)
    ta = tmp_path / "tartan" / "abandonedfactory" / "Easy" / "P000"
    (ta / "image_left").mkdir(parents=True)
    (ta / "depth_left").mkdir()
    rep = tmp_path / "replica" / "office0" / "results"
    rep.mkdir(parents=True)
    q = rng.randn(3, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.savetxt(ta / "pose_left.txt", np.concatenate([rng.randn(3, 3), q], -1))
    mats = np.tile(np.eye(4), (3, 1, 1))
    mats[:, :3, 3] = rng.randn(3, 3)
    np.savetxt(tmp_path / "replica" / "office0" / "traj.txt",
               mats.reshape(3, 16))
    for t in range(3):
        img = rng.randint(0, 255, (16, 16, 3), np.uint8)
        cv2.imwrite(str(ta / "image_left" / f"{t:06d}_left.png"), img)
        np.save(ta / "depth_left" / f"{t:06d}_left_depth.npy",
                rng.rand(16, 16).astype(np.float32))
        cv2.imwrite(str(rep / f"frame{t:06d}.jpg"), img)
        cv2.imwrite(str(rep / f"depth{t:06d}.png"),
                    rng.randint(1, 60000, (16, 16)).astype(np.uint16))
    for cls_t, cls_j, root in (
            (ttartan.TartanAirDataset, jtartan.TartanAirDataset, "tartan"),
            (ttartan.ReplicaDataset, jtartan.ReplicaDataset, "replica")):
        a = cls_t(str(tmp_path / root), cache_dir=str(tmp_path / "ct"))
        b = cls_j(str(tmp_path / root), cache_dir=str(tmp_path / "cj"))
        assert a.scene_info.keys() == b.scene_info.keys()
        for k in a.scene_info:
            np.testing.assert_allclose(a.scene_info[k]["poses"],
                                       b.scene_info[k]["poses"], rtol=0,
                                       atol=1e-6)
            assert a.scene_info[k]["images"] == b.scene_info[k]["images"]
        path = a.scene_info[next(iter(a.scene_info))]["depths"][0]
        np.testing.assert_array_equal(cls_t._read_depth(path),
                                      cls_j._read_depth(path))


# ---- (e) J3: the index cache of a second root

def test_index_cache_keys_the_root_j3(scene, tmp_path):
    """The JAX class reads the first root's index for a second root (J3,
    ROADMAP.md Queue 3); the port's class builds the second root's."""
    other = str(tmp_path / "other")
    write_synth_scene(other, views=("clone",), n_frames=5)
    cache = str(tmp_path / "cache")
    JaxVKitti2(scene, cache_dir=cache, aug_graph=False)
    stale = JaxVKitti2(other, cache_dir=cache, aug_graph=False)
    assert len(stale) == N_FRAMES
    assert stale.scene_info["Scene02"]["images"][0].startswith(scene)
    VKitti2Dataset(scene, cache_dir=cache, aug_graph=False)
    fresh = VKitti2Dataset(other, cache_dir=cache, aug_graph=False)
    assert len(fresh) == 5
    assert fresh.scene_info["Scene02"]["images"][0].startswith(other)
    # the same root reads its cache back
    again = VKitti2Dataset(other, cache_dir=cache, aug_graph=False)
    assert again.scene_info["Scene02"]["images"] == \
        fresh.scene_info["Scene02"]["images"]


# ---- (f) checkpoints

def test_checkpoint_round_trips(tmp_path):
    net = DroidNet.from_seed(0)
    d = str(tmp_path / "ckpt")
    assert checkpoint.load(d) is None and checkpoint.latest_step(d) is None
    checkpoint.save(d, 10, net)
    with torch.no_grad():
        net.fnet.conv1.weight.add_(1.0)
    path = checkpoint.save(d, 20, net)
    assert osp.basename(path) == "000020.pth"
    assert checkpoint.latest_step(d) == 20
    sd = checkpoint.load(d)
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
    old = checkpoint.load(d, step=10, template=DroidNet())
    assert torch.equal(old.fnet.conv1.weight + 1.0, net.fnet.conv1.weight)
    # resume_or_load: the latest checkpoint, else a reference .pth, else
    # the initial model
    got = checkpoint.resume_or_load(d, DroidNet())
    assert torch.equal(got.fnet.conv1.weight, net.fnet.conv1.weight)
    ref = str(tmp_path / "reference.pth")
    torch.save({f"module.{k}": v for k, v in
                DroidNet.from_seed(3).state_dict().items()}, ref)
    got = checkpoint.resume_or_load(str(tmp_path / "none"), DroidNet(),
                                    torch_path=ref,
                                    convert=load_droidnet_torch)
    assert torch.equal(got.cnet.conv1.weight,
                       DroidNet.from_seed(3).cnet.conv1.weight)
    init = DroidNet()
    assert checkpoint.resume_or_load(str(tmp_path / "none"), init) is init
    # a checkpoint of the trainer is a reference-format state dict
    assert torch.equal(load_droidnet_torch(path).fnet.conv1.weight,
                       net.fnet.conv1.weight)


# ---- (g) the CLIs

def run_cli(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_train_vo_cli_on_the_cpu(scene, tmp_path):
    res = run_cli("pvo_tpu_torch.scripts.train_vo",
                  ["--datapath", scene, "--device", "cpu", "--steps", "2",
                   "--iters", "2", "--n_frames", "3", "--crop_size", "64",
                   "96", "--log_every", "1", "--name", "tiny"], tmp_path)
    assert set(res) == {"steps", "grad_passes", "loss_last", "checkpoint",
                        "device"}
    assert res["steps"] == 2 and res["grad_passes"] >= 2
    assert np.isfinite(res["loss_last"]) and res["device"] == "cpu"
    ckpt = tmp_path / "checkpoints" / "tiny" / "000002.pth"
    assert ckpt.exists()
    load_droidnet_torch(str(ckpt))
    # restoring the step continues from it
    res = run_cli("pvo_tpu_torch.scripts.train_vo",
                  ["--datapath", scene, "--device", "cpu", "--steps", "1",
                   "--iters", "1", "--n_frames", "3", "--crop_size", "64",
                   "96", "--name", "tiny", "--ckpt", "2"], tmp_path)
    assert res["steps"] == 1
    assert not glob.glob(str(tmp_path / "BENCH_*.json"))


def test_bench_train_vo_cli_on_the_cpu(tmp_path):
    res = run_cli("pvo_tpu_torch.scripts.bench_train_vo",
                  ["--device", "cpu", "--steps", "3", "--iters", "2"],
                  tmp_path)
    for k in ("metric", "value", "unit", "vs_baseline", "loss_initial",
              "loss_final", "steps_per_sec", "ckpt_roundtrip_ok",
              "loss_curve", "loss_first10pct", "loss_last10pct",
              "canary_ok", "gt_l_first10pct", "gt_l_last10pct",
              "peak_mem_gib", "device"):
        assert k in res, k
    assert res["metric"] == "vo_train_loss_ratio"
    assert res["ckpt_roundtrip_ok"] is True and len(res["loss_curve"]) == 3
    assert res["peak_mem_gib"] is None and res["device"] == "cpu"
    assert not glob.glob(str(tmp_path / "BENCH_*.json"))
    assert not os.listdir(tmp_path)


def test_default_protocol_asserts_its_canary(monkeypatch, capsys):
    """B6: the default protocol's canary is the dynamic-mask BCE (gt_l:
    its last tenth below half its first), which falls in both packages
    where the total loss's ratio wanders; at its checked length (20
    steps) the twin asserts it, and a canary that fails ends the run."""
    from pvo_tpu_torch.scripts import bench_train_vo
    steps = str(bench_train_vo.MIN_DEFAULT_CHECKED_STEPS)
    res = bench_train_vo.main(["--device", "cpu", "--steps", steps])
    assert res["canary_ok"] is True and res["gt_l_ratio"] < 0.5
    assert np.isfinite(res["loss_curve"]).all()
    failing = dict(res, canary_ok=False)
    monkeypatch.setattr(bench_train_vo, "default_protocol",
                        lambda *a, **kw: failing)
    with pytest.raises(SystemExit, match="dynamic-mask BCE did not fall"):
        bench_train_vo.main(["--device", "cpu", "--steps", steps])
    # shorter runs report the canary without asserting it
    bench_train_vo.main(["--device", "cpu", "--steps", "3"])
    capsys.readouterr()


def test_training_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from pvo_tpu_torch.parallel import data_parallel as dp
    from pvo_tpu_torch.scripts import bench_train_vo, train_vo
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_train_vo.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vo.main(["--datapath", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.dryrun()
