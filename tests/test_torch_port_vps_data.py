"""The port's VPS training inputs and entry points on the CPU:
``pvo_tpu_torch.vps.config`` (the four cases of tests/test_vps_config.py,
the defaults equal to the JAX package's, unknown keys and unmodelled
values refused), ``pvo_tpu_torch.vps.datasets`` against
:mod:`pvo_tpu.vps.datasets` on a synthetic scene prepared by the port's
``prepare_vkitti`` (records and training samples equal), the padding to
32 (fault J6 of the JAX CLI), ``train_vps --device cpu`` in a subprocess
at tiny size (both modes, checkpoints that ``load`` restores bit-equal,
a resume from them) and the two bench twins at toy sizes.
"""

import glob
import json
import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vps import config as jconfig
from pvo_tpu.vps import datasets as jdatasets
from pvo_tpu.vps.panoptic_fpn import PanopticFPN as JaxPanopticFPN
from pvo_tpu_torch.data.synth_scene import write_synth_scene
from pvo_tpu_torch.scripts import (bench_train_vps, bench_vps_train,
                                   prepare_vkitti, train_vps)
from pvo_tpu_torch.utils import checkpoint
from pvo_tpu_torch.vps import datasets
from pvo_tpu_torch.vps.config import CfgNode, build_predictor, get_cfg
from pvo_tpu_torch.vps.panoptic_fpn import PanopticFPN, PanopticPredictor

from torch_one_thread import one_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
N_FRAMES = 7


# ---------------- config ----------------


def test_defaults():
    cfg = get_cfg()
    assert cfg.MODEL.PANOPTIC_FPN.FUSION is False
    assert cfg.MODEL.ROI_HEADS.NUM_CLASSES == 3
    assert cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES == 12
    assert cfg == jconfig.get_cfg()


def test_merge_from_list():
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.PANOPTIC_FPN.FUSION", True,
                         "SOLVER.BASE_LR", 1e-3])
    assert cfg.MODEL.PANOPTIC_FPN.FUSION is True
    assert cfg.SOLVER.BASE_LR == 1e-3
    with pytest.raises(KeyError, match="MODEL.NO_SUCH"):
        cfg.merge_from_list(["MODEL.NO_SUCH.KEY", 1])


def test_merge_from_yaml(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(
        "MODEL:\n  PANOPTIC_FPN:\n    FUSION: true\n"
        "INPUT:\n  MIN_SIZE_TEST: 240\n")
    cfg = get_cfg()
    cfg.merge_from_file(str(p))
    assert cfg.MODEL.PANOPTIC_FPN.FUSION is True
    assert cfg.INPUT.MIN_SIZE_TEST == 240
    # untouched defaults survive the merge
    assert cfg.MODEL.ROI_HEADS.NUM_CLASSES == 3
    p.write_text("MODEL:\n  KEYPOINT_ON: true\n")
    with pytest.raises(KeyError, match="MODEL.KEYPOINT_ON"):
        get_cfg().merge_from_file(str(p))


def test_clone_independent():
    a = get_cfg()
    b = a.clone()
    b.MODEL.PANOPTIC_FPN.FUSION = True
    assert a.MODEL.PANOPTIC_FPN.FUSION is False
    assert isinstance(b.MODEL, CfgNode)


def test_build_predictor():
    model = PanopticFPN(backbone_blocks=(1, 1, 1, 1))
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.PANOPTIC_FPN.COMBINE.OVERLAP_THRESH", 0.6])
    pred = build_predictor(cfg, model, device="cpu")
    assert isinstance(pred, PanopticPredictor)
    assert pred.device.type == "cpu"
    assert pred.combine_kwargs == {"overlap_threshold": 0.6,
                                   "stuff_area_thresh": 4096,
                                   "instances_score_thresh": 0.5}
    for key, val in (("MODEL.RESNETS.DEPTH", 101),
                     ("MODEL.ROI_HEADS.NUM_CLASSES", 8),
                     ("MODEL.RPN.NMS_THRESH", 0.6),
                     ("MODEL.PIXEL_STD", [57.4, 57.1, 58.4])):
        bad = get_cfg()
        bad.merge_from_list([key, val])
        with pytest.raises(ValueError, match=key):
            build_predictor(bad, model, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_predictor(cfg, model, device="cuda")


# ---------------- datasets ----------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A synthetic scene (7 frames, clone view) prepared by the port."""
    root = str(tmp_path_factory.mktemp("vps_scene"))
    write_synth_scene(root, views=("clone",), n_frames=N_FRAMES)
    prepare_vkitti.main(["--datapath", root, "--scenes", "Scene02",
                         "--views", "clone", "--device", "cpu"])
    return root


def registered(root, shared):
    catalog = datasets.register_vkitti(datasets.Catalog(), root, shared,
                                       scenes=("Scene02",))
    jdatasets.register_vkitti(root, shared)
    return catalog


def test_records_match_jax(scene, tmp_path):
    """The port's registrations read the JAX ones' records, whose loaders
    name all five vkitti scenes (the other four are absent here and give
    none), except for the panoptic PNG (J7): the JAX loader looks for
    <rgb name>.png, the port takes the annotation's file name."""
    shared = str(tmp_path / "shared_data")
    catalog = registered(scene, shared)
    assert catalog.list_datasets() == ["vkitti_511_train", "vkitti_511_val",
                                       "vkitti_clone", "vkitti_test"]
    for name in ("vkitti_511_train", "vkitti_511_val", "vkitti_clone"):
        recs, jrecs = catalog.get(name), jdatasets.get(name)
        assert len(recs) == len(jrecs) > 0
        for r, jr in zip(recs, jrecs):
            assert jr["pan_seg_file_name"] is None
            assert osp.basename(r["pan_seg_file_name"]) == \
                f"pan_{r['frame_index']:05d}.png"
            assert dict(r, pan_seg_file_name=None) == jr
        assert catalog.metadata(name) == jdatasets.metadata(name)
    train = catalog.get("vkitti_511_train")
    assert [r["frame_index"] for r in train] == [0, 1, 2, 3, 4]
    assert [r["frame_index"] for r in catalog.get("vkitti_511_val")] == [5]
    assert "ref_file_name" not in train[0] and "ref_file_name" in train[1]
    assert catalog.get("vkitti_test") == []


def test_train_samples_match_jax(scene, tmp_path):
    """The port's samples equal the JAX mapper's on the same record, the
    semantic labels with the thing trainIds as the head's class 0 (J8);
    on its own record (J7) the JAX mapper finds no instance."""
    shared = str(tmp_path / "shared_data")
    catalog = registered(scene, shared)
    recs = catalog.get("vkitti_511_train")
    # a flow file for the second frame: the pair mapper reads it
    os.makedirs(osp.join(shared, "full_flow"))
    flow = np.random.RandomState(0).randn(375, 1242, 2).astype(np.float32)
    np.save(recs[1]["flow_file_name"], flow)
    n_things = 0
    for rec, jrec in zip(recs[:3], jdatasets.get("vkitti_511_train")):
        got = datasets.train_sample_mapper(rec, max_instances=8)
        ref = jdatasets.train_sample_mapper(rec, max_instances=8)
        assert sorted(got) == sorted(ref)
        ref["sem_labels"] = np.where(ref["sem_labels"] >= 12, 0,
                                     ref["sem_labels"])
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert got[k].dtype == ref[k].dtype, k
        n_things += int(got["gt_valid"].sum())
        assert got["gt_masks"][got["gt_valid"]].sum(axis=(1, 2)).min() > 0
        assert not jdatasets.train_sample_mapper(jrec)["gt_valid"].any()
    assert n_things >= 6
    np.testing.assert_array_equal(
        datasets.train_sample_mapper(recs[1])["flow"], flow)
    v = datasets.video_pair_mapper(recs[1])
    assert set(v) == {"image", "sem_seg", "ref_image", "flow",
                      "segments_info"}


def test_semantic_targets_fit_the_head_j8(scene, tmp_path):
    """J8: prepare_vkitti's semantic maps hold the thing trainIds 12-14,
    which the JAX package feeds its 12-class loss as they are (NaN); the
    port's targets keep stuff 1..11, make things 0 and refuse other
    values."""
    from pvo_tpu.vps.losses import semseg_loss as jsemseg_loss
    from pvo_tpu_torch.vps.losses import semseg_loss

    catalog = registered(scene, str(tmp_path / "shared"))
    rec = catalog.get("vkitti_clone")[0]
    ref = jdatasets.train_sample_mapper(rec, max_instances=4)["sem_labels"]
    got = datasets.train_sample_mapper(rec, max_instances=4)["sem_labels"]
    assert set(np.unique(ref)) & {12, 13, 14}
    assert set(np.unique(got)) <= set(range(12))
    np.testing.assert_array_equal(got == 0, (ref >= 12) | (ref == 0))
    logits = np.zeros((1,) + ref.shape[1:] + (12,), np.float32)
    assert np.isnan(float(jsemseg_loss(jnp.asarray(logits),
                                       jnp.asarray(ref))))
    assert np.isfinite(float(semseg_loss(
        torch.zeros(1, 12, *ref.shape[1:]), torch.from_numpy(got))))
    with pytest.raises(ValueError, match="outside the vkitti trainIds"):
        datasets.semantic_targets(np.array([[3, 40]], np.uint8))


def test_samples_are_padded_to_32_j6(scene, tmp_path):
    """J6: the JAX model's semantic head cannot add its levels at
    vkitti's 375x1242, which the JAX train_vps feeds it unpadded; the
    port pads a sample to 384x1248 (labels with the ignore label) and its
    model runs there."""
    jm = JaxPanopticFPN(backbone_blocks=(1, 1, 1, 1))
    p = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jax.ShapeDtypeStruct((1, 384, 1248, 3), jnp.float32))

    def sem(size):
        x = jax.ShapeDtypeStruct((1,) + size + (3,), jnp.float32)
        return jax.eval_shape(lambda p, x: jm.apply(
            p, jm.apply(p, x, method="features"), size,
            method=lambda m, f, hw: m.sem_seg_head(f, hw)), p, x)

    with pytest.raises(TypeError, match="incompatible shapes"):
        sem((375, 1242))
    assert sem((384, 1248)).shape == (1, 384, 1248, 12)

    catalog = registered(scene, str(tmp_path / "shared"))
    sample = datasets.train_sample_mapper(catalog.get("vkitti_clone")[0],
                                          max_instances=4)
    padded = datasets.pad_to_divisor(sample)
    assert padded["image"].shape == (1, 384, 1248, 3)
    assert padded["gt_masks"].shape == (4, 384, 1248)
    assert (padded["sem_labels"][:, 375:] == 255).all()
    np.testing.assert_array_equal(padded["image"][:, :375, :1242],
                                  sample["image"])
    np.testing.assert_array_equal(padded["gt_boxes"], sample["gt_boxes"])
    model = PanopticFPN(backbone_blocks=(1, 1, 1, 1)).to("meta")
    x = torch.empty((1, 3, 384, 1248), device="meta")
    assert model.sem_seg_head(model.features(x), (384, 1248)).shape == \
        (1, 12, 384, 1248)


# ---------------- entry points ----------------


def run_cli(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_train_vps_cli_on_the_cpu(scene, tmp_path):
    out = str(tmp_path / "run")
    # no log line: the logger's TensorBoard writer imports TensorFlow
    # where it is installed (18 s)
    common = ["--datapath", scene, "--device", "cpu", "--tiny", "--scale",
              "0.25", "--max_instances", "4", "--log_every", "100"]
    res = run_cli("pvo_tpu_torch.scripts.train_vps",
                  common + ["--max_iter", "2", "--ckpt_every", "1",
                            "--out", out], tmp_path)
    assert res["iterations"] == 2 and np.isfinite(res["loss_last"])
    assert res["device"] == "cpu"
    assert sorted(os.listdir(out)) == ["000001.pth", "000002.pth"]
    saved = torch.load(osp.join(out, "000002.pth"), map_location="cpu")
    restored = checkpoint.load(out, template=train_vps.load_model(None,
                                                                  True))
    sd = restored.state_dict()
    assert sd.keys() == saved.keys()
    assert all(torch.equal(sd[k], saved[k]) for k in saved)
    assert not torch.equal(saved["fusion_conv1.weight"],
                           torch.load(osp.join(out, "000001.pth"))
                           ["backbone.fpn_output2.weight"][:256])
    # the fusion mode (in this process) from the checkpoint directory:
    # only the fusion conv moves
    out2 = str(tmp_path / "fusion")
    res = train_vps.main(common + ["--mode", "fusion", "--max_iter", "1",
                                   "--weights", out, "--out", out2])
    assert res["iterations"] == 1 and np.isfinite(res["loss_last"])
    tuned = torch.load(osp.join(out2, "000001.pth"), map_location="cpu")
    for k, v in saved.items():
        assert torch.equal(tuned[k], v) != k.startswith("fusion_conv1."), k
    assert not glob.glob(str(tmp_path / "BENCH_*.json"))


def test_bench_twins_at_toy_sizes(capsys):
    res = bench_train_vps.main(["--device", "cpu", "--steps", "12"])
    assert res["metric"] == "vps_fusion_train_loss_ratio"
    assert res["value"] < 0.9 and len(res["loss_curve"]) == 3
    assert res["peak_mem_gib"] is None and res["device"] == "cpu"
    out = bench_vps_train.full_protocol(3, "cpu", size=(64, 96),
                                        blocks=(1, 1, 1, 1), max_props=32,
                                        pre_nms_topk=64)
    assert out["metric"] == "vps_train_steps_per_sec" and out["value"] > 0
    assert out["losses_finite"] and len(out["loss_curve"]) == 4
    bench_vps_train.check(out)
    with pytest.raises(SystemExit, match="did not fall"):
        bench_vps_train.check(dict(out, loss_last=out["loss_first"]))
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["metric"] == "vps_fusion_train_loss_ratio"


def test_vps_training_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vps.main(["--datapath", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_train_vps.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_vps_train.main(["1"])
