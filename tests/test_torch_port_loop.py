"""The port's PVO loop driver against the JAX package, on the CPU.

- ``run_pvo_loop.feedback_segmentation`` copies what the JAX one copies,
  and the driver calls the same stages with the same flags as
  ``scripts/run_pvo_loop.py`` (apart from ``--device``), for ``--tiny``
  and full size;
- the whole loop, ``--tiny --iters 2``, on the synthetic scene: the
  artifact contracts of ``tests/test_pvo_loop.py`` and J2 (the fed-back
  maps reach no stage, so both iterations write the same trajectory).
  At 14 frames that run takes about 130 s here, so it is marked slow;
  the same checks run on 7 frames with VO at 64x96.

The scene and its preparation are held against the JAX package in
``tests/test_torch_port_scene.py``.
"""

import filecmp
import glob
import importlib.util
import json
import os.path as osp
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from pvo_tpu_torch.data import synth_scene  # noqa: E402
from pvo_tpu_torch.scripts import prepare_vkitti, run_pvo_loop  # noqa: E402
from torch_one_thread import one_thread  # noqa: F401


REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def jax_script(name):
    """A module of the JAX package's ``scripts/`` by file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", osp.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree(root):
    return sorted(osp.relpath(p, root) for p in
                  glob.glob(osp.join(root, "**", "*"), recursive=True)
                  if osp.isfile(p))


def assert_same_tree(a, b):
    files = tree(a)
    assert files and files == tree(b)
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)




def test_feedback_segmentation_copies_what_jax_copies(tmp_path):
    shared = tmp_path / "shared_data"
    src = shared / "panoptic_segm_fusion" / "inference" / "pan_seg"
    src.mkdir(parents=True)
    for i, name in enumerate(("Scene02_rgb_00010.png",
                              "Scene02_rgb_00011.png",
                              "Scene06_rgb_00001.png")):
        (src / name).write_bytes(bytes([i]) * 7)
    jax_loop = jax_script("run_pvo_loop")
    n_j = jax_loop.feedback_segmentation(str(shared), str(tmp_path / "a"),
                                         "Scene02")
    n_t = run_pvo_loop.feedback_segmentation(str(shared),
                                             str(tmp_path / "b"), "Scene02")
    assert n_j == n_t == 2
    assert_same_tree(str(tmp_path / "a"), str(tmp_path / "b"))
    assert tree(str(tmp_path / "b")) == [
        "Scene02/clone/panFPN_segm/rgb_00010.png",
        "Scene02/clone/panFPN_segm/rgb_00011.png"]


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
def test_stage_calls_match_the_jax_driver(tiny, tmp_path, monkeypatch):
    """Recorded instead of run: the port's driver calls the JAX driver's
    stages in its order with its flags, and adds ``--device``."""
    jax_loop = jax_script("run_pvo_loop")
    calls_j, calls_t = [], []
    monkeypatch.setattr(jax_loop, "run_stage",
                        lambda s, a: calls_j.append((s[:-len(".py")], a)))
    monkeypatch.setattr(run_pvo_loop, "run_stage",
                        lambda s, a: calls_t.append((s, a)))
    for mod in (jax_loop, run_pvo_loop):
        monkeypatch.setattr(mod, "feedback_segmentation", lambda *a: 0)
    argv = ["--datapath", str(tmp_path), "--iters", "2", "--weights_vo",
            "droid.pth", "--weights_vps", "panFPN.pth"] + \
        (["--tiny"] if tiny else [])
    monkeypatch.setattr(sys, "argv", ["run_pvo_loop.py"] + argv)
    jax_loop.main()
    run_pvo_loop.main(argv + ["--device", "cpu"])
    assert [s for s, _ in calls_j] == ["initial_segmentation"] + \
        ["test_vo", "test_vo2", "test_vps"] * 2
    assert all(a[-2:] == ["--device", "cpu"] for _, a in calls_t)
    assert [(s, a[:-2]) for s, a in calls_t] == calls_j


# ------------------------------------------------ the loop itself


class Reads:
    """Paths under ``watched`` that the stages list or read while ``on``:
    every stage finds its inputs with ``glob.glob`` and reads them with
    cv2, PIL or numpy."""

    def __init__(self, monkeypatch, watched):
        import cv2
        from PIL import Image

        self.watched, self.on, self.paths = watched, False, []
        for mod, name in ((glob, "glob"), (cv2, "imread"), (Image, "open"),
                          (np, "load")):
            monkeypatch.setattr(mod, name, self.wrap(getattr(mod, name)))

    def wrap(self, fn):
        def read(path, *a, **kw):
            if self.on and self.watched in str(path):
                self.paths.append(str(path))
            return fn(path, *a, **kw)
        return read


def run_loop(tmp_path, monkeypatch, n_frames, extra=()):
    """The port's loop, ``--tiny --iters 2 --device cpu``: returns the
    data root, the shared_data dir, each iteration's trajectory file's
    bytes and the stages' reads of clone/panFPN_segm."""
    monkeypatch.chdir(tmp_path)
    data, shared = str(tmp_path / "vkitti"), str(tmp_path / "shared_data")
    synth_scene.write_synth_scene(data, n_frames=n_frames, workers=2)
    prepare_vkitti.main(["--datapath", data, "--scenes", "Scene02",
                         "--device", "cpu"])
    reads = Reads(monkeypatch, osp.join("clone", "panFPN_segm"))
    trajs, stages = [], []
    run_stage = run_pvo_loop.run_stage
    traj = osp.join(shared, "traj", "Scene02", "15-deg-left", "pvo_traj.txt")

    def recorded(script, args):
        stages.append(script)
        reads.on = True
        try:
            run_stage(script, args)
        finally:
            reads.on = False
        if script == "test_vo":
            with open(traj, "rb") as f:
                trajs.append(f.read())

    monkeypatch.setattr(run_pvo_loop, "run_stage", recorded)
    run_pvo_loop.main(["--datapath", data, "--scenes", "Scene02", "--iters",
                       "2", "--tiny", "--shared_data", shared, "--device",
                       "cpu", *extra])
    assert stages == ["initial_segmentation"] + \
        ["test_vo", "test_vo2", "test_vps"] * 2
    return data, shared, trajs, reads.paths


def check_contracts(data, shared, n):
    """tests/test_pvo_loop.py's artifact contracts, scaled to n frames."""
    rows = np.loadtxt(osp.join(shared, "traj", "Scene02", "15-deg-left",
                               "pvo_traj.txt"))
    assert rows.shape == (n, 12) and np.isfinite(rows).all()
    flows = sorted(glob.glob(osp.join(shared, "full_flow", "Scene02_*.npy")))
    depths = sorted(glob.glob(osp.join(shared, "depth", "Scene02_*.npy")))
    assert len(flows) == len(depths) == n - 1
    fl = np.load(flows[0])
    assert fl.ndim == 3 and fl.shape[-1] == 2 and np.isfinite(fl).all()
    val = json.load(open(osp.join(data, "Scene02", "clone",
                                  "split_511.json")))["val"]
    names = [f"rgb_{k:05d}.png" for k in val]
    pans = sorted(glob.glob(osp.join(shared, "panoptic_segm_fusion",
                                     "inference", "pan_seg",
                                     "Scene02_*.png")))
    assert [osp.basename(p).split("_", 1)[1] for p in pans] == names
    rep = json.load(open(osp.join(shared, "vpq", "Scene02",
                                  "vpq-final.txt")))
    assert {"vpq_all", "vpq_thing", "vpq_stuff"} <= set(rep)
    # --tiny segments 15-deg-left only, so the clone view's panFPN_segm
    # holds exactly the fused val-slice maps the feedback copied in
    fed = sorted(glob.glob(osp.join(data, "Scene02", "clone", "panFPN_segm",
                                    "*.png")))
    assert [osp.basename(f) for f in fed] == names
    for p, f in zip(pans, fed):
        assert filecmp.cmp(p, f, shallow=False)


def check_j2(trajs, reads):
    """J2: the feedback reaches no stage, so iteration 2 repeats 1."""
    assert len(trajs) == 2 and trajs[0] == trajs[1]
    assert reads == []


def test_loop_feeds_back_into_no_stage(tmp_path, monkeypatch):
    """The loop on 7 frames (one in the val slice) with VO at 64x96
    (``--vo_image_size``):
    the artifact contracts, and J2."""
    data, shared, trajs, reads = run_loop(
        tmp_path, monkeypatch, 7, ["--vo_image_size", "64", "96"])
    check_contracts(data, shared, 7)
    check_j2(trajs, reads)


@pytest.mark.slow
def test_port_loop_on_synth_scene(tmp_path, monkeypatch):
    """tests/test_pvo_loop.py's run on the port, two iterations: 14
    frames, ``--tiny``."""
    data, shared, trajs, reads = run_loop(tmp_path, monkeypatch, 14)
    assert len(glob.glob(osp.join(data, "Scene02", "clone",
                                  "panoptic_gt_id", "*.png"))) == 14
    check_contracts(data, shared, 14)
    check_j2(trajs, reads)
