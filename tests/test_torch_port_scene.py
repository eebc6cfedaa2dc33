"""The port's synthetic scene and dataset preparation against the JAX
package, on the CPU: ``data/synth_scene.py`` writes the same files, byte
for byte, as :mod:`pvo_tpu.data.synth_scene` (one thread or several);
``pipeline/preparing.py`` and ``scripts/prepare_vkitti.py`` (with
``--dynamic_masks``) write the same artifacts as the JAX ones.
"""

import filecmp
import glob
import os.path as osp
import shutil
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from pvo_tpu.data import synth_scene as jax_synth  # noqa: E402
from pvo_tpu.pipeline import preparing as jax_preparing  # noqa: E402
from pvo_tpu_torch.data import synth_scene  # noqa: E402
from pvo_tpu_torch.pipeline import preparing  # noqa: E402
from pvo_tpu_torch.scripts import prepare_vkitti  # noqa: E402
from test_torch_port_loop import assert_same_tree, jax_script, tree  # noqa: E402,E501
from torch_one_thread import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def scene3(tmp_path_factory):
    """The JAX generator's scene, 2 views, 3 frames."""
    root = str(tmp_path_factory.mktemp("jax_scene"))
    jax_synth.write_synth_scene(root, n_frames=3)
    return root


@pytest.mark.parametrize("workers", [1, 3])
def test_synth_scene_writes_the_jax_generators_bytes(scene3, tmp_path,
                                                      workers):
    port = str(tmp_path / "port")
    synth_scene.write_synth_scene(port, n_frames=3, workers=workers)
    assert len(tree(port)) == 2 * (1 + 3 * 6)
    assert_same_tree(scene3, port)


def test_segments_info_and_prepare_scene_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    maps = [rng.choice([0, 10000, 20001, 20002, 130001], (12, 20))
            for _ in range(3)]
    for m in maps:
        assert preparing.segments_info_from_map(m) == \
            jax_preparing.segments_info_from_map(m)
    names = ["rgb_00010", "rgb_00011", "rgb_00012"]
    a = jax_preparing.prepare_scene("Scene02", maps, names,
                                    str(tmp_path / "jax"))
    b = preparing.prepare_scene("Scene02", maps, names, str(tmp_path / "port"))
    assert_same_tree(a, b)
    assert len(tree(b)) == 4


@pytest.mark.parametrize("dynamic_masks", [False, True],
                         ids=["plain", "dynamic_masks"])
def test_prepare_vkitti_matches_jax(scene3, tmp_path, monkeypatch,
                                    dynamic_masks):
    """Both CLIs on copies of one scene write the same files (the
    panoptic id maps, semantic maps, COCO json, split and, with
    ``--dynamic_masks``, the masks)."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(scene3, a)
    shutil.copytree(scene3, b)
    flags = ["--scenes", "Scene02"] + \
        (["--dynamic_masks"] if dynamic_masks else [])
    jax_prep = jax_script("prepare_vkitti")
    monkeypatch.setattr(sys, "argv", ["prepare_vkitti.py", "--datapath", a]
                        + flags)
    jax_prep.main()
    prepare_vkitti.main(["--datapath", b, "--device", "cpu"] + flags)
    assert_same_tree(a, b)
    masks = glob.glob(osp.join(b, "Scene02", "*", "frames", "dynamicMask",
                               "Camera_0", "*.npy"))
    assert len(masks) == (6 if dynamic_masks else 0)
    if dynamic_masks:
        # the masks are not trivial: the moving van is dynamic
        m = np.stack([np.load(f) for f in masks])
        assert m.shape == (6, 375, 1242, 2) and 0 < m[..., 0].mean() < 1
    # the port's prepare_view alone, into another directory
    out = str(tmp_path / "view")
    assert prepare_vkitti.prepare_view(osp.join(b, "Scene02", "clone"),
                                       out) == 3
    files = tree(out)
    assert len(files) == 2 + 2 * 3
    _, mismatch, errors = filecmp.cmpfiles(
        out, osp.join(a, "Scene02", "clone"), files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
