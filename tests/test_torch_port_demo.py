"""The image-directory demo's path in the port against the JAX package on
the CPU: ``utils/flow_vis``, ``data/streams``, the ``DepthVideo`` methods,
``native.id2rgb``, ``vo/visualization``, ``vo/live_viewer`` and the
``demo`` CLI.

* ``flow_to_image``: bit-equal to the JAX package's.
* The streams: frames, depths, timestamps and intrinsics equal to the JAX
  readers' on tiny PNG trees (``tests/test_streams.py``'s scenes); the
  TUM helpers equal. J9: the JAX ``parse_list`` raises ``AttributeError``
  under NumPy 2 (``np.unicode_`` is gone), the port's reads the list.
* ``append``, ``set_frame`` (a whole keyframe and single fields, with
  and without the segment filter): every buffer equal to the JAX video's
  (features bit-equal after the same bf16 rounding); ``reproject`` and
  ``distance_matrix`` within 1e-5 relative; ``pose_at`` equal.
* ``filtered_pointcloud`` on ``tests/test_live_viewer.py``'s toy video
  (the JAX side under x64, ``tests/conftest.py``): at least 99.9% of the
  masks equal, the points within 1e-4; the viewer's ``state.json`` (a
  counter, trajectory and frusta within 1e-4 of the JAX viewer's) and
  its page; ``update`` raising while the video is engaged; a port the
  server cannot bind raising.
* The demo on 16 synthetic frames, in this process with the frames
  resized to 48x152 (``demo.AREA``; the CLI's 240x800 takes minutes on
  the CPU): the planner engages (the viewer's refresh raises there and
  the demo marks the view stale), one finite pose a frame, the viewer's
  page and final state (its counter the keyframe count) fetched while
  the demo holds, the cloud and trajectory files.
"""

import glob
import io
import json
import os
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.data import streams as jstreams
from pvo_tpu.lie import se3 as jse3
from pvo_tpu.utils import flow_vis as jflow_vis
from pvo_tpu.vo import live_viewer as jlive
from pvo_tpu.vo import visualization as jvis
from pvo_tpu.vo.video import DepthVideo as JaxVideo
from pvo_tpu.geom.depth_filter import (backproject_points as jbackproject,
                                       depth_consistency_count as jcount)
from pvo_tpu_torch import native
from pvo_tpu_torch.parallel.data_parallel import free_port
from pvo_tpu_torch.data import streams
from pvo_tpu_torch.scripts import demo
from pvo_tpu_torch.utils import flow_vis, io as tio
from pvo_tpu_torch.vo import live_viewer, visualization
from pvo_tpu_torch.vo.video import DepthVideo

from test_live_viewer import _toy_video
from test_streams import _write_scene
from torch_one_thread import one_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

MASK_EQUAL, POINT_TOL, GEOM_RTOL = 0.999, 1e-4, 1e-5


# ---------------------------------------------------------------- flow_vis

@pytest.mark.parametrize("kw", [{}, {"clip_flow": 2.0},
                                {"rad_max": 5.0}])
def test_flow_to_image_is_bit_equal(kw):
    rng = np.random.RandomState(0)
    flow = (3.0 * rng.randn(17, 23, 2)).astype(np.float32)
    out = flow_vis.flow_to_image(flow, **kw)
    assert out.dtype == np.uint8 and out.shape == (17, 23, 3)
    np.testing.assert_array_equal(out, jflow_vis.flow_to_image(flow, **kw))
    np.testing.assert_array_equal(flow_vis._WHEEL, jflow_vis._WHEEL)


# ----------------------------------------------------------------- streams

def _frames_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if u is None or v is None:
                assert u is None and v is None
            else:
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("size", [None, (24, 32)])
def test_image_and_rgbd_streams_equal_jax(tmp_path, size):
    _write_scene(tmp_path, n=3, right=False)
    os.makedirs(tmp_path / "depth")
    rng = np.random.RandomState(1)
    for t in range(3):
        cv2.imwrite(str(tmp_path / "depth" / f"{t:06d}.png"),
                    rng.randint(0, 5000, (48, 64)).astype(np.uint16))
    intr = [100.0, 110.0, 32.0, 24.0]
    args = (str(tmp_path / "image_left"), intr)
    _frames_equal(list(streams.ImageStream(*args, image_size=size)),
                  list(jstreams.ImageStream(*args, image_size=size)))
    dargs = (str(tmp_path / "image_left"), str(tmp_path / "depth"), intr)
    port = list(streams.RGBDStream(*dargs, image_size=size))
    _frames_equal(port, list(jstreams.RGBDStream(*dargs, image_size=size)))
    assert port[0][3].dtype == np.float32 and port[0][3].max() > 0


def test_stereo_stream_equals_jax(tmp_path):
    _write_scene(tmp_path, n=4, hw=(37, 53))
    os.remove(tmp_path / "image_right" / "000002.png")
    h, w = 37, 53
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                         np.arange(h, dtype=np.float32))
    kw = dict(image_size=(24, 40), map_left=(gx, gy))
    port = streams.StereoStream(str(tmp_path), [100, 110, 26, 18], **kw)
    ref = jstreams.StereoStream(str(tmp_path), [100, 110, 26, 18], **kw)
    assert len(port) == len(ref) == 3
    _frames_equal(list(port), list(ref))


def test_tum_helpers_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    stamps = np.sort(rng.rand(20) * 10)
    rows = np.concatenate([stamps[:, None], rng.randn(20, 7)], 1)
    path = tmp_path / "groundtruth.txt"
    np.savetxt(path, rows, delimiter=" ", header="t tx ty tz qx qy qz qw")
    for a, b in zip(streams.load_tum_poses(path),
                    jstreams.load_tum_poses(path)):
        np.testing.assert_array_equal(a, b)
    ti, td = stamps[::2], stamps[1::2] + 0.01
    for tp in (None, stamps + 0.05):
        assert streams.associate_frames(ti, td, tp) == \
            jstreams.associate_frames(ti, td, tp)


def test_parse_list_reads_where_the_jax_one_raises_j9(tmp_path):
    """J9: NumPy 2.0 removed ``np.unicode_``, which the JAX
    ``parse_list`` passes as the dtype."""
    path = tmp_path / "rgb.txt"
    path.write_text("# header\n0.1 rgb/a.png\n0.2 rgb/b.png\n")
    out = streams.parse_list(path, skiprows=1)
    np.testing.assert_array_equal(out, [["0.1", "rgb/a.png"],
                                        ["0.2", "rgb/b.png"]])
    if hasattr(np, "unicode_"):
        np.testing.assert_array_equal(jstreams.parse_list(path, 1), out)
    else:
        with pytest.raises(AttributeError, match="unicode_"):
            jstreams.parse_list(path, skiprows=1)


def test_dataset_factory_refuses_an_unknown_name():
    for factory in (streams.dataset_factory, jstreams.dataset_factory):
        with pytest.raises(ValueError, match="unknown dataset"):
            factory(["kitti360"])


def test_native_id2rgb_equals_the_numpy_codec():
    ids = np.random.RandomState(3).randint(0, 2 ** 24, (13, 17))
    np.testing.assert_array_equal(native.id2rgb(ids), tio.id2rgb(ids))
    np.testing.assert_array_equal(native.rgb2id(native.id2rgb(ids)), ids)


# ------------------------------------------------------------- DepthVideo

HW, B = (32, 48), 4


def _videos(segm_filter):
    return (JaxVideo(image_size=HW, buffer=B, segm_filter=segm_filter),
            DepthVideo(image_size=HW, buffer=B, segm_filter=segm_filter))


def _assert_videos_equal(jv, pv):
    assert jv.counter == pv.counter
    np.testing.assert_array_equal(jv.tstamp, pv.tstamp)
    for name in (*DepthVideo.FRAME_FIELDS, "damping"):
        a = np.asarray(getattr(jv, name).astype(jnp.float32)
                       if getattr(jv, name).dtype == jnp.bfloat16
                       else getattr(jv, name))
        b = getattr(pv, name)
        b = (b.float() if b.dtype == torch.bfloat16 else b).numpy()
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


def _keyframe(rng, h, w):
    return dict(image=rng.randint(0, 255, HW + (3,)).astype(np.uint8),
                intrinsics=np.asarray([30.0, 31.0, 24.0, 16.0],
                                      np.float32),
                fmap=rng.randn(h, w, 128).astype(np.float32),
                net=rng.randn(h, w, 128).astype(np.float32),
                inp=rng.randn(h, w, 128).astype(np.float32))


def _pose(rng):
    q = rng.randn(4)
    return np.concatenate([0.1 * rng.randn(3), q / np.linalg.norm(q)]
                          ).astype(np.float32)


@pytest.mark.parametrize("segm_filter", [False, True])
def test_set_frame_and_append_equal_jax(segm_filter):
    jv, pv = _videos(segm_filter)
    rng = np.random.RandomState(4)
    h, w = pv.h, pv.w
    segm = rng.randint(0, 500, (h, w)) * (rng.rand(h, w) > 0.3)
    calls = [
        # a whole keyframe: no pose (pose and disparity kept), then a pose
        # with a scalar disparity, a map, the default disparity
        ("append", (0.5,), dict(_keyframe(rng, h, w), segm=segm)),
        ("append", (1.5,), dict(_keyframe(rng, h, w), pose=_pose(rng),
                                disp=0.7)),
        ("set_frame", (2, 2.5), dict(_keyframe(rng, h, w), pose=_pose(rng),
                                     disp=rng.rand(h, w).astype(np.float32),
                                     segm=segm)),
        ("set_frame", (3, 3.5), dict(_keyframe(rng, h, w), pose=_pose(rng))),
        # single fields
        ("set_frame", (1, 4.0), dict(pose=_pose(rng))),
        ("set_frame", (0, 5.0), dict(disp=rng.rand(h, w).astype(np.float32),
                                     segm=segm[::-1])),
        ("set_frame", (2, 6.0), dict(fmap=rng.randn(h, w, 128)
                                     .astype(np.float32),
                                     intrinsics=np.ones(4, np.float32))),
    ]
    for name, args, kw in calls:
        getattr(jv, name)(*args, **kw)
        getattr(pv, name)(*args, **kw)
        _assert_videos_equal(jv, pv)
    assert pv.counter == 4
    for ix in range(B):
        np.testing.assert_array_equal(pv.pose_at(ix), np.asarray(
            jv.pose_at(ix)))


def test_reproject_and_distance_matrix_equal_jax():
    jv, pv = _videos(False)
    rng = np.random.RandomState(5)
    h, w = pv.h, pv.w
    for t in range(B):
        kw = dict(_keyframe(rng, h, w), pose=_pose(rng),
                  disp=(0.5 + rng.rand(h, w)).astype(np.float32))
        kw["pose"][3:] = [0, 0, 0, 1]
        jv.append(t, **kw)
        pv.append(t, **kw)
    ii, jj = np.asarray([0, 1, 2, 3, 0]), np.asarray([1, 0, 3, 2, 3])
    (jc, jval), (pc, pval) = jv.reproject(ii, jj), pv.reproject(ii, jj)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=GEOM_RTOL,
                               atol=1e-4)
    np.testing.assert_array_equal(pval.numpy(), np.asarray(jval))
    jd, pd = jv.distance_matrix(), pv.distance_matrix()
    assert pd.shape == (B, B)
    np.testing.assert_allclose(pd, jd, rtol=GEOM_RTOL, atol=1e-6)


# ---------------------------------------------------- visualization, viewer

def _port_copy(jv):
    """The port's DepthVideo holding the JAX video's buffers."""
    pv = DepthVideo(image_size=(jv.ht, jv.wd), buffer=jv.buffer)
    pv.counter = jv.counter
    for name in ("poses", "disps", "images", "intrinsics"):
        getattr(pv, name).copy_(torch.from_numpy(np.array(getattr(jv,
                                                                  name))))
    return pv


def _jax_masks(jv, filter_thresh=0.005, min_count=2):
    """The masks of the JAX ``filtered_pointcloud`` (its lines, which
    return only the masked points)."""
    inds = jnp.arange(jv.counter)
    thresh = filter_thresh * jnp.sqrt(jnp.mean(jv.disps[inds], axis=(1, 2)))
    counts = jcount(jv.poses, jv.disps, jv.intrinsics[0], inds, thresh)
    points = np.asarray(jbackproject(jv.poses, jv.disps, jv.intrinsics[0],
                                     inds))
    disps = np.asarray(jv.disps[inds])
    masks = (np.asarray(counts) >= min_count) & \
        (disps > 0.5 * disps.mean(axis=(1, 2), keepdims=True))
    return points, masks


def _plane_video(n=8, hw=(64, 96)):
    """A JAX video of a fronto-parallel plane seen by a camera sliding
    sideways: most pixels are consistent (the toy video's random
    disparities keep almost none)."""
    v = JaxVideo(image_size=hw, buffer=16)
    rng = np.random.RandomState(6)
    v.counter = n
    tangents = np.zeros((n, 6), np.float32)
    tangents[:, 0] = 0.05 * np.arange(n)
    v.poses = v.poses.at[:n].set(jse3.exp(jnp.asarray(tangents)))
    v.disps = v.disps.at[:n].set(0.5)
    v.images = v.images.at[:n].set(jnp.asarray(
        rng.randint(0, 255, (n,) + hw + (3,), np.uint8)))
    v.intrinsics = v.intrinsics.at[:n].set(
        jnp.asarray([8.0, 8.0, 6.0, 4.0]))
    return v


@pytest.mark.parametrize("make", [_toy_video, _plane_video])
def test_filtered_pointcloud_matches_jax(make):
    jv = make()
    pv = _port_copy(jv)
    jpts, jmasks = _jax_masks(jv)
    ref_pts, ref_cols = jvis.filtered_pointcloud(jv)
    np.testing.assert_array_equal(jpts[jmasks], ref_pts)

    points, masks, colors = visualization.consistent_points(pv)
    masks = masks.numpy()
    assert (masks == jmasks).mean() >= MASK_EQUAL
    np.testing.assert_allclose(points.numpy(), jpts, atol=POINT_TOL, rtol=0)
    if make is _plane_video:
        assert (masks & jmasks).mean() > 0.5
    pts, cols = visualization.filtered_pointcloud(pv)
    assert len(pts) == masks.sum() and len(ref_pts) > 0
    assert pts.dtype == np.float32 and cols.dtype == np.uint8
    if (masks == jmasks).all():
        np.testing.assert_allclose(pts, ref_pts, atol=POINT_TOL, rtol=0)
        np.testing.assert_array_equal(cols, ref_cols)


def test_droid_visualization_writes_cloud_and_trajectory(tmp_path):
    jv = _toy_video()
    pv = _port_copy(jv)
    n = visualization.droid_visualization(pv, str(tmp_path / "p"))
    m = jvis.droid_visualization(jv, str(tmp_path / "j"))
    assert abs(n - m) <= (1 - MASK_EQUAL) * jv.counter * jv.h * jv.w
    np.testing.assert_allclose(np.loadtxt(tmp_path / "p" / "trajectory.txt"),
                               np.loadtxt(tmp_path / "j" / "trajectory.txt"),
                               atol=POINT_TOL, rtol=0)
    head = (tmp_path / "p" / "cloud.ply").read_text().splitlines()
    assert head[0] == "ply" and f"element vertex {len(range(0, n, 8))}" \
        in head


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}",
                                timeout=10) as r:
        return r.status, r.read()


def test_viewer_state_matches_jax():
    jv = _toy_video()
    pv = _port_copy(jv)
    jviewer = jlive.LiveViewer(jv, port=0, decimate=4)
    viewer = live_viewer.LiveViewer(pv, port=0, decimate=4)
    try:
        status, page = _get(viewer.port, "")
        assert status == 200 and page == _get(jviewer.port, "")[1]
        assert _get(viewer.port, "state.json")[1] == \
            _get(jviewer.port, "state.json")[1]
        viewer.update()
        jviewer.update()
        s = json.loads(_get(viewer.port, "state.json")[1])
        js = json.loads(_get(jviewer.port, "state.json")[1])
        assert set(s) == set(js) and s["counter"] == js["counter"] == 6
        assert not s["stale"]
        for key in ("trajectory", "frusta"):
            np.testing.assert_allclose(np.asarray(s[key]),
                                       np.asarray(js[key]),
                                       atol=POINT_TOL, rtol=0)
        assert len(s["frusta"]) == 8 * 6
        pts = np.asarray(s["points"])
        assert pts.shape[1] == 3 and np.isfinite(pts).all()
        assert abs(len(pts) - len(js["points"])) <= \
            (1 - MASK_EQUAL) * len(js["points"]) + 1
        viewer.mark_stale()
        assert json.loads(_get(viewer.port, "state.json")[1])["stale"]
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _get(viewer.port, "nothing")
    finally:
        viewer.close()
        jviewer.close()


def test_viewer_update_raises_while_the_planner_is_engaged():
    pv = _port_copy(_toy_video())
    viewer = live_viewer.LiveViewer(pv, port=0)
    try:
        pv.engaged = True
        with pytest.raises(RuntimeError, match="planner is engaged"):
            viewer.update()
        with pytest.raises(RuntimeError, match="planner is engaged"):
            visualization.filtered_pointcloud(pv)
        pv.engaged = False
        viewer.update()
    finally:
        viewer.close()


def test_viewer_refuses_a_port_it_cannot_bind():
    viewer = live_viewer.LiveViewer(_port_copy(_toy_video()), port=0)
    try:
        with pytest.raises(OSError):
            live_viewer.LiveViewer(viewer.video, port=viewer.port)
    finally:
        viewer.close()


# --------------------------------------------------------------- the demo

N_DEMO = 16


@pytest.fixture(scope="module")
def demo_dir(tmp_path_factory):
    """16 frames of the synthetic scene as PNGs, ``calib.txt`` and tamed
    weights under the reference key names."""
    from pvo_tpu_torch.data.synth_scene import write_synth_scene
    from pvo_tpu_torch.scripts.bench_track import tame_net

    root = tmp_path_factory.mktemp("demo")
    write_synth_scene(str(root), scene="Scene02", views=("clone",),
                      n_frames=N_DEMO, workers=2)
    os.makedirs(root / "images")
    for f in sorted(glob.glob(str(root / "Scene02/clone/frames/rgb/"
                                         "Camera_0/*.jpg"))):
        name = os.path.basename(f)[:-4] + ".png"
        cv2.imwrite(str(root / "images" / name), cv2.imread(f))
    np.savetxt(root / "calib.txt", tio.VKITTI_INTRINSICS[None],
               delimiter=" ")
    net = tame_net(0, 0.2, -2.0)
    torch.save({f"module.{k}": v for k, v in net.state_dict().items()},
               root / "droid.pth")
    return root


def test_demo_runs_end_to_end_on_the_cpu(demo_dir, tmp_path, monkeypatch,
                                         capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(demo, "AREA", 48 * 160)
    refused, held = [], {}
    mark_stale = live_viewer.LiveViewer.mark_stale

    def stale(self, stale=True):
        # the demo marks the view stale while the planner is engaged;
        # a refresh there must raise
        with pytest.raises(RuntimeError, match="planner is engaged"):
            self.update()
        refused.append(self.video.counter)
        return mark_stale(self, stale)

    def hold(prompt=""):
        # what a user sees while the demo holds its final state
        held["page"] = _get(port, "")[1]
        held["state"] = json.loads(_get(port, "state.json")[1])
        raise EOFError

    port = free_port()
    monkeypatch.setattr(live_viewer.LiveViewer, "mark_stale", stale)
    monkeypatch.setattr("builtins.input", hold)
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    demo.main(["--imagedir", str(demo_dir / "images"), "--calib",
               str(demo_dir / "calib.txt"), "--stride", "1", "--vis",
               "--live", str(port), "--live_every", "2", "--weights",
               str(demo_dir / "droid.pth"), "--device", "cpu"])
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")][-1]
    assert out["frames"] == N_DEMO and out["image_size"] == [48, 152]
    assert refused, "the planner never engaged"
    traj = np.loadtxt(tmp_path / "demo_traj.txt")
    assert traj.shape == (N_DEMO, 7) and np.isfinite(traj).all()
    kf = np.loadtxt(tmp_path / "viz" / "trajectory.txt")
    assert kf.shape == (out["keyframes"], 3) and np.isfinite(kf).all()
    assert (tmp_path / "viz" / "cloud.ply").read_text().startswith("ply")
    assert b"webgl" in held["page"]
    assert held["state"]["counter"] == out["keyframes"] >= 12
    assert not held["state"]["stale"]
    assert len(held["state"]["trajectory"]) == out["keyframes"]
