"""The port's VPS pipeline glue against :mod:`pvo_tpu.pipeline` on the same
inputs, on the CPU: id tracking (the forward splat), instance matching,
PQ/VPQ (the cases of tests/test_pipeline.py, and the same numbers as the
JAX package on random sequences), the native helpers with and without the
C library, the id codec; and the VPS CLIs (``initial_segmentation``,
``test_vps``, ``benchmark_vps``) with ``--tiny --device cpu`` on the
synthetic vkitti scene.
"""

import glob
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pvo_tpu import native as jnative
from pvo_tpu.pipeline import matching as jmatching
from pvo_tpu.pipeline import pq as jpq
from pvo_tpu.pipeline import tracking as jtracking
from pvo_tpu_torch import native
from pvo_tpu_torch.pipeline import evaluator, matching, pq, tracking
from pvo_tpu_torch.scripts import benchmark_vps, initial_segmentation
from pvo_tpu_torch.scripts import test_vps as vps_cli
from pvo_tpu_torch.utils.io import id2rgb, rgb2id

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAR = 13  # vkitti thing trainId


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the tests run in six processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def square_map(h, w, boxes):
    m = np.zeros((h, w), np.int64)
    for sid, y0, y1, x0, x1 in boxes:
        m[y0:y1, x0:x1] = sid
    return m


def segs_of(m, crowd=()):
    out = []
    for sid, area in zip(*np.unique(m, return_counts=True)):
        if sid == 0:
            continue
        out.append({"id": int(sid), "category_id": int(sid // 10000),
                    "area": int(area), "iscrowd": 1 if sid in crowd else 0})
    return out


def random_panoptic(rng, h=32, w=48, n=6):
    """A panoptic map of a few things and two stuff classes."""
    m = np.zeros((h, w), np.int64)
    m[: h // 2] = 5 * 10000
    m[h // 2:] = 6 * 10000
    for i in range(n):
        y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
        cat = (12, 13, 14)[i % 3]
        m[y0:y0 + rng.randint(4, 10), x0:x0 + rng.randint(4, 12)] = \
            cat * 10000 + i + 1
    return m


# ------------------------------------------------------------ tracking

def test_splat_shifts_and_depth_resolves_collisions():
    seg = square_map(16, 16, [(CAR * 10000 + 1, 4, 8, 4, 8)])
    flow = np.zeros((16, 16, 2), np.float32)
    flow[..., 0] = 3
    out = tracking.forward_splat_ids(seg, flow)
    assert out[5, 8] == CAR * 10000 + 1 and out[5, 4] == 0
    seg = np.zeros((8, 8), np.int64)
    seg[2, 2], seg[2, 4] = 100, 200
    flow = np.zeros((8, 8, 2), np.float32)
    flow[2, 2, 0] = 2
    depth = np.ones((8, 8), np.float32)
    depth[2, 4] = 5.0
    assert tracking.forward_splat_ids(seg, flow, depth)[2, 4] == 100


@pytest.mark.parametrize("with_depth", [False, True])
def test_track_sequence_equals_jax(with_depth):
    rng = np.random.RandomState(1 + with_depth)
    segms = [random_panoptic(rng) for _ in range(4)]
    flows = [rng.uniform(-3, 3, (32, 48, 2)).astype(np.float32)
             for _ in range(3)]
    depths = ([rng.rand(32, 48).astype(np.float32) for _ in range(3)]
              if with_depth else None)
    got = tracking.track_sequence(segms, flows, depths)
    want = jtracking.track_sequence(segms, flows, depths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ matching

def test_matcher_propagates_and_mints_ids():
    m = matching.InstanceMatcher()
    f0 = square_map(32, 32, [(CAR * 10000 + 7, 4, 12, 4, 12)])
    r0 = m(f0, np.zeros_like(f0))
    first = r0[6, 6]
    assert first // 10000 == CAR
    f1 = square_map(32, 32, [(CAR * 10000 + 3, 5, 13, 6, 14),
                             (CAR * 10000 + 4, 20, 28, 20, 28)])
    warped = square_map(32, 32, [(CAR * 10000 + 7, 5, 13, 5, 13)])
    r1 = m(f1, warped)
    assert r1[8, 8] == first
    assert r1[24, 24] not in (0, first)


def test_match_sequence_equals_jax():
    rng = np.random.RandomState(3)
    cur = [random_panoptic(rng) for _ in range(5)]
    warped = [np.zeros_like(cur[0])] + [
        np.roll(c, 1, axis=1) for c in cur[:-1]]
    got = matching.match_sequence(cur, warped)
    want = jmatching.match_sequence(cur, warped)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------- PQ/VPQ

CATS = {13: {"isthing": 1, "name": "Car"},
        5: {"isthing": 0, "name": "Building"}}


def test_pq_perfect_and_miss():
    g = square_map(64, 64, [(5 * 10000, 0, 32, 0, 64),
                            (CAR * 10000 + 1, 40, 60, 10, 30)])
    res, _ = pq.pq_compute([g], [g.copy()], [segs_of(g)], [segs_of(g)],
                           CATS)
    assert abs(res["All"]["pq"] - 1.0) < 1e-9
    g = square_map(64, 64, [(CAR * 10000 + 1, 0, 32, 0, 32)])
    p = np.zeros_like(g)
    stat = pq.tube_pq_stat([g], [p], [segs_of(g)], [segs_of(p)], CATS)
    assert stat[CAR].fn == 1 and stat[CAR].tp == 0


def test_vpq_penalizes_id_switch():
    g = square_map(32, 32, [(CAR * 10000 + 2, 4, 20, 4, 20)])
    gs = [g.copy() for _ in range(5)]
    p2 = square_map(32, 32, [(CAR * 10000 + 9, 4, 20, 4, 20)])
    ps = [g, g, p2, p2, p2]
    avg, per_k = pq.vpq_compute(gs, ps, [segs_of(g)] * 5,
                                [segs_of(p) for p in ps], CATS,
                                windows=(1, 5))
    assert per_k[1]["All"]["pq"] > 0.99 and per_k[5]["All"]["pq"] < 0.5


@pytest.mark.parametrize("workers", [0, 2])
def test_pq_and_vpq_equal_jax(workers):
    """Random predictions against random ground truth, with a crowd
    segment: every PQ number and the per-category counts equal."""
    rng = np.random.RandomState(4)
    gts = [random_panoptic(rng) for _ in range(6)]
    preds = [np.where(rng.rand(*g.shape) < 0.1, 0, np.roll(g, t % 3, 1))
             for t, g in enumerate(gts)]
    gsegs = [segs_of(g, crowd=(12 * 10000 + 1,)) for g in gts]
    psegs = [[{k: v for k, v in s.items() if k != "area"}
              for s in segs_of(p)] for p in preds]
    cats = pq.vkitti_categories()
    assert cats == jpq.vkitti_categories()
    res, stat = pq.pq_compute(gts, preds, gsegs, psegs, cats,
                              workers=workers)
    jres, jstat = jpq.pq_compute(gts, preds, gsegs, psegs, cats,
                                 workers=workers)
    assert res == jres
    assert {k: (v.tp, v.fp, v.fn, v.iou) for k, v in stat.per_cat.items()} \
        == {k: (v.tp, v.fp, v.fn, v.iou) for k, v in jstat.per_cat.items()}
    avg, per_k = pq.vpq_compute(gts, preds, gsegs, psegs, cats,
                                windows=(1, 3, 5))
    javg, jper_k = jpq.vpq_compute(gts, preds, gsegs, psegs, cats,
                                   windows=(1, 3, 5))
    assert avg == javg and per_k == jper_k


# -------------------------------------------------------------- native

def numpy_branch(fn, *args, **kw):
    """``fn`` as it runs where the C library does not build."""
    saved = native._load
    native._load = lambda: None
    try:
        return fn(*args, **kw)
    finally:
        native._load = saved


def test_pair_counts_library_and_numpy_agree():
    """pq.tube_pq_stat counts every tube's intersections here: a build
    that fails on the card (numpy branch) must give the same keys and
    counts as the C library, and as the JAX package's."""
    rng = np.random.RandomState(5)
    a = rng.randint(0, 40, 20000) * 10000 + rng.randint(0, 3, 20000)
    b = rng.randint(0, 25, 20000) * 10000
    got = native.pair_counts(a, b, pq.OFFSET)
    plain = numpy_branch(native.pair_counts, a, b, pq.OFFSET)
    jk, jc = jnative.pair_counts(a, b, pq.OFFSET)
    assert native.available()
    for k, c in (got, (jk, jc)):
        np.testing.assert_array_equal(k, plain[0])
        np.testing.assert_array_equal(c, plain[1])
    assert plain[1].sum() == a.size and np.all(np.diff(plain[0]) > 0)


def test_native_builds_beside_the_port_and_leaves_the_jax_library():
    """The port's library is its own (hashed name, in an ignored
    directory of the port); the tracked native/libpvo_native.so of the
    JAX package is never rebuilt by it."""
    tracked = os.path.join(REPO, "native", "libpvo_native.so")
    before = hashlib.sha256(open(tracked, "rb").read()).hexdigest()
    path = native.library_path()
    assert native.available() and path.exists()
    assert path.parent.name == "native_build" and \
        path.parent.parent.name == "pvo_tpu_torch"
    assert hashlib.sha256(open(tracked, "rb").read()).hexdigest() == before


def test_vkitti_ids_round_trip_the_png_codec():
    """combine_panoptic writes cat * 10000 + seg_id (and cat * 10000 for
    stuff); id2rgb -> rgb2id gives them back, with the library and
    without."""
    cats = np.arange(1, 15)
    ids = np.concatenate([cats * 10000, (cats[:, None] * 10000 +
                                         np.arange(1, 60)[None]).ravel()])
    m = np.resize(ids, (40, 50)).astype(np.int32)
    rgb = id2rgb(m)
    assert rgb.dtype == np.uint8 and rgb.shape == (40, 50, 3)
    np.testing.assert_array_equal(rgb2id(rgb), m)
    np.testing.assert_array_equal(native.rgb2id(rgb), m)
    np.testing.assert_array_equal(numpy_branch(native.rgb2id, rgb), m)


def test_evaluator_writes_pngs_and_pq(tmp_path):
    g = square_map(32, 32, [(5 * 10000, 0, 16, 0, 32),
                            (CAR * 10000 + 1, 20, 30, 4, 20)])
    ev = evaluator.PanopticEvaluator(str(tmp_path))
    ev.process("frame_00001.jpg", g, segs_of(g))
    from PIL import Image
    png = np.array(Image.open(tmp_path / "pan_seg" / "frame_00001.png"))
    np.testing.assert_array_equal(rgb2id(png), g)
    res = ev.evaluate([g], [segs_of(g)], categories=CATS)
    assert abs(res["All"]["pq"] - 1.0) < 1e-9
    assert json.load(open(tmp_path / "pq_results.json"))["All"]["n"] == 2


# ----------------------------------------------------------------- CLIs

N_FRAMES = 14


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    pytest.importorskip("cv2")
    from pvo_tpu.data.synth_scene import write_synth_scene
    root = tmp_path_factory.mktemp("vkitti")
    write_synth_scene(str(root), views=("clone",), n_frames=N_FRAMES)
    return str(root)


def run_cli(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_initial_segmentation_cli_writes_the_segm_pngs(tmp_path):
    pytest.importorskip("cv2")
    from pvo_tpu.data.synth_scene import write_synth_scene
    write_synth_scene(str(tmp_path), views=("15-deg-left",), n_frames=2)
    out = run_cli("pvo_tpu_torch.scripts.initial_segmentation",
                  ["--datapath", str(tmp_path), "--scenes", "Scene02",
                   "--views", "15-deg-left", "--tiny", "--scale", "0.25",
                   "--device", "cpu"], str(tmp_path))
    assert "Scene02/15-deg-left: 2 frames" in out
    files = sorted(glob.glob(str(tmp_path / "Scene02" / "15-deg-left" /
                                 "panFPN_segm" / "*.png")))
    assert [os.path.basename(f) for f in files] == \
        ["rgb_00000.png", "rgb_00001.png"]
    from PIL import Image
    ids = rgb2id(np.array(Image.open(files[0])))
    assert ids.shape == (94, 310) and (ids > 0).any()


def test_test_vps_cli_writes_fused_maps_and_vpq(scene, tmp_path):
    """The 5:1:1 validation slice of 14 frames (frames 10, 11), fused with
    a flow file for the second; GT maps written for the scene's frames."""
    base = os.path.join(scene, "Scene02", "clone")
    gt_dir = os.path.join(base, "panoptic_gt_id")
    os.makedirs(gt_dir, exist_ok=True)
    from PIL import Image
    g = np.zeros((375, 1242), np.int32)
    g[:200] = 2 * 10000
    g[200:] = 6 * 10000
    g[250:330, 400:600] = CAR * 10000 + 1
    for t in range(N_FRAMES):
        Image.fromarray(id2rgb(g)).save(os.path.join(gt_dir,
                                                     f"{t:05d}.png"))
    shared = tmp_path / "shared_data"
    os.makedirs(shared / "full_flow")
    flow = np.zeros((375, 1242, 2), np.float32)
    flow[..., 0] = 4.0
    np.save(shared / "full_flow" / "Scene02_rgb_00011.npy", flow)
    out = run_cli("pvo_tpu_torch.scripts.test_vps",
                  ["--datapath", scene, "--scene", "Scene02",
                   "--shared_data", str(shared), "--tiny", "--scale",
                   "0.25", "--device", "cpu"], str(tmp_path))
    pngs = sorted(glob.glob(str(shared / "panoptic_segm_fusion" /
                                "inference" / "pan_seg" / "*.png")))
    assert [os.path.basename(p) for p in pngs] == \
        ["Scene02_rgb_00010.png", "Scene02_rgb_00011.png"]
    assert np.array(Image.open(pngs[1])).shape == (94, 310, 3)
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["scene"] == "Scene02" and 0 <= rec["vpq_all"] <= 100
    saved = json.load(open(shared / "vpq" / "Scene02" / "vpq-final.txt"))
    assert saved == rec


def test_test_vps_refuses_use_depth(tmp_path):
    with pytest.raises(SystemExit):
        vps_cli.parse_args(["--datapath", str(tmp_path), "--scene", "S",
                            "--use_depth"])


@pytest.mark.parametrize("main", [initial_segmentation.main, vps_cli.main,
                                  benchmark_vps.main],
                         ids=["initial_segmentation", "test_vps",
                              "benchmark_vps"])
def test_entry_points_never_pick_the_cpu_by_themselves(main, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = {benchmark_vps.main: [],
            vps_cli.main: ["--datapath", str(tmp_path), "--scene", "S"],
            initial_segmentation.main: ["--datapath", str(tmp_path)]}[main]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)


def test_benchmark_prints_one_json_line_and_writes_no_file(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(benchmark_vps, "PASSES", 1)
    benchmark_vps.main(["--device", "cpu", "--tiny", "--height", "60",
                        "--width", "90", "--frames", "1", "--skip-f32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "vps_frames_per_sec" and rec["value"] > 0
    assert rec["vs_baseline"] is None and rec["device"] == "cpu"
    for k in ("fusion_fps", "fusion_depth_fps", "fusion_file_fps"):
        assert rec[k] > 0
    assert rec["f32_fps"] is None and rec["f32_fusion_fps"] is None
    assert "@60x90 bf16" in rec["unit"]
    assert os.listdir(tmp_path) == []
