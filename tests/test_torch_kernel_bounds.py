"""The port's kernel bounds, its independence of the JAX package, and its
own configuration.

``kbench.kernel_bound`` is the one place that counts the bytes and the
operations of each CUDA kernel; ``chip_smoke.py`` and the table in
``PERF.md`` take their bounds from it. The counts here are worked out by
hand from the shapes of the main path (30x101 features, C=128, 4 levels).
"""

import ast
import dataclasses
from pathlib import Path

import pytest

from pvo_tpu.utils.config import VOConfig as JaxVOConfig
from pvo_tpu_torch.scripts import dba_probe, kbench
from pvo_tpu_torch.utils.config import VOConfig

ROOT = Path(__file__).resolve().parents[1]
PX = 30 * 101


def test_lookup_bound_backend_chunk():
    """K3 at E=256: f1 and f2 bf16, coords, f32 out; 64 taps x 4 levels
    of length-128 products per pixel."""
    b = kbench.kernel_bound("corr_lookup", 256, 30, 101)
    feats = 256 * PX * 128 * 2
    assert b["bytes_in"] == 2 * feats + 256 * PX * 8
    assert b["bytes_out"] == 256 * PX * 196 * 4
    assert round(b["bytes"] / 1e9, 2) == 1.01
    assert b["flops"] == 256 * PX * 4 * 64 * 128 * 2
    assert round(b["flops"] / 1e9, 1) == 50.8
    assert b["bound_by"] == "bytes"
    assert b["ms"] == pytest.approx(1e3 * b["bytes"] / 3.35e12)
    assert round(b["ms"], 2) == 0.30
    assert round(b["ops_ms"], 2) == 0.05


def test_lookup_bound_f32_features_is_operations():
    b = kbench.kernel_bound("corr_lookup", 256, 30, 101, features="f32")
    assert b["bound_by"] == "operations"
    assert round(b["ms"], 2) == 0.76


def test_f32_kernel_bounds_at_the_export_shapes():
    """The f32 kernels' callers: K1 at E=2, 30x101 (two (3030 x 128) x
    (128 x 3991) products, 6.19 GFLOP at the f32 SIMT peak against a 49
    MB store) and K3 at E=2, 47x156 (0.96 GFLOP of tap products, 26.6 MB
    moved); the probe at E=1, 30x101."""
    b = kbench.kernel_bound("build_volumes", 2, 30, 101, features="f32")
    assert b["flops"] == 2 * PX * 3991 * 128 * 2
    assert round(b["flops"] / 1e9, 2) == 6.19
    assert b["bytes_out"] == 2 * PX * 4032 * 2
    assert b["bound_by"] == "operations"
    assert round(b["ms"], 4) == 0.0924
    assert round(b["bytes_ms"], 4) == 0.0164   # 6 MB in, 49 MB out
    b = kbench.kernel_bound("corr_lookup", 2, 47, 156, features="f32")
    px = 2 * 47 * 156
    assert b["flops"] == px * 4 * 64 * 128 * 2
    assert round(b["flops"] / 1e9, 2) == 0.96
    assert b["bytes"] == 2 * px * 128 * 4 + px * 8 + px * 196 * 4
    assert round(b["bytes"] / 1e6, 1) == 26.6
    assert b["bound_by"] == "operations"
    assert round(b["ms"], 4) == 0.0143
    b = kbench.kernel_bound("corr_lookup", 1, 30, 101, features="f32")
    assert b["bound_by"] == "operations" and round(b["ms"], 4) == 0.0030


def test_extract_bound():
    """K2 at E=48: 4 x 64 bf16 taps and the coords in, 196 f32 out."""
    b = kbench.kernel_bound("corr_extract", 48, 30, 101)
    assert b["bytes_out"] == 48 * PX * 196 * 4
    assert b["bytes_in"] == 48 * PX * (4 * 64 * 2 + 8)
    assert round(b["bytes"] / 1e6) == 190
    assert b["bound_by"] == "bytes"
    assert round(b["ms"], 3) == 0.057


def test_build_bound():
    """K1 at E=48: a (3030 x 128) x (128 x 3991) product per edge, the
    bf16 volume stored with its row stride padded to 4032."""
    b = kbench.kernel_bound("build_volumes", 48, 30, 101)
    assert b["bytes_out"] == 48 * PX * 4032 * 2
    assert round(b["bytes_out"] / 1e9, 2) == 1.17
    assert b["flops"] == 48 * PX * 3991 * 128 * 2
    assert round(b["flops"] / 1e9) == 149
    assert b["bound_by"] == "bytes"


@pytest.mark.parametrize("name, E", [("corr_lookup_packed", 64),
                                     ("corr_extract_packed", 32)])
def test_packed_bounds(name, E):
    """P1 and P2 write the packed (E, H, W, 256) bf16 layout."""
    b = kbench.kernel_bound(name, E, 30, 101)
    assert b["bytes_out"] == E * PX * 256 * 2
    assert b["bound_by"] == "bytes"
    twin = "corr_lookup" if "lookup" in name else "corr_extract"
    assert b["bytes_in"] == kbench.kernel_bound(twin, E, 30, 101)["bytes_in"]


@pytest.mark.parametrize("shape", sorted(dba_probe.SHAPES))
def test_solve_bound_at_the_probe_shapes(shape):
    """``dba_solve``'s bound at each probe shape's P (motion-only where the
    shape is): positive and finite; M^3/3 + 3 M^2 operations (the
    symmetrization's M (M - 1) with the solves' 2 M^2 + M) and H and, on
    a full iteration, S_sum whole (M^2 values each: the symmetrized
    system reads both triangles), v, corr_v and dx, f32."""
    motion_only = dba_probe.SHAPES[shape][-1]
    # P = K but at the backend's recorded calls
    P = (dba_probe.GRAPHS[shape]["P"] if shape in dba_probe.GRAPHS else
         dba_probe.SHAPES[shape][1])
    b = kbench.dba_bound("dba_solve", P=P, motion_only=motion_only)
    M, terms = 6 * P, 1 if motion_only else 2
    assert b["flops"] == M ** 3 // 3 + 3 * M * M
    assert b["bytes"] == 4 * (terms * (M * M + M) + M)
    assert 0 < b["ms"] < float("inf")
    assert b["bound_by"] in ("bytes", "operations")


def test_bound_scales_and_rejects_unknown():
    one = kbench.kernel_bound("corr_lookup", 1, 30, 101)
    many = kbench.kernel_bound("corr_lookup", 48, 30, 101)
    assert many["bytes"] == 48 * one["bytes"]
    assert many["flops"] == 48 * one["flops"]
    with pytest.raises(ValueError):
        kbench.kernel_bound("no_such_kernel", 1, 30, 101)


def port_sources():
    return sorted((ROOT / "pvo_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = port_sources()
    assert len(sources) > 30
    banned = {"jax", "jaxlib", "flax", "optax", "pvo_tpu"}
    bad = [(str(p.relative_to(ROOT)), m) for p in sources
           for m in imported_modules(p) if m.split(".")[0] in banned]
    assert not bad, bad


EXPORT_SLICE = ("geom/upsample.py", "utils/io.py", "utils/ate.py",
                "utils/device.py", "scripts/test_vo2.py", "scripts/test_vo.py",
                "scripts/bench_vo2_export.py")


def test_import_walk_covers_the_export_slice():
    """The walk above reads the export slice's files, and none of them,
    nor chip_smoke.py, imports cv2 or PIL at module level: only the CLIs'
    file reading and the final resize import them, inside functions (the
    card's machine is not known to have either)."""
    sources = port_sources()
    for rel in EXPORT_SLICE:
        assert ROOT / "pvo_tpu_torch" / rel in sources, rel
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import)
                 for a in n.names] + \
            [n.module or "" for n in top if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m.split(".")[0] in ("cv2", "PIL")], \
            path


VPS_SLICE = ("vps/categories.py", "vps/ops.py", "vps/resnet.py",
             "vps/fpn.py", "vps/semseg.py", "vps/rpn.py", "vps/roi_heads.py",
             "vps/panoptic_fpn.py", "utils/convert_vps.py",
             "pipeline/tracking.py", "pipeline/matching.py", "pipeline/pq.py",
             "pipeline/evaluator.py", "native.py",
             "scripts/initial_segmentation.py", "scripts/test_vps.py",
             "scripts/benchmark_vps.py")


@pytest.mark.parametrize("rel", VPS_SLICE)
def test_import_walk_covers_the_vps_slice(rel):
    """The walk above reads each of the VPS slice's files; their
    imports of the port's own modules resolve to files of the port."""
    path = ROOT / "pvo_tpu_torch" / rel
    assert path in port_sources()
    for m in imported_modules(path):
        if m.startswith("pvo_tpu_torch."):
            parts = m.split(".")[1:]
            base = ROOT / "pvo_tpu_torch" / "/".join(parts)
            assert base.with_suffix(".py").exists() or \
                (base / "__init__.py").exists(), (rel, m)


LOOP_SLICE = ("utils/tracing.py", "data/synth_scene.py",
              "pipeline/preparing.py", "lie/sim3.py", "geom/depth_filter.py",
              "scripts/bench_track.py", "scripts/bench_terminate.py",
              "scripts/prepare_vkitti.py", "scripts/run_pvo_loop.py",
              "scripts/loop_weights.py")


@pytest.mark.parametrize("rel", LOOP_SLICE)
def test_import_walk_covers_the_loop_slice(rel):
    """The walks above read each of the loop slice's files (no JAX, no
    module-level cv2 or PIL); their imports of the port's own modules
    resolve to files of the port."""
    test_import_walk_covers_the_vps_slice(rel)


TRAIN_SLICE = ("vo/losses.py", "data/graph_utils.py", "data/augmentation.py",
               "data/vkitti2.py", "data/tartan.py",
               "parallel/data_parallel.py", "utils/checkpoint.py",
               "utils/logger.py", "scripts/train_vo.py",
               "scripts/bench_train_vo.py")


@pytest.mark.parametrize("rel", TRAIN_SLICE)
def test_import_walk_covers_the_train_slice(rel):
    """The walks above read each of the VO training slice's files (no
    JAX, no module-level cv2 or PIL); their imports of the port's own
    modules resolve to files of the port."""
    test_import_walk_covers_the_vps_slice(rel)


VPS_TRAIN_SLICE = ("vps/config.py", "vps/datasets.py", "vps/losses.py",
                   "vps/train.py", "scripts/train_vps.py",
                   "scripts/bench_train_vps.py", "scripts/bench_vps_train.py")


@pytest.mark.parametrize("rel", VPS_TRAIN_SLICE)
def test_import_walk_covers_the_vps_train_slice(rel):
    """The walks above read each of the VPS training slice's files (no
    JAX, no module-level cv2 or PIL); their imports of the port's own
    modules resolve to files of the port."""
    test_import_walk_covers_the_vps_slice(rel)


DEMO_SLICE = ("utils/flow_vis.py", "data/streams.py", "vo/video.py",
              "vo/visualization.py", "vo/live_viewer.py", "native.py",
              "scripts/demo.py", "scripts/export_reconstruction.py",
              "scripts/visualize_results.py")
DP_SLICE = ("parallel/data_parallel.py", "parallel/multihost.py",
            "vps/train.py", "scripts/train_vo.py", "scripts/train_vps.py",
            "scripts/bench_train_vo.py")


@pytest.mark.parametrize("rel", DEMO_SLICE + DP_SLICE)
def test_import_walk_covers_the_demo_and_dp_slices(rel):
    """The walks above read each file of the image-directory demo's and
    the data-parallel trainers' slices (no JAX, no module-level cv2 or
    PIL); their imports of the port's own modules resolve to files of
    the port."""
    test_import_walk_covers_the_vps_slice(rel)


def test_port_config_equals_the_jax_package_config():
    ours = [(f.name, f.type, f.default) for f in dataclasses.fields(VOConfig)]
    theirs = [(f.name, f.type, f.default)
              for f in dataclasses.fields(JaxVOConfig)]
    assert ours == theirs
    assert VOConfig().feat_hw == JaxVOConfig().feat_hw == (30, 101)
    assert VOConfig.__module__ == "pvo_tpu_torch.utils.config"


@pytest.mark.parametrize("kind", kbench.LOOKUP_COORDS)
def test_lookup_coords_are_seeded_and_shaped(kind):
    import numpy as np
    a = kbench.lookup_coords(kind, 2, 30, 101, seed=4)
    b = kbench.lookup_coords(kind, 2, 30, 101, seed=4)
    assert a.shape == (2, 30, 101, 2) and a.dtype == np.float32
    assert np.array_equal(a, b, equal_nan=True)
    assert np.isfinite(a).all() == (kind != "wild")


def test_corr_probe_substitutions_name_lines_of_the_source():
    """The variant and ablation probe rewrites corr.cu and corr_exp.cu
    (with the headers they include written out) by exact lines: each
    must occur there once, or the probe has gone stale."""
    from pvo_tpu_torch.scripts import corr_probe
    tables = {
        corr_probe.cuda_corr: (
            corr_probe.K3_VARIANTS, corr_probe.K2_VARIANTS,
            corr_probe.ABLATIONS, corr_probe.K3F_VARIANTS,
            corr_probe.K1F_VARIANTS, corr_probe.K3F_ABLATIONS,
            corr_probe.K1F_ABLATIONS),
        corr_probe.cuda_corr_exp: (
            corr_probe.P1_VARIANTS, corr_probe.P2_VARIANTS,
            corr_probe.P2_ABLATIONS)}
    for module, group in tables.items():
        source = corr_probe.expanded(module.SOURCE)
        assert '#include "' not in source and "#pragma once" not in source
        for table in group:
            assert any(tag.startswith(("as committed", "whole kernel"))
                       for tag in table)
            for tag, subs in table.items():
                for old, new in subs:
                    assert source.count(old) == 1, (tag, old)
                    assert new != old


def test_corr_probe_expands_each_header_once():
    """K3's body lives in a header that corr.cu and corr_exp.cu both
    include: the probe's text of either holds it, and the common header
    under it, exactly once."""
    from pvo_tpu_torch.scripts import corr_probe
    for module in (corr_probe.cuda_corr, corr_probe.cuda_corr_exp):
        source = corr_probe.expanded(module.SOURCE)
        assert source.count("void lookup_tc_body(") == 1
        assert source.count("struct Levels {") == 1
        assert source.count("void patch_row(") == 1
    # the body exists once in the sources
    csrc = corr_probe.cuda_corr.SOURCE.parent
    texts = [f.read_text() for f in sorted(csrc.glob("corr*.cu*"))
             if "parent" not in f.name and "probe" not in f.name]
    assert sum(t.count("wgmma_m64n64k16(d, da") for t in texts) == 1


@pytest.mark.parametrize("table", ["K3F_ABLATIONS", "K1F_ABLATIONS"])
def test_corr_probe_f32_ablations_rewrite_only_the_f32_kernels(table):
    """Every ablation of an f32 kernel leaves the bf16 kernels' and K2's
    text alone, and the all-off line is the sum of the single ones."""
    from pvo_tpu_torch.scripts import corr_probe
    source = corr_probe.expanded(corr_probe.cuda_corr.SOURCE)
    cut = {"K1, bf16": "// ---------------------------------------------------------------- K1, bf16",
           "K2": "// ---------------------------------------------------------------- K2",
           "K3, bf16": "// ---------------------------------------------------------------- K3, bf16"}
    f32_start = source.index("f32 operands, 3 x TF32")
    k2 = source.index(cut["K2"])
    k3f = source.index("K3, f32")
    k3t = source.index(cut["K3, bf16"])
    ablations = getattr(corr_probe, table)
    single = set()
    for tag, subs in ablations.items():
        for old, _ in subs:
            at = source.index(old)
            assert f32_start <= at < k2 or k3f <= at < k3t, (tag, old)
            if not tag.startswith("none of them"):
                single.add(old)
    last = list(ablations)[-1]
    assert last.startswith("none of them")
    assert {old for old, _ in ablations[last]} <= single
