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
from pvo_tpu_torch.scripts import kbench
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
    """The variant and ablation probe rewrites corr.cu by exact lines:
    each must occur there once, or the probe has gone stale."""
    from pvo_tpu_torch.scripts import corr_probe
    source = corr_probe.cuda_corr.SOURCE.read_text()
    for table in (corr_probe.K3_VARIANTS, corr_probe.K2_VARIANTS,
                  corr_probe.ABLATIONS):
        for tag, subs in table.items():
            for old, new in subs:
                assert source.count(old) == 1, (tag, old)
                assert new != old
