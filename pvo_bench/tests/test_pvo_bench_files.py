"""A cell, a configuration, a traffic mix, a limits file and a metric
added as files are found by their names, with no edit to the harness;
and BENCHMARK.json keeps to the shape the harness reads."""

import json
import shutil
from pathlib import Path

import pytest

from pvo_bench import harness

REPO = Path(__file__).resolve().parents[2]


def test_every_cell_finds_its_files():
    bench = harness.load_json(REPO / "BENCHMARK.json")
    for cell in bench["workloads"]:
        _, config, traffic, limits, e2e, layer = harness.cell_files(
            bench, cell["name"])
        assert config["name"] == cell["config"]
        assert limits["numbers"]
        harness.load_module("kinds", traffic["kind"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer
        for m in e2e + layer:
            assert hasattr(harness.load_module("metrics", m["name"]), "read")


def test_added_files_are_found(tmp_path, monkeypatch):
    root = tmp_path / "pvo_bench"
    shutil.copytree(REPO / "pvo_bench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.load_json(REPO / "BENCHMARK.json")
    (root / "configs" / "new_cfg.json").write_text(json.dumps(
        {"name": "new_cfg", "image_size": [64, 128]}))
    (root / "traffic" / "new_mix.json").write_text(json.dumps(
        {"kind": "new_kind"}))
    (root / "kinds" / "new_kind.py").write_text(
        "def run(run):\n    run.setup_s = 1.0\n")
    (root / "limits" / "new_cell.json").write_text(json.dumps(
        {"numbers": {"gap": {"limit": 1.0}}}))
    (root / "metrics" / "new_metric.x.py").write_text(
        "def read(run):\n    return 2.0\n")
    bench["configs"].append({"name": "new_cfg", "source": "x",
                             "file": "pvo_bench/configs/new_cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new_cell", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "l", "moves": "setup_s",
                               "workloads": ["new_cell"]})
    monkeypatch.setattr(harness, "HERE", root)
    monkeypatch.setattr(harness, "REPO", tmp_path)
    cell, config, traffic, limits, e2e, layer = harness.cell_files(
        bench, "new_cell")
    assert config["image_size"] == [64, 128]
    assert harness.load_module("kinds", traffic["kind"]).run
    assert [m["name"] for m in layer] == ["new_metric.x"]
    assert harness.load_module("metrics", "new_metric.x").read(None) == 2.0
    assert "setup_s" in {m["name"] for m in e2e}
    assert "track_fps" not in {m["name"] for m in e2e}


def test_unknown_cell_is_refused():
    bench = harness.load_json(REPO / "BENCHMARK.json")
    with pytest.raises(harness.Refused):
        harness.cell_files(bench, "no_such_cell")


def test_benchmark_json_shape():
    bench = harness.load_json(REPO / "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in bench["workloads"]}
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
