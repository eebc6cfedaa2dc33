"""On the card: a short run of every cell comes out correct with its
result line as the harness prints it, and the control of the tracking
cell fails its limits. Skips without a card (decided in the fixture).

    python3 -m pytest pvo_bench/tests -q -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _cells():
    return [c["name"] for c in
            json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "pvo_bench.run", "--workload", cell,
         "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert "setup_s" in res["metrics"]


@pytest.mark.cuda
def test_control_fails_on_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "pvo_bench.control", "--workload",
         "track_240x808", "--seeds", "2147484001", "--seconds", "2",
         "--control"], cwd=REPO, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["control_correct"] is False, res["control"]
