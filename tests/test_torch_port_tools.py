"""The port's developer CLIs on the CPU: ``kbench``'s op-trace half, the
shell twins of ``tools/*.sh``, and the micro-bench and profile twins at
tiny sizes (``--device cpu``): each exits through ``main(argv)`` with a
JSON last line holding its documented keys. The parts that time by CUDA
events or trace the card raise ``RuntimeError`` without one.
"""

import json
import os
import stat
import subprocess
import types
from pathlib import Path

import pytest
import torch

from pvo_tpu_torch.scripts import (bench_corr, bench_dba, bench_filler,
                                   bench_step_parts, initial_segmentation,
                                   kbench, profile_terminate, profile_vo,
                                   test_vo, test_vo2, test_vps, trace_vo2)

from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "pvo_tpu_torch" / "tools"
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _row(key, us, count, device_type=CUDA):
    return types.SimpleNamespace(key=key, self_device_time_total=us,
                                 count=count, device_type=device_type)


class _Prof:
    def __init__(self, rows):
        self.rows = rows

    def key_averages(self):
        return self.rows


def test_device_op_totals_and_top(capsys):
    """Kernel rows summed by name; host rows and the port's range rows
    left out; the top rows costliest first, ties by name."""
    prof = _Prof([_row("gemm", 300.0, 2), _row("gemm", 100.0, 1),
                  _row("segsum_kernel", 50.0, 4),
                  _row("vo.backend.dba", 9e3, 1),
                  _row("aten::conv2d", 7e3, 3, CPU), _row("axpy", 400.0, 8),
                  _row("copy", 50.0, 1)])
    totals = kbench.device_op_totals(prof)
    assert totals == {"gemm": (400.0, 3), "segsum_kernel": (50.0, 4),
                      "axpy": (400.0, 8), "copy": (50.0, 1)}
    assert kbench.total_ms(totals) == pytest.approx(0.9)
    rows = kbench.print_top(totals, 3)
    assert rows == [("axpy", 400.0, 8), ("gemm", 400.0, 3),
                    ("copy", 50.0, 1)]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[0].split()[:3] == ["0.400", "ms", "8x"]


def test_peak_flops_knows_only_its_card():
    assert kbench.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    for card in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "TPU v5 lite"):
        with pytest.raises(KeyError, match="no published peak"):
            kbench.peak_flops(card)


def test_card_timings_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kbench.trace_totals(lambda: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_corr.main(["4", "8", "12"])
    with pytest.raises(RuntimeError, match="needs the card"):
        bench_corr.main(["4", "8", "12", "--device", "cpu"])


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


DEVICE_FIELDS = ("host_ms", "device_ms", "launches", "events_ms", "top")


def _cpu_breakdown(res):
    assert set(res) == set(DEVICE_FIELDS)
    assert res["host_ms"] > 0
    assert all(res[k] is None for k in DEVICE_FIELDS[1:])


def test_bench_dba(capsys):
    bench_dba.main(["8", "32", "32", "2", "--device", "cpu"])
    out = _last_json(capsys)
    assert (out["E"], out["P"], out["K"], out["iters"]) == (8, 32, 32, 2)
    _cpu_breakdown({k: out[k] for k in DEVICE_FIELDS})
    assert out["device"] == "cpu"


def test_bench_dba_lists_the_dba_launches(capsys):
    """One call's launches of each DBA kernel and of the solve's grid
    kernel: none on the CPU, which runs their plain versions."""
    from pvo_tpu_torch.vo.net import cuda_dba
    bench_dba.main(["8", "32", "32", "2", "--device", "cpu"])
    out = _last_json(capsys)
    assert out["dba_launches"] == dict.fromkeys(cuda_dba.LAUNCHES, 0)
    assert "dba_solve" in out["dba_launches"]
    assert "dba_solve_grid" in out["dba_launches"]


def test_bench_step_parts(capsys):
    bench_step_parts.main(["--edges", "4", "--feat_hw", "8", "12",
                           "--device", "cpu"])
    out = _last_json(capsys)
    assert list(out["parts"]) == ["update_apply", "segment_vote",
                                  "proj_transform", "graph_agg"]
    for res in out["parts"].values():
        _cpu_breakdown(res)


def test_profile_vo(capsys):
    profile_vo.main(["--edges", "4", "--feat_hw", "8", "12", "--device",
                     "cpu"])
    out = _last_json(capsys)
    assert list(out["pieces"]) == ["chunked_corr_lookup", "k3_corr_lookup",
                                   "update_operator", "dba"]
    for res in out["pieces"].values():
        _cpu_breakdown(res)


def test_trace_vo2(capsys):
    trace_vo2.main(["2", "--image_size", "64", "96", "--device", "cpu"])
    out = _last_json(capsys)
    assert out["iters"] == 2 and out["image_size"] == [64, 96]
    assert out["device_ms_per_iter"] is None
    _cpu_breakdown({k: out[k] for k in DEVICE_FIELDS})


def test_bench_filler(capsys):
    bench_filler.main(["3", "1", "--image_size", "64", "96", "--device",
                       "cpu"])
    out = _last_json(capsys)
    assert out["n_kf"] == 3 and out["poses"] == 3
    assert len(out["seconds"]) == 1 and out["warm_min_s"] > 0
    assert "profiled" not in out  # the profiled rep traces the card only


def test_profile_terminate(capsys):
    """14 keyframes at 64x96: the planner engaged at 13, then every
    stage of terminate."""
    profile_terminate.main(["14", "--image_size", "64", "96", "--device",
                            "cpu"])
    out = _last_json(capsys)
    assert set(out) == {"total_s", "n_kf", "keyframes", "stages", "device"}
    stages = list(out["stages"])
    assert stages[:4] == ["disengage", "resolve_track",
                          "frontend_last_update", "frontend_flush"]
    assert stages[-1] == "traj_filler"
    assert sum(s.startswith("backend7.lowmem_step") for s in stages) == 7
    assert sum(s.startswith("backend12.lowmem_step") for s in stages) == 12
    assert any(s.startswith("backend7.proximity (E=") for s in stages)
    assert out["total_s"] == pytest.approx(sum(out["stages"].values()))


def _twin_calls(script, tmp_path, args):
    """The argument lists ``script`` passes to ``python``: run with a
    ``python`` on PATH that records them and does nothing else."""
    fake = tmp_path / "bin"
    fake.mkdir(exist_ok=True)
    log = tmp_path / "calls.jsonl"
    py = fake / "python"
    py.write_text("#!/bin/sh\n"
                  f"exec {os.environ.get('PYTHON', 'python3')} -c "
                  "'import json, sys; print(json.dumps(sys.argv[1:]))' "
                  f"\"$@\" >> {log}\n")
    py.chmod(py.stat().st_mode | stat.S_IXUSR)
    if log.exists():
        log.unlink()
    env = dict(os.environ, PATH=f"{fake}:{os.environ['PATH']}")
    subprocess.run(["bash", str(script), *args], env=env, check=True)
    return [json.loads(line) for line in log.read_text().splitlines()]


PARSERS = {"initial_segmentation": initial_segmentation.parse_args,
           "test_vo": test_vo.parse_args, "test_vo2": test_vo2.parse_args,
           "test_vps": test_vps.parse_args}


@pytest.mark.parametrize("name, calls", [("initial_segmentation", 1),
                                         ("test_vo_scene", 10),
                                         ("test_vps", 5)])
def test_shell_twins_parse(name, calls, tmp_path):
    """Each twin calls the port's CLIs as modules with the arguments the
    JAX package's script passes its CLIs, and the device passed through;
    each call parses."""
    for args, device in (([], "cuda"), (["data", "w.pth", "cpu"], "cpu")):
        seen = _twin_calls(TOOLS / f"{name}.sh", tmp_path, args)
        jax_seen = _twin_calls(ROOT / "tools" / f"{name}.sh", tmp_path,
                               args[:2])
        assert len(seen) == len(jax_seen) == calls
        for argv, jax_argv in zip(seen, jax_seen):
            assert jax_argv[0] == f"scripts/{argv[1].rsplit('.', 1)[1]}.py"
            assert argv[2:] == jax_argv[1:] + ["--device", device]
            assert argv[0] == "-m"
            module = argv[1]
            assert module.startswith("pvo_tpu_torch.scripts.")
            ns = PARSERS[module.rsplit(".", 1)[1]](argv[2:])
            assert ns.device == device
            assert ns.weights == ("w.pth" if args else None)
            assert ns.datapath.startswith(args[0] if args else
                                          "datasets/Virtual_KITTI2")
