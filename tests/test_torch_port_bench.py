"""The port's bench twins, ``scripts/bench_track.py`` (of ``bench.py``)
and ``scripts/bench_terminate.py`` (of ``scripts/bench_terminate.py``),
at a tiny size on the CPU: one JSON line each with its metric and a null
``vs_baseline``, and no file written. Without ``--device cpu`` each
raises where there is no card. The stream is ``bench.py``'s, and
``chip_smoke.py`` reads the one copy of it and of ``tame_net``. The
timers they use (``utils/tracing.py``) on the CPU.
"""

import ast
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import chip_smoke
from pvo_tpu_torch.scripts import bench_terminate, bench_track, loop_weights
from pvo_tpu_torch.utils.tracing import (EventStorage, StepTimer,
                                         profile_trace, range_device_ms)
from torch_one_thread import one_thread  # noqa: F401


REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def bench_py_synth_stream():
    """``bench.py``'s ``synth_stream``, read from its source: importing
    bench.py would repoint JAX's compilation cache."""
    path = osp.join(REPO, "bench.py")
    tree = ast.parse(open(path).read(), filename=path)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "synth_stream")
    ns = {"np": np}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    return ns["synth_stream"]


@pytest.mark.parametrize("size", [(240, 808), (64, 96)])
def test_stream_is_bench_pys(size):
    ours = list(bench_track.synth_stream(3, *size))
    theirs = list(bench_py_synth_stream()(3, *size))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_chip_smoke_reads_the_one_copy():
    assert chip_smoke.synth_stream is bench_track.synth_stream
    assert chip_smoke.tame_net is bench_track.tame_net
    assert "def synth_stream" not in open(chip_smoke.__file__).read()


def one_json_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_bench_track_prints_one_json_line_and_writes_no_file(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    bench_track.main(["--device", "cpu", "--image_size", "64", "96",
                      "--frames", "4", "2"])
    rec = one_json_line(capsys)
    assert rec["metric"] == "vo_track_frames_per_sec"
    assert rec["vs_baseline"] is None and rec["mfu_vs_bf16_peak"] is None
    # every frame admitted; the last one's admission is read with the
    # next frame
    assert rec["value"] > 0 and rec["keyframes"] == 5
    assert rec["device_ms_per_frame"] is None and rec["device"] == "cpu"
    assert os.listdir(tmp_path) == []


def test_bench_terminate_prints_one_json_line_and_writes_no_file(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    # 8 frames, under the bench's warmup of 12: terminate runs the global
    # BA over the uninitialized keyframes and the filler
    bench_terminate.main(["8", "1", "--image_size", "64", "96",
                          "--device", "cpu"])
    rec = one_json_line(capsys)
    assert rec["metric"] == "vo_terminate_seconds"
    assert rec["vs_baseline"] is None
    assert rec["value"] > 0 and rec["backend_s"] > 0 and rec["filler_s"] > 0
    assert rec["backend_s"] + rec["filler_s"] < rec["value"]
    assert rec["device_ms_by_range"] is None
    assert "8 keyframes" in rec["unit"]
    # the backend's two global-BA calls, the edges of each
    assert len(rec["backend_edges"]) == 2 and min(rec["backend_edges"]) > 0
    # the DBA kernels' launches in terminate: none on the CPU
    assert rec["dba_launches_in_terminate"] == dict.fromkeys(
        ("dba_linearize", "dba_schur", "dba_backsub", "dba_solve",
         "dba_solve_grid"), 0)
    assert os.listdir(tmp_path) == []


def test_terminate_buffer_is_a_power_of_two_past_the_filler_batch():
    assert bench_terminate.buffer_for(100) == 128
    assert bench_terminate.buffer_for(104) == 128
    assert bench_terminate.buffer_for(105) == 256
    assert bench_terminate.buffer_for(14) == 64


@pytest.mark.parametrize("main", [bench_track.main, bench_terminate.main,
                                  loop_weights.main],
                         ids=["bench_track", "bench_terminate",
                              "loop_weights"])
def test_bench_twins_never_pick_the_cpu_by_themselves(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


def test_tracing_on_the_cpu():
    timer = StepTimer()
    for _ in range(2):
        with timer.time("step", sync=torch.zeros(1)):
            pass
    assert timer.counts["step"] == 2 and list(timer.summary()) == ["step"]
    assert timer.report().startswith("step=")
    ev = EventStorage()
    ev.put_scalars(loss=3.0)
    ev.step()
    ev.put_scalar("loss", 1.0)
    assert ev.latest() == {"loss": 1.0} and ev.iter == 1
    assert ev.median("loss") == 2.0
    with profile_trace(enabled=False) as prof:
        assert prof is None
    # a range with no kernel inside (the CPU launches none)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("vo.test.update"):
            torch.ones(4) + 1
        with torch.profiler.record_function("other"):
            torch.ones(4) + 1
    assert range_device_ms(prof, ("vo.",)) == {"vo.test.update": (0.0, 0)}
