"""The comparison that decides ``correct``, driven through the cells'
runners at a tiny size on the CPU (the look for a card skipped): a
clean run passes its cell's limits; the control (the reference one
precision step down in the program's place) and each fault planted in
the timed path underneath fail them."""

import argparse
import contextlib
import time

import pytest
import torch

from pvo_bench import harness
from pvo_bench.kinds import terminate, track

torch.set_num_threads(2)


def _config():
    cfg = harness.load_json(harness.HERE / "configs" / "pvo_vo_240x808.json")
    cfg["image_size"], cfg["buffer"] = [64, 128], 64
    return cfg


def _run(runner, cell, traffic, fault=contextlib.nullcontext, control=False,
         seed=2**31 + 9, seconds=0.5):
    limits = harness.load_json(harness.HERE / "limits" / f"{cell}.json")
    a = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
    run = harness.Run(a, time.perf_counter(), {"chips": 1}, _config(),
                      traffic, limits)
    run.data["device"] = "cpu"
    if control:
        run.control = {}
    with fault():
        runner.run(run)
    return run


def _track(**kw):
    traffic = dict(harness.load_json(harness.HERE / "traffic" / "live.json"),
                   warm_frames=20, check_frames=2, check_span=3)
    return _run(track, "track_240x808", traffic, **kw)


def _terminate(**kw):
    traffic = dict(harness.load_json(harness.HERE / "traffic" /
                                     "clip_end.json"),
                   clip_frames=24, buffer=64, backend_steps=[2, 3])
    return _run(terminate, "terminate_100kf_240x808", traffic, **kw)


@contextlib.contextmanager
def _patched(module, name, wrap):
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _unchanged():
    """An update step that returns the edges' state unchanged."""
    from pvo_tpu_torch.vo import factor_graph

    def wrap(orig):
        def core(graph, net, target, raw, dy, *a, **kw):
            out = orig(graph, net, target, raw, dy, *a, **kw)
            return (net, target, out[2], raw, dy) + tuple(out[5:])
        return core
    return _patched(factor_graph, "update_core", wrap)


def _half():
    """Half of the edges left out of the update, the mean over the rest."""
    from pvo_tpu_torch.vo import factor_graph

    def wrap(orig):
        def core(graph, net, target, raw, dy, *a, **kw):
            a = list(a)
            valid = kw["valid"] if "valid" in kw else a[2]
            keep = torch.arange(valid.shape[0], device=valid.device) < \
                valid.shape[0] // 2
            if "valid" in kw:
                kw["valid"] = valid & keep
            else:
                a[2] = valid & keep
            return orig(graph, net, target, raw, dy, *a, **kw)
        return core
    return _patched(factor_graph, "update_core", wrap)


def _altered():
    """The DBA's poses altered where they are produced."""
    from pvo_tpu_torch.vo import dba

    def wrap(orig):
        def call(*a, **kw):
            poses, disps = orig(*a, **kw)
            poses = poses.clone()
            poses[..., :3] += 1e-2
            return poses, disps
        return call
    return _patched(dba, "dba", wrap)


FAULTS = {"unchanged": _unchanged, "half_batch": _half, "altered": _altered}
CELLS = {"track": _track, "terminate": _terminate}


def test_clip_restarts_as_it_began():
    """Where the stream would fill the buffer, the clip restarts from the
    state after the warm-up: its frames replay as the first pass decided
    them, and the run stays correct."""
    traffic = dict(harness.load_json(harness.HERE / "traffic" / "live.json"),
                   warm_frames=20, check_frames=2, check_span=3,
                   clip_margin=36)
    run = _run(track, "track_240x808", traffic, seconds=14.0)
    pos = run.data["clip_positions"]
    assert pos[0] == 23 and min(pos) == 23 and max(pos) == 27
    assert pos.count(23) >= 2, pos
    assert run.data["replays_differ"] == 0
    assert run.correct(), run.checks()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_clean_run_is_correct(cell):
    run = CELLS[cell]()
    assert run.correct(), run.checks()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails(cell):
    run = CELLS[cell](control=True)
    assert run.correct(), run.checks()
    assert not run.correct(run.control), run.checks(run.control)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_fails(cell, fault):
    run = CELLS[cell](fault=FAULTS[fault])
    assert not run.correct(), run.checks()
