"""``scripts/trace_track.py`` and ``scripts/profile_track.py`` on the CPU
at 64x96: the planner frame's FLOP count and the per-stage profile.

The frame's count leaves the hand-written kernels' plain versions out of
``FlopCounterMode``'s total and adds each kernel call's FLOPs by
``kbench``'s formulas; its corr part is held here against a count made
by hand from the shapes and the sections the frame ran (the card's
route at 8x12 features: K1's volumes once an update call, K2 a step, the
probe's K3 once a frame). MFU is not computed on the CPU.
"""

import json

import pytest

from pvo_tpu_torch.scripts import kbench, profile_track, trace_track
from pvo_tpu_torch.vo import planner

from torch_one_thread import one_thread  # noqa: F401

H, W = 64, 96
h, w = H // 8, W // 8
C = 128
LEVELS = [(h >> k) * (w >> k) for k in range(4)]    # 96, 24, 6, 1


@pytest.fixture(scope="module")
def traced():
    """trace_track's main at 64x96: 14 warm frames (the planner engages
    at 13), one traced, one counted."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = trace_track.main(["1", "--warm", "14", "--image_size",
                                str(H), str(W), "--device", "cpu"])
    return out, buf.getvalue()


def test_trace_track_json(traced):
    out, text = traced
    assert json.loads(text.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))
    assert out["engaged_at"] == 13 and out["device"] == "cpu"
    for key in ("device_ms_per_frame", "tflop_per_s", "mfu",
                "launches_counted", "launches_traced"):
        assert out[key] is None
    assert ["update"] in out["sections"]


def test_frame_flops_corr_part_by_hand(traced):
    out, _ = traced
    sections = [tuple(s) for s in out["sections"]]
    E = planner.PlannerDriver.EBMAX if ("update", "full") in sections \
        else planner.EB_S
    regime = "full" if ("update", "full") in sections else "compact"
    steps = 4 + 2 * (("update", regime, "steps2") in sections)
    px = E * h * w
    k1 = px * sum(LEVELS) * C * 2                   # one volume build
    k2 = px * 4 * 49 * 7                            # blend a step
    k3 = h * w * 4 * 64 * C * 2                     # the probe, one edge
    kf = out["kernel_flops"]
    assert kf["build_volumes"] == {"calls": 1, "gflop": k1 / 1e9}
    assert kf["corr_extract"] == {"calls": steps, "gflop": steps * k2 / 1e9}
    assert kf["corr_lookup"] == {"calls": 1, "gflop": k3 / 1e9}
    assert kf["segsum"]["calls"] > 0
    total = out["frame_gflop_torch"] + sum(v["gflop"] for v in kf.values())
    assert out["frame_gflop"] == pytest.approx(total, rel=1e-12)
    # the plain versions' own products were counted and left out
    assert out["plain_gflop_left_out"] > 0


def test_frame_flops_count_the_solves(traced):
    """Each DBA iteration of the frame counts one damped solve at the
    planner's P=32 by ``kbench.dba_bound``'s formula (FlopCounterMode
    sees nothing of the plain version's cholesky_ex and triangular
    solves): 12 a frame with the full regime's 6 updates of 2
    iterations, one a backsub in any case."""
    out, _ = traced
    kf = out["kernel_flops"]
    n = kf["dba_backsub"]["calls"]
    assert kf["dba_solve"]["calls"] == n > 0
    assert "dba_solve_grid" not in kf
    per = kbench.dba_bound("dba_solve", P=32)["flops"]  # PlannerProgram.P
    assert kf["dba_solve"]["gflop"] == pytest.approx(n * per / 1e9,
                                                     rel=1e-12)
    if ("update", "full") in [tuple(p) for p in out["sections"]]:
        assert n == 12


def test_forced_sections_count_the_same(traced):
    """A frame run with the sections given (as the card's) counts what
    the same sections count when the predicates choose them."""
    out, _ = traced
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        again = trace_track.run((H, W), 14, 1, "cpu",
                                sections=out["sections"])
    assert again["sections"] == out["sections"]
    assert again["frame_gflop"] == out["frame_gflop"]
    assert again["kernel_flops"] == out["kernel_flops"]


def test_profile_track(capsys):
    profile_track.main(["--frames", "14", "2", "--image_size", str(H),
                        str(W), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["path"] == "planner" and out["engaged_at"] == 13
    assert out["stages"]["frame_total"]["calls"] == 2
    assert out["stages"]["planner.eager"]["calls"] == 2
    assert set(out["stages"]["planner.eager"]) == {"mean_ms", "total_ms",
                                                   "calls"}
