"""The VPS profile and trace CLIs on the CPU (``--tiny``: one block a
backbone stage, 64x96, ``--device cpu``): each exits through
``main(argv)`` with a JSON last line holding its documented keys; the
device fields are null on the CPU."""

import json

from pvo_tpu_torch.scripts import profile_vps, profile_vps_pipeline, trace_vps

from torch_one_thread import one_thread  # noqa: F401

TINY = ["--tiny", "--height", "64", "--width", "96", "--device", "cpu"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_trace_vps(capsys):
    trace_vps.main(TINY)
    out = _last_json(capsys)
    assert out["image_size"] == [64, 96] and out["tiny"]
    for variant in ("plain", "fusion+depth"):
        assert out[variant]["host_ms"] > 0
        assert out[variant]["device_ms"] is None


def test_profile_vps(capsys):
    profile_vps.main(TINY + ["--reps", "1"])
    out = _last_json(capsys)
    assert list(out["programs"]) == ["plain", "fusion", "fusion+depth"]
    assert list(out["copies"]) == ["image uint8", "flow f16", "flow f32",
                                   "depth f32"]
    assert all(v > 0 for k in ("programs", "copies")
               for v in out[k].values())


def test_profile_vps_pipeline(capsys):
    profile_vps_pipeline.main(TINY + ["--frames", "3"])
    out = _last_json(capsys)
    assert list(out["modes"]) == ["plain", "fusion", "fusion+depth",
                                  "fusion dev-flow", "fusion dev-flow+d"]
    for mode, phases in out["modes"].items():
        assert set(phases) == {"submit", "uploads", "dispatch",
                               "prepare+image copy", "result", "frame"}
        assert phases["dispatch"] > 0
        # the flow goes through _upload in every fused mode (a device
        # tensor is rounded there on the device)
        assert (phases["uploads"] > 0) == (mode != "plain"), mode
