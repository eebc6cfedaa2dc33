"""No run loads the JAX package or JAX, and the reference loads nothing
of the program: checked in fresh interpreters."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "pvo_tpu")


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    mods = _modules("import pvo_bench.reference.vo, pvo_bench.reference.ba, "
                    "pvo_bench.reference.net, pvo_bench.check")
    tops = {m.split(".")[0] for m in mods}
    assert "pvo_tpu_torch" not in tops
    assert not tops & set(FORBIDDEN)


def test_a_run_loads_no_jax():
    # the whole runner of a tracking cell at a tiny size on the CPU: the
    # program, the reference and the check
    code = """
import argparse, time, torch
torch.set_num_threads(2)
from pvo_bench import harness
from pvo_bench.kinds import track
cfg = harness.load_json('pvo_bench/configs/pvo_vo_240x808.json')
cfg['image_size'] = [64, 128]; cfg['buffer'] = 64
traffic = dict(harness.load_json('pvo_bench/traffic/live.json'),
               warm_frames=20, check_frames=1, check_span=1)
a = argparse.Namespace(seed=2**31 + 5, seconds=0.5, trace=0)
run = harness.Run(a, time.perf_counter(), {'chips': 1}, cfg, traffic,
                  {'numbers': {}})
run.data['device'] = 'cpu'
track.run(run)
assert run.readings
"""
    mods = _modules(code)
    assert "pvo_tpu_torch" in {m.split(".")[0] for m in mods}
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    # the top-level names are compared whole: the port's name begins
    # with the JAX package's
    assert "pvo_tpu_torch".split(".")[0] not in FORBIDDEN
