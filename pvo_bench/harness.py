"""The harness: finds a cell's files by name, checks for the card, runs
the traffic mix's runner, reads the metrics and prints the result.

Everything that belongs to one configuration, mix, metric or cell lives
in a file of its own under ``pvo_bench/`` (see ``run.py``), so a cell or
a metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "pvo_tpu")


class Refused(Exception):
    """The run cannot be made here: no result is printed."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(kind, name):
    """``pvo_bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no file {path.relative_to(REPO)}")
    spec = importlib.util.spec_from_file_location(
        f"pvo_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench, workload):
    """The cell's entry and everything found by its names: configuration,
    traffic, limits and the metric entries it reports (end-to-end and
    per-layer)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload named {workload!r}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(REPO / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m) and
             m["moves"] in names]
    return cell, config, traffic, limits, e2e, layer


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Run:
    """What a runner fills in: set-up and window times, counters, the
    reduced trace, the memory peak and the compared numbers."""

    def __init__(self, args, t_start, cell, config, traffic, limits):
        self.args, self.t_start = args, t_start
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits = limits
        self.seed, self.seconds = args.seed, args.seconds
        self.trace = bool(args.trace)
        self.setup_s = None
        self.attempted = self.failed = 0
        self.memory_peak = None
        self.profile = None          # trace.Profile of the traced stretch
        self.readings = {}           # number -> value (all computed)
        self.control = None          # the control's readings, when asked
        self.data = {}               # runner-specific values for readers

    def since_start(self):
        return time.perf_counter() - self.t_start

    def checks(self, readings=None):
        """[(name, value, limit)] of the numbers compared: the program's
        readings, or ``readings`` (the control's) in their place."""
        readings = self.readings if readings is None else readings
        return [(k, readings.get(k), float(v["limit"]))
                for k, v in self.limits["numbers"].items()]

    def correct(self, readings=None):
        """Whether the run is correct: nothing failed and every number
        compared is within its limit (``readings``: the control's)."""
        return self.failed == 0 and all(
            v is not None and math.isfinite(v) and v <= lim
            for _, v, lim in self.checks(readings))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def power_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(args, t_start):
    try:
        bench = load_json(REPO / "BENCHMARK.json")
        cell, config, traffic, limits, e2e, layer = cell_files(
            bench, args.workload)
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"needs {cell['chips']} CUDA card(s), found "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        runner = load_module("kinds", traffic["kind"])
        readers = {m["name"]: load_module("metrics", m["name"])
                   for m in (layer if args.trace else e2e)}
    except (Refused, FileNotFoundError, KeyError) as e:
        log(f"refused: {e}")
        return 2

    run = Run(args, t_start, cell, config, traffic, limits)
    runner.run(run)

    metrics = {}
    for m in (layer if args.trace else e2e):
        value = readers[m["name"]].read(run)
        if value is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        log(f"refused: modules loaded that no run may load: {bad}")
        return 3

    dev = torch.device("cuda", 0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell["chips"], "memory_peak_bytes": run.memory_peak}
    out = {"correct": run.correct(), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if args.trace and run.profile is not None:
        device["busy_s"] = run.profile.busy_s
        device["window_s"] = run.profile.window_s
        out["breakdown"] = run.profile.breakdown()
    log(f"card: {power_line()}")
    checks = run.checks()
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    for k, v, lim in checks:
        log(f"check {k} = {v} (limit {lim})")
    print(json.dumps(out), flush=True)
    return 0
