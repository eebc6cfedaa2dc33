"""The readings that the limits of ``pvo_bench/limits/<cell>.json`` were
set from: for each seed, a short run of the cell with the program's
numbers compared (as every run compares them) and, with ``--control``,
the control's beside them (the reference one precision step below the
configuration's, in the program's place; see ``check.py``).

    python3 -m pvo_bench.control --workload <cell> --seeds <n> [<n> ...]
        [--seconds 3] [--control]

One JSON line a seed: the program's readings and ``correct``, and with
``--control`` the control's readings and ``control_correct``, the
control judged by the cell's limits as a run of the program is (it has
to come out false). The benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    from pvo_bench import harness, program
    from pvo_bench.harness import log
    import torch
    bench = harness.load_json(harness.REPO / "BENCHMARK.json")
    cell, config, traffic, limits, _, _ = harness.cell_files(
        bench, args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    runner = harness.load_module("kinds", traffic["kind"])
    for seed in args.seeds:
        a = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        run = harness.Run(a, time.perf_counter(), cell, config, traffic,
                          limits)
        if args.control:
            run.control = {}
        runner.run(run)
        out = {"workload": args.workload, "seed": seed,
               "program": run.readings, "control": run.control,
               "correct": run.correct()}
        if args.control:
            # the control in the program's place, judged as a run is
            out["control_correct"] = run.correct(run.control)
            for k, v, lim in run.checks(run.control):
                log(f"control check {k} = {v} (limit {lim})")
        print(json.dumps(out), flush=True)
        del run
        program.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
