"""Run one cell of the benchmark once and print its result line.

    python3 -m pvo_bench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``pvo_bench/configs/<config>.json``) and a traffic mix
(``pvo_bench/traffic/<traffic>.json``); the mix's ``kind`` names the
runner that runs it (``pvo_bench/kinds/<kind>.py``), the cell's limits
are ``pvo_bench/limits/<workload>.json`` and every metric is read by
``pvo_bench/metrics/<metric>.py``. ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a run with
the profiler on. The last line of standard output is one JSON object;
the numbers compared with the reference, each beside its limit, are
its last key and the last lines of standard error.

Runs only on a CUDA card: without one (or with fewer than the cell
asks for) it exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from pvo_bench import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
