"""The DBA at tracking shapes on the card (port of ``scripts/bench_dba.py``).

    python -m pvo_tpu_torch.scripts.bench_dba [E [P [K [iters]]]]
        [--device cpu]

The JAX script's synthetic inputs from ``RandomState(0)``: 128 frames of
30x101 disparities, poses 0.05-scale translations, E=48 edges (the last
4 padding) between frames 0-24, P=32 poses, K=32 depth frames, 2
Gauss-Newton iterations, the edge pairs of ``dba.build_edge_pairs`` at
512. ``vo/dba.py`` is plain PyTorch (f32) with the segment sums on the
card's kernel (``csrc/segsum.cu``). Prints the kernels' device ms of one
traced call (``kbench.breakdown``) and the 25 costliest kernels: the
measurement to take before writing a DBA kernel. On the CPU only the
host ms. ``dba_launches``: the DBA kernels' launches in one call (the
damped solve above ``cuda_dba.SOLVE_MAX_P`` as ``dba_solve_grid``). One
JSON line last.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vo import dba as dba_mod
from pvo_tpu_torch.vo.net import cuda_dba


def dba_inputs(E, K, device):
    """The JAX script's DBA arguments (tensors on ``device``) before the
    window: poses, disps, intrinsics, target, weight, eta, ii, jj,
    valid and the edge pairs, for 128 frames of 30x101."""
    F, h, w = 128, 30, 101
    rng = np.random.RandomState(0)
    poses = np.zeros((F, 7), np.float32)
    poses[:, 6] = 1.0
    poses[:, :3] = 0.05 * rng.randn(F, 3)
    disps = (1.0 + 0.1 * rng.rand(F, h, w)).astype(np.float32)
    intr = np.array([100.0, 100.0, w / 2, h / 2], np.float32)
    n_real = E - 4
    ii = rng.randint(0, 24, n_real)
    jj = (ii + 1 + rng.randint(0, 3, n_real)) % 25
    ii = np.pad(ii, (0, E - n_real)).astype(np.int64)
    jj = np.pad(jj, (0, E - n_real)).astype(np.int64)
    valid = np.zeros(E, bool)
    valid[:n_real] = True
    target = (rng.rand(E, h, w, 2) * np.array([w, h])).astype(np.float32)
    weight = rng.rand(E, h, w, 2).astype(np.float32)
    eta = 0.01 * np.ones((K, h, w), np.float32)
    pa, pb, pv = dba_mod.build_edge_pairs(ii, valid, 512)
    return tuple(torch.from_numpy(a).to(device) for a in
                 (poses, disps, intr, target, weight, eta, ii, jj, valid,
                  pa, pb, pv))


TOP = 25


def run(E=48, P=32, K=32, iters=2, device="cuda"):
    dev = open_device(device)
    args = dba_inputs(E, K, dev)

    def call():
        return dba_mod.dba(*args, 0, 25, 0, P=P, K=K, iters=iters)

    before = dict(cuda_dba.LAUNCHES)
    poses, disps = call()
    # the DBA kernels' launches in one call (on the CPU their plain
    # versions: zeros)
    dba_launches = {k: n - before[k] for k, n in cuda_dba.LAUNCHES.items()}
    if not (torch.isfinite(poses).all() and torch.isfinite(disps).all()):
        raise AssertionError("the DBA gave non-finite poses or disparities")
    res = kbench.breakdown(call, dev, top=TOP)
    ms = res["device_ms"]
    print(f"dba E={E} P={P} K={K} iters={iters}: "
          + (f"{ms:.3f} ms device, {res['launches']} kernels"
             if ms is not None else f"{res['host_ms']:.3f} ms host (CPU)"))
    print("DBA kernel launches a call: " + ", ".join(
        f"{k} {n}" for k, n in dba_launches.items()))
    return {"E": E, "P": P, "K": K, "iters": iters, **res,
            "dba_launches": dba_launches,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("sizes", type=int, nargs="*", default=[48, 32, 32, 2],
                   help="E [P [K [iters]]]")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    E, P, K, iters = args.sizes + [48, 32, 32, 2][len(args.sizes):]
    out = run(E, P, K, iters, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
