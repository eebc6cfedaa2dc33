"""K3 and its packed variant on the card (port of ``scripts/bench_corr.py``).

    python -m pvo_tpu_torch.scripts.bench_corr [E [H W]] [--device cuda]

The JAX script's inputs: E=64 edges of 30x101 bf16 features, C=128, and
uniform coordinates over the image, from ``RandomState(0)``. It times
``pallas_corr_lookup(packed=False)``, whose counterpart is K3
(``cuda_corr.corr_lookup``), and ``packed=True``, the (E, H, W, 4*64)
level-major bf16 tap blocks: that layout and blend are P1's
``order="level", seldt="f32"`` variant (``cuda_corr_exp.corr_lookup_packed``;
held against ``pallas_corr_lookup(..., packed=True, interpret=True)`` on
the CPU: one bf16 ulp apart in under 0.01% of the taps, from the f32
summation order). Each output is first held against its plain version
(K3 within 1e-4, P1 within 2e-2 + 8e-3 |ref| with >= 99.9% bit-equal,
the tolerances of the CUDA tests), then timed by CUDA events through the
wrapper (``kbench.device_time_ms``) beside ``kbench.kernel_bound`` and
the share of it, with the costliest kernels of one traced call. Times
need the card: without one (or with ``--device cpu``) it raises
``RuntimeError``. One JSON line last.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vo.net import cuda_corr, cuda_corr_exp

C = 128
TOP = 6
K3_TOL = 1e-4
PACKED_TOL, PACKED_EQUAL = (2e-2, 8e-3), 0.999


def inputs(E, H, W, device):
    """The JAX script's f1, f2 (bf16) and uniform coords (f32)."""
    rng = np.random.RandomState(0)
    f1 = rng.randn(E, H, W, C)
    f2 = rng.randn(E, H, W, C)
    coords = rng.rand(E, H, W, 2) * np.array([W - 1, H - 1])
    return (torch.tensor(f1, dtype=torch.float32).to(device, torch.bfloat16),
            torch.tensor(f2, dtype=torch.float32).to(device, torch.bfloat16),
            torch.tensor(coords, dtype=torch.float32).to(device))


def packed_agreement(out, ref):
    """(max |d|, share bit-equal, entries beyond the packed tolerance)."""
    a, b = out.float(), ref.float()
    d = (a - b).abs()
    bad = int((d > PACKED_TOL[0] + PACKED_TOL[1] * b.abs()).sum())
    return d.max().item(), (a == b).float().mean().item(), bad


def run(E=64, H=30, W=101, device="cuda"):
    dev = open_device(device)
    if dev.type != "cuda":
        raise RuntimeError("bench_corr times kernels by CUDA events: it "
                           "needs the card")
    f1, f2, coords = inputs(E, H, W, dev)
    out = {"E": E, "H": H, "W": W, "C": C}
    k3 = cuda_corr.corr_lookup(f1, f2, coords)
    err = kbench.lookup_err(k3, cuda_corr.corr_lookup_plain(f1, f2, coords))
    if not err <= K3_TOL:
        raise AssertionError(f"K3 {err} from its plain version")
    packed = cuda_corr_exp.corr_lookup_packed(f1, f2, coords)
    p_err, equal, bad = packed_agreement(
        packed, cuda_corr_exp.corr_lookup_packed_plain(f1, f2, coords))
    if bad or equal < PACKED_EQUAL:
        raise AssertionError(f"P1: {bad} outputs beyond tolerance, "
                             f"{equal:.6f} bit-equal")
    cases = (("packed", "corr_lookup_packed", p_err,
              lambda: cuda_corr_exp.corr_lookup_packed(f1, f2, coords)),
             ("k3", "corr_lookup", err,
              lambda: cuda_corr.corr_lookup(f1, f2, coords)))
    for key, kernel, e, fn in cases:
        ms = kbench.device_time_ms(fn)
        bound = kbench.kernel_bound(kernel, E, H, W, C)
        print(f"{kernel} (packed={key == 'packed'}): {ms:.4f} ms device, "
              f"bound {bound['ms']:.4f} ms ({bound['bound_by']}), share "
              f"{bound['ms'] / ms:.1%}")
        kbench.print_top(kbench.trace_totals(fn), TOP)
        out[key] = {"kernel": kernel, "ms": ms, "kernel_bound_ms": bound["ms"],
                    "bound_by": bound["bound_by"], "share": bound["ms"] / ms,
                    "max_abs_err": e}
    out["packed"]["bit_equal"] = equal
    out["device"] = torch.cuda.get_device_name(dev)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("shape", type=int, nargs="*", default=[64, 30, 101],
                   help="E [H W]")
    p.add_argument("--device", default="cuda",
                   help="cuda (default); the times need the card")
    args = p.parse_args(argv)
    E, H, W = args.shape + [64, 30, 101][len(args.shape):]
    out = run(E, H, W, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
