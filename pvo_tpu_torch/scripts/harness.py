"""What the corr experiment harnesses ``corr_exp{,2,3,4,5}`` share: their
command line ``[E [H W]]``, their inputs, and the timing of each case
beside its plain version (through :mod:`kbench`).
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from pvo_tpu_torch.scripts.kbench import device_time_ms, gpu_line
from pvo_tpu_torch.vo.net import cuda_corr, cuda_corr_exp


def shape_args(argv, default):
    """``[E [H W]]`` from the command line, else ``default``."""
    argv = sys.argv[1:] if argv is None else argv
    E, H, W = default
    if argv:
        E = int(argv[0])
    if len(argv) >= 3:
        H, W = int(argv[1]), int(argv[2])
    return E, H, W


def harness_inputs(E, H, W, C=128, seed=0):
    """The JAX harnesses' inputs, on the card: f1, f2 standard normal in
    bf16, coords uniform in [0, W-1] x [0, H-1] (f32)."""
    rng = np.random.RandomState(seed)
    f1 = torch.tensor(rng.randn(E, H, W, C), dtype=torch.bfloat16)
    f2 = torch.tensor(rng.randn(E, H, W, C), dtype=torch.bfloat16)
    coords = torch.tensor(rng.rand(E, H, W, 2) * np.array([W - 1, H - 1]),
                          dtype=torch.float32)
    dev = torch.device("cuda")
    return f1.to(dev), f2.to(dev), coords.to(dev)


def run_cases(cases, fn, plain_fn):
    """Each case ``tag -> kwargs``: ``fn(**kwargs)`` (a kernel) and
    ``plain_fn(**kwargs)`` (its plain version on the same inputs) timed
    and printed beside each other with max |d|. A case with the kwargs
    of an earlier one is the same call and takes its numbers. Returns
    {tag: (ms, plain_ms, err)}."""
    res, first = {}, {}
    for tag, kw in cases.items():
        key = tuple(sorted(kw.items()))
        if key in first:
            res[tag] = res[first[key]]
            print(f"{tag}: the same call as {first[key]}", flush=True)
            continue
        first[key] = tag
        err = (fn(**kw).float() - plain_fn(**kw).float()).abs().max().item()
        ms = device_time_ms(lambda: fn(**kw))
        plain_ms = device_time_ms(lambda: plain_fn(**kw))
        print(f"{tag}: {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"max|d|={err:.4g}", flush=True)
        res[tag] = (ms, plain_ms, err)
    return res


def extract_cases(argv, cases, baseline=None):
    """The extraction harnesses (X2-X5): K1's volume of the harness
    inputs (E=32, 30x101 unless ``argv`` says otherwise), then each case
    ``tag -> corr_extract_packed kwargs`` through :func:`run_cases`.
    ``baseline`` labels a line with K2's time on the same volume (196 f32
    dx-major channels, not the packed layout)."""
    E, H, W = shape_args(argv, (32, 30, 101))
    f1, f2, coords = harness_inputs(E, H, W)
    vol = cuda_corr.build_volumes(f1, f2)
    print(f"E={E} {H}x{W}: K1 volume {vol.numel() * 2 / 1e6:.1f} MB bf16; "
          f"{gpu_line()}", flush=True)
    if baseline:
        ms = device_time_ms(lambda: cuda_corr.corr_extract(vol, coords))
        print(f"{baseline} (K2, 196 f32 channels, not packed): {ms:.4f} ms",
              flush=True)
    return run_cases(
        cases,
        functools.partial(cuda_corr_exp.corr_extract_packed, vol, coords),
        functools.partial(cuda_corr_exp.corr_extract_packed_plain, vol,
                          coords))
