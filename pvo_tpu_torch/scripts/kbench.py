"""Kernel timing on one NVIDIA GPU.

    from pvo_tpu_torch.scripts.kbench import device_time_ms
    ms = device_time_ms(lambda: kernel(x))

``device_time_ms`` records CUDA events around ``reps`` calls after one
warm-up call and returns the mean device time per call, as
``scripts/kbench.py`` times kernels for the JAX package on the TPU.
``gpu_line`` is the card's name and power limit, to stand beside every
time kept.
"""

from __future__ import annotations

import subprocess

import torch


def require_cuda():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")


def gpu_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_time_ms(fn, reps=10):
    """Mean device time of ``fn()`` in ms over ``reps`` calls (CUDA
    events), after one warm-up call."""
    require_cuda()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
