"""Device choice of the port's entry points.

They run on the card unless the caller asks for the CPU, and never pick
the CPU by themselves.
"""

from __future__ import annotations

import torch


def open_device(device="cuda"):
    """``device`` as a ``torch.device``; raises when it names a CUDA
    device and there is none. Switches TF32 off for matmuls and cuDNN
    convolutions: the port's f32 paths are held against f32 references."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device
