"""Multi-process plumbing: global batches and the evaluation gather (port
of :mod:`pvo_tpu.parallel.multihost`).

The reference gathers with ``torch.distributed`` (VPS_Module/detectron2/
utils/comm.py:19-99: all_gather of pickled prediction payloads, and
engine/launch.py's process groups); the JAX package rebuilt that over
its mesh. Here each helper is a collective of the default process group
(:func:`pvo_tpu_torch.parallel.data_parallel.make_mesh` forms it), and
without a process group each degenerates to a no-op, as the JAX helpers
do on one host: the same code serves one process, one card and several.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _distributed():
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _distributed() else 1


def is_main_process() -> bool:
    return not _distributed() or dist.get_rank() == 0


def global_batch_from_local(local_batch, device=None):
    """Every rank's local batch (a dict of numpy or tensor leaves with a
    leading batch axis, the same shapes on every rank) concatenated in
    rank order: the global batch, as tensors on ``device`` (default: the
    card for NCCL, else the CPU) on every rank; the local batch as
    tensors without a process group."""
    if device is None:
        device = ("cuda" if _distributed() and dist.get_backend() == "nccl"
                  else "cpu")

    def put(x):
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                            ).to(device).contiguous()
        if not _distributed():
            return x
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    return {k: put(v) for k, v in local_batch.items()}


def gather_payloads(payloads: Sequence[Any]):
    """Every rank's python payloads (e.g. PQ prediction dicts) on every
    rank, in rank order (the reference's comm.gather of pickled bytes,
    panoptic_evaluation.py:118-121); the payloads themselves without a
    process group."""
    if not _distributed():
        return list(payloads)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, list(payloads))
    return [p for part in out for p in part]


def sync():
    """Barrier (the reference's comm.synchronize)."""
    if _distributed():
        dist.barrier()
