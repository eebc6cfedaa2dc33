"""The system under test: ``pvo_tpu_torch``'s ``VOSystem`` built from a
configuration file and the weights the harness made from the seed.

This is where the harness takes the program, its counters and its
decision records; the reference (``pvo_bench/reference``) takes nothing
of it.
"""

from __future__ import annotations

import contextlib
import copy
import time
import types

import numpy as np
import torch

from pvo_bench.reference import net as ref_net


def open_card(run):
    """The first card, with TF32 off (the program's f32 paths are f32);
    the CPU only where the caller put it in ``run.data["device"]`` (the
    tests at tiny sizes)."""
    from pvo_tpu_torch.utils.device import open_device
    return open_device(run.data.get("device", "cuda:0"))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Marks:
    """Completion times of queued work, in ms from :meth:`start`: CUDA
    events read on the card's clock after the fact, or the host clock
    where work runs as it is called (the CPU)."""

    def __init__(self, dev, n):
        self.dev, self.card = dev, dev.type == "cuda"
        self.ev = [torch.cuda.Event(enable_timing=True)
                   for _ in range(n + 1)] if self.card else None
        self.t = [0.0] * (n + 1)

    def _grow(self, i):
        while len(self.t) <= i + 1:
            self.t.append(0.0)
            if self.card:
                self.ev.append(torch.cuda.Event(enable_timing=True))

    def start(self):
        sync(self.dev)
        if self.card:
            self.ev[0].record()
        self.h0 = time.perf_counter()
        return self.h0

    def mark(self, i):
        self._grow(i)
        if self.card:
            self.ev[i + 1].record()
        else:
            self.t[i + 1] = 1e3 * (time.perf_counter() - self.h0)

    def ms(self, i):
        return self.ev[0].elapsed_time(self.ev[i + 1]) if self.card \
            else self.t[i + 1]


def memory_peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def weights(config, dev):
    """The configuration's weights (f32, on ``dev``): random from its own
    seed, as a checkpoint would be the same whatever the stream, tamed as
    it says. The run's seed makes the stream."""
    w = config["weights"]
    return ref_net.from_seed(w["seed"], dev, scale=w["head_scale"],
                             mask_bias=w["mask_bias"])


def build(config, sd, dev, buffer=None):
    """A ``VOSystem`` at the configuration's settings with the weights
    ``sd``; ``buffer`` overrides the configuration's keyframe buffer."""
    from pvo_tpu_torch.utils.config import VOConfig
    from pvo_tpu_torch.vo.net.droidnet import DroidNet
    from pvo_tpu_torch.vo.system import VOSystem
    droid = DroidNet().to(dev)
    droid.load_state_dict(sd)
    vo = dict(config["vo"])
    vo["buffer"] = buffer or config["buffer"]
    cfg = VOConfig(image_size=tuple(config["image_size"]), **vo)
    return VOSystem(cfg, net=droid, device=dev)


@contextlib.contextmanager
def patched(obj, name, wrap):
    """``obj.name`` replaced by ``wrap(obj.name)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def record_decisions(sysm, records, clock):
    """Keep each frame's decision record (as the planner resolves it, two
    frames late) in ``records`` by the frame's timestamp, and add the
    host's seconds spent resolving them (mostly waiting for the card) to
    ``clock["wait"]``."""
    planner = sysm.planner
    resolve = type(planner)._resolve_one

    def resolve_kept(self):
        ts = self._records[0][1]
        t = time.perf_counter()
        rec = resolve(self)
        clock["wait"] += time.perf_counter() - t
        records[int(ts)] = [int(x) for x in rec]
        return rec

    planner._resolve_one = types.MethodType(resolve_kept, planner)


# the decision record's fields (pvo_tpu_torch/vo/planner.py R_*)
R_RAN, R_N, R_FLAGS, R_SMALL, R_STEPS2 = 1, 6, 8, 10, 11
# the program's scalar state (S_*)
S_COUNTER, S_T1 = 0, 1


def frame_sections(rec):
    """The conditional sections of the frame program that a frame with
    record ``rec`` ran (as ``PlannerDriver.sections``)."""
    if not rec[R_RAN]:
        return ()
    regime = "compact" if rec[R_SMALL] else "full"
    out = [("update",), ("update", regime)]
    if rec[R_STEPS2]:
        out.append(("update", regime, "steps2"))
    return tuple(out)


def frame_state(sysm, lo, hi, to):
    """A copy (on device ``to``) of the planner's state and of video rows
    [lo, hi): what a frame reads and writes."""
    st, v = sysm.planner.st, sysm.video
    keys = ("ii", "jj", "valid", "age", "net", "target", "weight", "raw",
            "dy", "t_inac", "w_inac", "inac_ii", "inac_jj", "inac_valid",
            "scal", "record")
    s = {k: getattr(st, k).clone() for k in keys}
    s["poses"] = v.poses[:hi].clone()
    s["disps"] = v.disps[:hi].clone()
    s["damping"] = v.damping[:hi].clone()
    s["intr"] = v.intrinsics[0].clone()
    s["rows"] = {k: getattr(v, k)[lo:hi].clone()
                 for k in ("fmaps", "nets", "inps", "segms")}
    s["lo"] = lo
    return to_device(s, to)


def to_device(state, dev):
    """``state`` (a dict of tensors, dicts and numbers) on ``dev``."""
    if isinstance(state, dict):
        return {k: to_device(v, dev) for k, v in state.items()}
    return state.to(dev) if isinstance(state, torch.Tensor) else state


def free():
    """Return the memory of dropped program state to the card."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Snapshot:
    """The system's state between calls, restored in place: every tensor
    attribute of the system and of its parts keeps its identity and gets
    its contents back (an attribute the call rebound is bound to it
    again); plain values (numbers, arrays, lists, dicts) are copied.
    Containers of tensors (the weights' slices) are left as they are.

    ``rows``: only the first ``rows`` frames of the video's per-frame
    tensors are kept and restored (the rest are written before they are
    read), and the engaged planner's device state (``planner.st``, its
    tensors) is kept too: a live stream restarted from the state after
    its warm-up."""

    PLAIN = (int, float, bool, str, type(None), np.ndarray, np.generic,
             list, tuple, dict, set)

    def __init__(self, sysm, rows=None):
        self.parts = [sysm, sysm.video, sysm.frontend, sysm.frontend.graph,
                      sysm.filterx, sysm.backend, sysm.traj_filler,
                      sysm.planner]
        self.saved = []
        for obj in self.parts:
            cut = rows if obj is sysm.video else None
            for name, val in vars(obj).items():
                if isinstance(val, torch.Tensor):
                    part = val[:cut] if cut is not None and val.dim() and \
                        val.shape[0] == sysm.video.buffer else val
                    self.saved.append((obj, name, val, part.clone()))
                elif isinstance(val, self.PLAIN) and not _holds_tensor(val):
                    self.saved.append((obj, name, None, copy.deepcopy(val)))
        st = sysm.planner.st
        if rows is not None and st is not None:
            for name, val in vars(st).items():
                if isinstance(val, torch.Tensor) and not val.is_pinned():
                    self.saved.append((st, name, val, val.clone()))

    def restore(self):
        for obj, name, tensor, val in self.saved:
            if tensor is not None:
                if tensor.dim():
                    tensor[:val.shape[0]].copy_(val)
                else:
                    tensor.copy_(val)
                setattr(obj, name, tensor)
            else:
                setattr(obj, name, copy.deepcopy(val))


def _holds_tensor(val):
    if isinstance(val, torch.Tensor):
        return True
    if isinstance(val, dict):
        return any(_holds_tensor(v) for v in val.values())
    if isinstance(val, (list, tuple, set)):
        return any(_holds_tensor(v) for v in val)
    return False
