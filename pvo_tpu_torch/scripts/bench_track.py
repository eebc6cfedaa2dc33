"""VO frame throughput on one card (port of ``bench.py``): the tracking
loop (motion filter -> frontend: recurrent update + DBA) on a synthetic
stream at the vkitti2 eval geometry, printed as ONE JSON line. Writes no
file.

    python -m pvo_tpu_torch.scripts.bench_track [--image_size 240 808]
        [--frames 40 30] [--device cpu] [--classic]

The protocol of ``bench.py``: 240x808, ``buffer=128``, every frame a
keyframe (``filter_thresh=0.01``, ``keyframe_thresh=0.0``), ``warmup=12``,
the segment filter on with about 90 segments a frame
(:func:`synth_stream`), and the default configuration's planner, which
engages after initialization (``engaged_at``, frame 13), as ``bench.py``
runs; ``--classic`` keeps the classic host loop. 40 warm-up frames (on
the card the planner's eager frames and its capture fall in them), then
30 measured on the host clock (``utils.tracing.StepTimer``) with one
synchronize at the end; then 3 more frames under ``torch.profiler``
give ``device_ms_per_frame`` (the kernel rows, the ctypes-launched corr
kernels and the kernels a CUDA graph launches included), the card's
busy share and ``host_api_calls_per_frame`` (the CUDA runtime calls the
host made). Weights are random from seed 0, tamed by :func:`tame_net`.

``vs_baseline`` is null: ``bench.py``'s 10 fps envelope is no figure of
this card. ``mfu_vs_bf16_peak`` is null: the JAX figure comes from XLA's
cost analysis of the planner's program, which the port does not have.
On the CPU (``--device cpu``) the device fields are null.
"""

import argparse
import contextlib
import json

import numpy as np
import torch

from pvo_tpu_torch.scripts.kbench import RANGE_PREFIXES, averages, profiled
from pvo_tpu_torch.utils.config import VOConfig
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.utils.tracing import StepTimer
from pvo_tpu_torch.vo.factor_graph import FactorGraph
from pvo_tpu_torch.vo.frontend import Frontend
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.vo.system import VOSystem

# the hand-written corr kernels, by the names of their CUDA functions
CORR_KERNELS = {"K1": ("build_volumes_tc_kernel", "build_volumes_f32_kernel"),
                "K2": ("corr_extract_kernel",),
                "K3_bf16": ("corr_lookup_tc_kernel",),
                "K3_f32": ("corr_lookup_f32_kernel",)}


def synth_stream(n, H, W, seed=0):
    """bench.py's stream: a moving random texture and a panoptic map of
    ~90 distinct ids per frame (4x4 cells at 1/8 res) moving with it."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (H + 64, W + 64, 3), np.uint8)
    h, w = H // 8, W // 8
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    intr = np.array([725.0087 * W / 1242, 725.0087 * W / 1242,
                     W / 2.0, H / 2.0], np.float32)
    for t in range(n):
        dy, dx = (2 * t) % 64, (3 * t) % 64
        segm = ((((yy + t) // 4) * (w // 4 + 1) + (xx + 2 * t) // 4)
                % 90 + 1).astype(np.int32) * 10000 + 3
        yield t, base[dy:dy + H, dx:dx + W], intr, segm


def tame_net(seed=0, scale=0.01, mask_bias=0.0):
    """Random weights (seed) with the flow/mask heads' last convs scaled
    by ``scale``. With unscaled random weights the tracker is chaotic: a
    1e-6 change grows to O(1) in three updates, and at 240x808 the
    disparities reach 1e10 and the bf16 update overflows to NaN by frame
    18, with only 16-24 edges left after initialization. Scaled, the
    run is stable and holds the reference's 48-edge steady state. The
    work per update is the same. ``mask_bias`` is added to the mask
    head's output bias: scaled, the head leaves the mask logits near 0,
    the static/dynamic threshold."""
    net = DroidNet.from_seed(seed)
    with torch.no_grad():
        for head in ("delta", "delta_dy", "delta_mask"):
            getattr(net.update, head)[2].weight.mul_(scale)
            getattr(net.update, head)[2].bias.mul_(scale)
        net.update.delta_mask[2].bias.add_(mask_bias)
    return net


@contextlib.contextmanager
def vo_counters(removed, edges, keyframes):
    """While the block runs, append to ``removed`` each keyframe the
    frontend removes, to ``edges`` the backend's edges at each global
    update call, and to ``keyframes`` the keyframe count after each
    ``terminate``: with random weights the tracker is chaotic, so these
    counts differ from run to run and say what a time measured."""
    saved = (Frontend.rm_keyframe_deferred, FactorGraph.update_lowmem,
             VOSystem.terminate)
    rm, update_lowmem, terminate = saved

    def terminate_counted(sysm, *a, **kw):
        out = terminate(sysm, *a, **kw)
        keyframes.append(int(sysm.video.counter))
        return out

    Frontend.rm_keyframe_deferred = \
        lambda fe, ix: removed.append(ix) or rm(fe, ix)
    FactorGraph.update_lowmem = lambda g, *a, **kw: \
        edges.append(g.n_edges) or update_lowmem(g, *a, **kw)
    VOSystem.terminate = terminate_counted
    try:
        yield
    finally:
        (Frontend.rm_keyframe_deferred, FactorGraph.update_lowmem,
         VOSystem.terminate) = saved


def bench_system(image_size, buffer, device, pipeline=True,
                 keyframe_thresh=0.0):
    """The benches' VOSystem: every frame a keyframe (unless
    ``keyframe_thresh`` removes some), segment filter on, weights of
    :func:`tame_net` (0); the planner engaged after initialization
    (``pipeline``, the default, as ``bench.py`` runs), or the classic host
    loop."""
    cfg = VOConfig(image_size=tuple(image_size), buffer=buffer,
                   filter_thresh=0.01, keyframe_thresh=keyframe_thresh,
                   warmup=12, segm_filter=True, pipeline=pipeline)
    return VOSystem(cfg, net=tame_net(0), device=device)


def kernel_rows(prof):
    """(device ms, launches) of every kernel in a finished profile."""
    rows = [r for r in averages(prof)
            if r.device_type == torch.autograd.DeviceType.CUDA
            and not r.key.startswith(RANGE_PREFIXES)]
    return (sum(r.self_device_time_total for r in rows) / 1e3,
            sum(r.count for r in rows))


def api_calls(prof):
    """The CUDA runtime calls of a finished profile (its host rows whose
    names start with ``cuda``)."""
    return sum(r.count for r in averages(prof)
               if r.device_type == torch.autograd.DeviceType.CPU
               and r.key.startswith("cuda"))


def corr_rows(prof):
    """{K1, K2, K3_bf16, K3_f32: (device ms, launches)} of a profile."""
    out = {}
    for tag, names in CORR_KERNELS.items():
        rows = [r for r in averages(prof)
                if r.device_type == torch.autograd.DeviceType.CUDA
                and any(n in r.key for n in names)]
        out[tag] = (sum(r.self_device_time_total for r in rows) / 1e3,
                    sum(r.count for r in rows))
    return out


def run(image_size=(240, 808), n_warm=40, n_meas=30, n_prof=3,
        device="cuda", pipeline=True):
    dev = open_device(device)
    H, W = image_size
    sysm = bench_system(image_size, 128, dev, pipeline=pipeline)
    frames = list(synth_stream(n_warm + n_meas + n_prof, H, W))

    # warm-up: initialization at frame 12, the planner's engage, eager
    # frames and capture, and the first retirements
    timer = StepTimer()
    engaged_at = None
    with timer.time("warm-up", sync=sysm.video.poses):
        for t, img, intr, segm in frames[:n_warm]:
            sysm.track(t, img, intr, segments=segm)
            if engaged_at is None and sysm.planner.engaged:
                engaged_at = t
    # the measured frames, one synchronize at the end (bench.py:94)
    with timer.time("measured", sync=sysm.video.poses):
        for t, img, intr, segm in frames[n_warm:n_warm + n_meas]:
            sysm.track(t, img, intr, segments=segm)
    dt = timer.totals["measured"]
    fps = n_meas / dt

    device_ms = busy = kernels = api = None
    if dev.type == "cuda":
        with profiled() as prof:
            for t, img, intr, segm in frames[n_warm + n_meas:]:
                sysm.track(t, img, intr, segments=segm)
            torch.cuda.synchronize(dev)
        ms, n = kernel_rows(prof)
        device_ms = ms / n_prof
        kernels = n / n_prof
        api = api_calls(prof) / n_prof
        busy = device_ms / (1e3 * dt / n_meas)
    return {
        "metric": "vo_track_frames_per_sec",
        "value": fps,
        "unit": f"frames/s @{H}x{W} keyframe-everything, "
                "~90 segments/frame",
        "vs_baseline": None,
        "device_ms_per_frame": device_ms,
        "kernels_per_frame": kernels,
        "device_busy_share": busy,
        "host_api_calls_per_frame": api,
        "mfu_vs_bf16_peak": None,
        "path": "planner" if pipeline else "classic",
        "engaged_at": engaged_at,
        "keyframes": len(sysm.get_traj()),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image_size", type=int, nargs=2, default=[240, 808])
    p.add_argument("--frames", type=int, nargs=2, default=[40, 30],
                   metavar=("WARM", "MEASURED"))
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--classic", action="store_true",
                   help="the classic host loop (VOConfig.pipeline=False)")
    args = p.parse_args(argv)
    out = run(tuple(args.image_size), *args.frames, device=args.device,
              pipeline=not args.classic)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
