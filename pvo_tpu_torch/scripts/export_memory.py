"""Where the flow/depth export's and the VPS predictor's peak memory
comes from on the card.

    python -m pvo_tpu_torch.scripts.export_memory [H W ...]

For each image size (default 240x808, the narrow corr route, and
376x1248, the wide one): one warm-up pair, then one pair of
``test_vo2.export_pair`` (15 iterations, f32, random weights) with
PyTorch's allocator history recording; prints the memory held before the
pair, its peak, and the largest allocations with the port's call sites
that made them. An allocation far larger than any tensor of its call
site (an encoder convolution's activations are tens of MiB) is a
workspace that cuDNN asked the allocator for.

Then, with ``torch.backends.cudnn.benchmark`` off and then on: the peak
and the largest cuDNN workspace (an allocation made under a C++ frame
that names cuDNN) of one exported pair at 240x808 and of one fused VPS
frame (f32, full R-50, 375x1242 padded to 384x1248, tamed random
weights). Last, the narrow route in three memory layouts of the
encoders' convolutions (:func:`layout_effect`, B3).
"""

import sys

import numpy as np
import torch

from pvo_tpu_torch.scripts import bench_vo2_export
from pvo_tpu_torch.scripts.kbench import gpu_line, require_cuda
from pvo_tpu_torch.scripts.test_vo2 import export_pair, load_net


def largest_allocations(snapshot, top=8):
    """[(MiB, "file:line function <- ...")] of the largest allocations
    of an allocator snapshot, one entry per size and call site."""
    events = [e for trace in snapshot["device_traces"] for e in trace
              if e["action"] == "alloc"]
    seen, rows = set(), []
    for e in sorted(events, key=lambda e: -e["size"]):
        frames = [f for f in e.get("frames", [])
                  if "pvo_tpu_torch" in f["filename"]][:4]
        site = " <- ".join(f"{f['filename'].split('pvo_tpu_torch/')[-1]}:"
                           f"{f['line']} {f['name']}" for f in frames)
        if (e["size"], site) in seen:
            continue
        seen.add((e["size"], site))
        rows.append((e["size"] / 2 ** 20, site))
        if len(rows) == top:
            break
    return rows


def largest_cudnn_workspace(snapshot):
    """MiB of the largest allocation made under a frame naming cuDNN, or
    None when the snapshot has no such frame."""
    sizes = [e["size"] for trace in snapshot["device_traces"] for e in trace
             if e["action"] == "alloc" and any(
                 "cudnn" in f.get("name", "").lower()
                 for f in e.get("frames", []))]
    return max(sizes) / 2 ** 20 if sizes else None


def recorded(fn):
    """(peak GiB, largest cuDNN workspace MiB) of one call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=200000)
    fn()
    torch.cuda.synchronize()
    snapshot = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    return (torch.cuda.max_memory_allocated() / 2 ** 30,
            largest_cudnn_workspace(snapshot))


def cudnn_benchmark_effect(net):
    """B3: the export's narrow route and the VPS dense path, each with
    cuDNN's benchmark mode off and on (one warm-up call each first)."""
    from pvo_tpu_torch.scripts.benchmark_vps import tamed_model
    from pvo_tpu_torch.vps.panoptic_fpn import PanopticPredictor

    inputs = bench_vo2_export.bench_inputs((240, 808))
    pred = PanopticPredictor(tamed_model(0))
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (375, 1242, 3)).astype(np.uint8)
            for _ in range(2)]
    flow = torch.from_numpy(
        rng.uniform(-3, 3, (375, 1242, 2)).astype(np.float32)).cuda()
    depth = torch.from_numpy(
        rng.uniform(2, 20, (375, 1242)).astype(np.float32)).cuda()

    def vps_frame():
        pred._video_id = None
        pred(imgs[0], video_id="v")
        pred(imgs[1], video_id="v", flow=flow, depth=depth)

    runs = (("export 240x808", lambda: export_pair(net, *inputs, iters=15)),
            ("vps 384x1248 fused frame", vps_frame))
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for name, fn in runs:
            fn()
            peak, ws = recorded(fn)
            ws = "not identified" if ws is None else f"{ws:.1f} MiB"
            print(f"cudnn.benchmark={bench} {name}: peak {peak:.3f} GiB, "
                  f"largest cuDNN workspace {ws}", flush=True)
    torch.backends.cudnn.benchmark = False


# chip_smoke.py's tolerance for the export's outputs (EXPORT_TOL): max |d|
# of the 1/8-res flow and of the sampled disparity
LAYOUT_TOL = 1e-3


def layout_effect():
    """B3: the export's narrow route (240x808, 15 iterations, weights of
    ``tame_net(0, mask_bias=-2)``) with the encoders' convolutions in
    three memory layouts: their input the channels-last view of the NHWC
    images (the port before B3), NCHW-contiguous (the port since), and the
    view with the encoders' weights channels-last too. For each: the peak,
    the largest cuDNN workspace, and max |d| of the outputs against the
    contiguous layout."""
    from pvo_tpu_torch.scripts.bench_track import tame_net
    from pvo_tpu_torch.vo.net import extractor

    net = tame_net(0, mask_bias=-2.0).cuda().eval()
    inputs = bench_vo2_export.bench_inputs((240, 808))
    contiguous = extractor.conv_input

    def weights_channels_last():
        for enc in (net.fnet, net.cnet):
            enc.to(memory_format=torch.channels_last)

    variants = (("nchw_contiguous", contiguous, None),
                ("channels_last_view", extractor.nchw, None),
                ("channels_last_weights", extractor.nchw,
                 weights_channels_last))
    ref = None
    for tag, conv_input, change in variants:
        extractor.conv_input = conv_input
        if change is not None:
            change()
        try:
            run = lambda: export_pair(net, *inputs, iters=15)
            out = run()
            peak, ws = recorded(run)
        finally:
            extractor.conv_input = contiguous
        ref = ref or out
        err = max(float(np.abs(a - b).max()) for a, b in zip(out, ref))
        ws = "not identified" if ws is None else f"{ws:.1f} MiB"
        print(f"b3 layout={tag} peak {peak:.3f} GiB, largest cuDNN "
              f"workspace {ws}, max |d| against nchw_contiguous {err:.3g} "
              f"(tolerance {LAYOUT_TOL})", flush=True)


def main(argv=None):
    require_cuda()
    args = [int(v) for v in (sys.argv[1:] if argv is None else argv)]
    sizes = list(zip(args[::2], args[1::2])) or [(240, 808), (376, 1248)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = load_net(None, torch.device("cuda"))
    for size in sizes:
        inputs = bench_vo2_export.bench_inputs(size)
        export_pair(net, *inputs, iters=15)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(max_entries=200000)
        export_pair(net, *inputs, iters=15)
        torch.cuda.synchronize()
        snapshot = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        print(f"{size[0]}x{size[1]}: held before the pair "
              f"{before / 2 ** 30:.3f} GiB, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        for mib, site in largest_allocations(snapshot):
            print(f"  {mib:9.1f} MiB  {site}")
    cudnn_benchmark_effect(net)
    layout_effect()
    print(gpu_line())


if __name__ == "__main__":
    main()
