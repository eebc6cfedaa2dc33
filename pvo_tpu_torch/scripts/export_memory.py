"""Where the flow/depth export's peak memory comes from on the card.

    python -m pvo_tpu_torch.scripts.export_memory [H W ...]

For each image size (default 240x808, the narrow corr route, and
376x1248, the wide one): one warm-up pair, then one pair of
``test_vo2.export_pair`` (15 iterations, f32, random weights) with
PyTorch's allocator history recording; prints the memory held before the
pair, its peak, and the largest allocations with the port's call sites
that made them. An allocation far larger than any tensor of its call
site (an encoder convolution's activations are tens of MiB) is a
workspace that cuDNN asked the allocator for.
"""

import sys

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
    print(gpu_line())


if __name__ == "__main__":
    main()
