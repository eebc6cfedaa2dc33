"""Sweep of the random VO weights for the PVO loop's tracking stage.

    python -m pvo_tpu_torch.scripts.loop_weights [--frames 36]
        [--cases 0.1,-2 0.2,-2 ...] [--device cpu]

The loop driver passes ``test_vo`` no thresholds, so it tracks at
``VOConfig``'s (motion filter 1.75, keyframe removal 2.25). With random
weights the flow head decides both: scaled too far down
(``bench_track.tame_net``'s 0.01) the motion filter admits almost no
frame, unscaled the tracker diverges. For each (head scale, mask bias)
case this writes checkpoints of ``tame_net(0, scale, bias)`` and runs the
``test_vo`` CLI at the loop's full-size flags on a synthetic scene
(initial segmentation of ``15-deg-left`` first, as the loop runs it),
printing one line a case: keyframes admitted and removed, the backend's
edges per call (K3 on bf16 features only beyond 256), the corr kernels'
launches, whether the trajectory is finite, seconds. Runs on the card;
``--device cpu`` asks for the CPU.
"""

import argparse
import os.path as osp
import tempfile
import time

import numpy as np
import torch

from pvo_tpu_torch.data.synth_scene import write_synth_scene
from pvo_tpu_torch.scripts import initial_segmentation, prepare_vkitti, test_vo
from pvo_tpu_torch.scripts.bench_track import tame_net, vo_counters
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vo.net import cuda_corr

CASES = ((0.1, -2.0), (0.12, -2.0), (0.15, -2.0), (0.15, 0.0), (0.2, -2.0),
         (0.3, -2.0))


def run_case(root, scene, scale, bias, device):
    ckpt = osp.join(root, "droid.pth")
    net = tame_net(0, scale=scale, mask_bias=bias)
    torch.save({f"module.{k}": v for k, v in net.state_dict().items()}, ckpt)
    removed, edges, keyframes = [], [], []
    cuda_corr.reset_launches()
    t0 = time.perf_counter()
    with vo_counters(removed, edges, keyframes):
        test_vo.main(["--datapath", scene, "--segm_filter", "--shared_data",
                      osp.join(root, "shared_data"), "--image_size", "240",
                      "808", "--weights", ckpt, "--device", device])
    traj = np.loadtxt(osp.join(root, "shared_data", "traj", "Scene02",
                               "15-deg-left", "pvo_traj.txt"))
    return dict(scale=scale, mask_bias=bias,
                admitted=keyframes[0] + len(removed), removed=len(removed),
                keyframes=keyframes[0], backend_edges=edges, launches=dict(cuda_corr.LAUNCHES),
                f32_launches=dict(cuda_corr.F32_LAUNCHES),
                finite=bool(np.isfinite(traj).all()),
                seconds=round(time.perf_counter() - t0, 2))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--cases", nargs="+", default=None,
                   help="scale,bias pairs (default: CASES)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    open_device(args.device)
    cases = CASES if args.cases is None else \
        [tuple(float(x) for x in c.split(",")) for c in args.cases]
    with tempfile.TemporaryDirectory() as root:
        data = osp.join(root, "vkitti")
        write_synth_scene(data, n_frames=args.frames, workers=8)
        prepare_vkitti.main(["--datapath", data, "--scenes", "Scene02",
                             "--device", args.device])
        initial_segmentation.main(["--datapath", data, "--scenes", "Scene02",
                                   "--views", "15-deg-left", "--device",
                                   args.device])
        for scale, bias in cases:
            try:
                print("case", run_case(root, osp.join(data, "Scene02"),
                                       scale, bias, args.device), flush=True)
            except (ValueError, RuntimeError) as e:
                # a case whose motion filter admits too few frames to
                # initialize has no edges for the backend
                print("case", dict(scale=scale, mask_bias=bias,
                                   failed=repr(e)[:200]), flush=True)


if __name__ == "__main__":
    main()
