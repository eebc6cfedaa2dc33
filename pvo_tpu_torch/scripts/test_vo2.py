"""VO flow/depth export (port of ``scripts/test_vo2.py``): run DroidNet
directly on consecutive frame pairs at 376x1248 with ground-truth poses,
15 iterations, and save per-frame full flow (.npy, resized to 375x1242)
and 1/8-res disparity (.npy) into shared_data/ for the VPS fusion stage.

    python -m pvo_tpu_torch.scripts.test_vo2 --datapath <scene dir> \
        [--weights droid.pth] [--device cpu]

Writes ``<shared_data>/full_flow/<scene>_<name>.npy`` (FH, FW, 2) f32
and ``<shared_data>/depth/<scene>_<name>.npy`` (h, w) f32 for every
frame but the last. Runs on the card; ``--device cpu`` asks for the CPU.
:func:`export_pair` is the per-pair work, shared with
``bench_vo2_export`` and the smoke run; only the CLI's file reading and
its final resize need ``cv2``.
"""

import argparse
import glob
import os
import os.path as osp

import numpy as np
import torch

from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.utils.io import VKITTI_INTRINSICS, vkitti_poses_tq
from pvo_tpu_torch.vo.net.droidnet import DroidNet

# the 2-frame window's graph: edge 0 is frame 0 -> frame 1
PAIR_II = np.array([0, 1])
PAIR_JJ = np.array([1, 0])


@torch.no_grad()
def export_pair(net, images_u8, poses, intr8, iters=15, corr_impl="cuda",
                compute_dtype=None):
    """One exported pair on ``net``'s device.

    images_u8: (2, H, W, 3) uint8 RGB; poses: (2, 7) w2c; intr8: (4,) or
    (2, 4) intrinsics at 1/8 resolution (arrays or tensors). Runs the
    forward from unit disparities with both poses fixed and returns numpy
    ``(flow8, disp)``: the 1/8-res flow of edge 0 -> 1, (h, w, 2) f32 in
    1/8-res pixels, and frame 0's upsampled disparity sampled at
    ``[3::8, 3::8]``, (h, w) f32. Both are sliced on the device and read
    back with one copy each.
    """
    dev = next(net.parameters()).device
    images = torch.as_tensor(images_u8, dtype=torch.uint8).to(dev)[None]
    H, W = images.shape[2:4]
    poses = torch.as_tensor(poses, dtype=torch.float32).to(dev)[None]
    intr8 = torch.as_tensor(intr8, dtype=torch.float32).to(dev)
    intr8 = intr8.expand(2, 4)[None]
    disps = torch.ones((1, 2, H // 8, W // 8), device=dev)
    out = net(poses, images, disps, intr8, PAIR_II, PAIR_JJ,
              num_steps=iters, ret_flow=True, downsample=True,
              final_only=True, corr_impl=corr_impl,
              compute_dtype=compute_dtype)
    flow8 = out["flows"][-1][0, 0]
    disp = out["disps_up"][-1][0, 0, 3::8, 3::8]
    return flow8.float().cpu().numpy(), disp.float().cpu().numpy()


def full_flow(flow8, net_size, flow_size):
    """The exported flow: 1/8-res flow (h, w, 2) -> (FH, FW, 2) f32 in
    output pixels (x8 to network pixels, resized, rescaled by the resize
    ratio)."""
    import cv2

    (H, W), (FH, FW) = net_size, flow_size
    flow = cv2.resize(flow8 * 8.0, (FW, FH))
    flow *= np.array([FW / W, FH / H], np.float32)
    return flow


def load_net(weights, device, seed=0):
    """The checkpoint's weights, or random ones from ``seed``."""
    if weights:
        from pvo_tpu_torch.utils.convert import load_droidnet_torch
        net = load_droidnet_torch(weights)
    else:
        net = DroidNet.from_seed(seed)
    return net.to(device).eval()


def read_pair(files, size):
    """Two image files -> ((2, H, W, 3) uint8 RGB, (h0, w0) on disk)."""
    import cv2

    H, W = size
    pair = []
    for f in files:
        img = cv2.imread(f)
        h0, w0 = img.shape[:2]
        img = cv2.resize(img, (W, H))
        pair.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    return np.stack(pair), (h0, w0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--mode", default="val")
    p.add_argument("--iters", type=int, default=15)
    p.add_argument("--shared_data", default="shared_data")
    p.add_argument("--image_size", type=int, nargs=2,
                   default=[376, 1248],
                   help="network input size (reference test_vo2 "
                        "geometry is 376x1248)")
    p.add_argument("--flow_size", type=int, nargs=2,
                   default=[375, 1242],
                   help="full-flow .npy output size (vkitti native)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)

    device = open_device(args.device)
    split = {"train": "clone", "val": "15-deg-left",
             "test": "30-deg-right"}[args.mode]
    base = osp.join(args.datapath, split)
    images = sorted(glob.glob(osp.join(base,
                                       "frames/rgb/Camera_0/*.jpg")))
    poses = vkitti_poses_tq(osp.join(base, "extrinsic.txt"))
    net = load_net(args.weights, device)

    H, W = args.image_size
    scene = args.datapath.rstrip("/").rsplit("/")[-1]
    flow_dir = osp.join(args.shared_data, "full_flow")
    depth_dir = osp.join(args.shared_data, "depth")
    os.makedirs(flow_dir, exist_ok=True)
    os.makedirs(depth_dir, exist_ok=True)

    for t in range(len(images) - 1):
        imgs, (h0, w0) = read_pair(images[t:t + 2], (H, W))
        sx, sy = W / w0, H / h0
        intr8 = VKITTI_INTRINSICS * np.array([sx, sy, sx, sy],
                                             np.float32) / 8.0
        flow8, disp = export_pair(net, imgs, poses[t:t + 2], intr8,
                                  iters=args.iters)
        name = osp.basename(images[t]).split(".")[0]
        np.save(osp.join(flow_dir, f"{scene}_{name}.npy"),
                full_flow(flow8, (H, W), args.flow_size))
        np.save(osp.join(depth_dir, f"{scene}_{name}.npy"), disp)
        if t % 50 == 0:
            print(f"{scene} frame {t}/{len(images) - 1}")


if __name__ == "__main__":
    main()
