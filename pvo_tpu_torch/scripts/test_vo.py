"""VO pose evaluation on Virtual KITTI 2 (port of ``scripts/test_vo.py``).

Streams a scene's 15-deg-left images (resized to 240x808) with the
initial panoptic segmentation, runs the VO system, fills non-keyframe
poses, writes shared_data/traj/<scene>/15-deg-left/pvo_traj.txt, and
reports ATE-RMSE against extrinsic.txt with Sim3 alignment.

    python -m pvo_tpu_torch.scripts.test_vo --datapath <scene dir> \
        [--weights droid.pth] [--segm_filter] [--device cpu]

Runs on the card; ``--device cpu`` asks for the CPU.
"""

import argparse
import glob
import os
import os.path as osp

import numpy as np
import torch


def image_stream(datapath, image_size=(240, 808), mode="val",
                 segm_filter=False):
    """Yield (t, image RGB u8, intrinsics, segm_ids)."""
    import cv2
    from PIL import Image

    from pvo_tpu_torch.utils.io import VKITTI_INTRINSICS, rgb2id

    split = {"train": "clone", "val": "15-deg-left",
             "test": "30-deg-right"}[mode]
    images = sorted(glob.glob(osp.join(
        datapath, split, "frames/rgb/Camera_0/*.jpg")))
    segs = sorted(glob.glob(osp.join(datapath, split,
                                     "panFPN_segm/*.png")))
    h1, w1 = image_size
    for t, f in enumerate(images):
        img = cv2.imread(f)
        h0, w0 = img.shape[:2]
        img = cv2.resize(img, (w1, h1))
        img = img[: h1 - h1 % 8, : w1 - w1 % 8]
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

        segm = None
        if segm_filter and t < len(segs):
            s = rgb2id(np.array(Image.open(segs[t]))).astype(np.float32)
            s = cv2.resize(s, (w1, h1), interpolation=cv2.INTER_NEAREST)
            segm = s[3::8, 3::8].astype(np.int32)

        intr = VKITTI_INTRINSICS.copy()
        intr[0:2] *= w1 / w0
        intr[2:4] *= h1 / h0
        yield t, img, intr, segm


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--buffer", type=int, default=512)
    p.add_argument("--segm_filter", action="store_true")
    p.add_argument("--thresh", type=float, default=0.8)
    p.add_argument("--filter_thresh", type=float, default=1.75)
    p.add_argument("--warmup", type=int, default=12)
    p.add_argument("--keyframe_thresh", type=float, default=2.25)
    p.add_argument("--frontend_thresh", type=float, default=12.0)
    p.add_argument("--frontend_window", type=int, default=25)
    p.add_argument("--frontend_radius", type=int, default=2)
    p.add_argument("--frontend_nms", type=int, default=1)
    p.add_argument("--backend_thresh", type=float, default=15.0)
    p.add_argument("--backend_radius", type=int, default=2)
    p.add_argument("--backend_nms", type=int, default=3)
    p.add_argument("--beta", type=float, default=0.6)
    p.add_argument("--shared_data", default="shared_data")
    p.add_argument("--image_size", type=int, nargs=2,
                   default=[240, 808],
                   help="processing size (H W); reference protocol "
                        "is 240x808")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    # Scene20 uses a stricter dynamic threshold (reference protocol)
    if args.datapath.rstrip("/").endswith("20"):
        args.thresh = 0.9

    from pvo_tpu_torch.lie import se3
    from pvo_tpu_torch.utils.ate import ate_stats
    from pvo_tpu_torch.utils.config import VOConfig
    from pvo_tpu_torch.utils.io import (load_vkitti_extrinsics,
                                        write_kitti_poses)
    from pvo_tpu_torch.vo.system import VOSystem

    cfg = VOConfig(
        image_size=tuple(args.image_size),
        buffer=args.buffer, segm_filter=args.segm_filter,
        thresh=args.thresh, filter_thresh=args.filter_thresh,
        warmup=args.warmup, keyframe_thresh=args.keyframe_thresh,
        frontend_thresh=args.frontend_thresh,
        frontend_window=args.frontend_window,
        frontend_radius=args.frontend_radius,
        frontend_nms=args.frontend_nms,
        backend_thresh=args.backend_thresh,
        backend_radius=args.backend_radius,
        backend_nms=args.backend_nms, beta=args.beta)

    sysm = VOSystem(cfg, weights_path=args.weights, device=args.device)

    for (t, img, intr, segm) in image_stream(
            args.datapath, cfg.image_size, "val", args.segm_filter):
        sysm.track(t, img, intr, segments=segm)

    print("keyframes:", sysm.video.counter)
    traj = sysm.terminate(image_stream(
        args.datapath, cfg.image_size, "val", args.segm_filter),
        need_inv=True)

    # ground truth: c2w positions from w2c extrinsics
    gt_w2c = load_vkitti_extrinsics(
        osp.join(args.datapath, "15-deg-left/extrinsic.txt"))
    gt_c2w = np.linalg.inv(gt_w2c)

    est_mat = se3.matrix(torch.from_numpy(traj)).numpy()

    scene = args.datapath.rstrip("/").rsplit("/")[-1]
    out_dir = osp.join(args.shared_data, "traj", scene, "15-deg-left")
    os.makedirs(out_dir, exist_ok=True)
    write_kitti_poses(osp.join(out_dir, "pvo_traj.txt"), est_mat)

    n = min(len(est_mat), len(gt_c2w))
    stats = ate_stats(est_mat[:n, :3, 3], gt_c2w[:n, :3, 3])
    print({k: round(v, 4) for k, v in stats.items()})


if __name__ == "__main__":
    main()
