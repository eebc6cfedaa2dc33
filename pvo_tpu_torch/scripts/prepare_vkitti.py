"""Virtual KITTI 2 dataset preparation (port of
``scripts/prepare_vkitti.py``; reference tools/datasets/
1_generate_image_info.py + 2_generate_json.py + CATEGORY.py).

    python -m pvo_tpu_torch.scripts.prepare_vkitti --datapath <root> \
        [--scenes Scene02 ...] [--views clone 15-deg-left] \
        [--dynamic_masks] [--device cpu]

From the raw vkitti classSegmentation / instanceSegmentation PNGs,
produce per scene+view:
  * panoptic_gt_id/  — id2rgb PNGs with the cat*10000+instance scheme
  * stuff_labelTrainIds/ — semantic trainId maps
  * panoptic_gt.json — COCO-panoptic-style annotations
  * split_511.json   — the 5:1:1 train/val/test frame split
and with ``--dynamic_masks`` frames/dynamicMask/Camera_0/dymask_*.npy.
The masks' camera-induced flow runs on the card; ``--device cpu`` asks
for the CPU.
"""

import argparse
import glob
import json
import os
import os.path as osp

import numpy as np
import torch

from pvo_tpu_torch.utils.device import open_device

# vkitti class colors -> our trainIds (reference CATEGORY.py)
CLASS_COLORS = {
    (210, 0, 200): 1,    # Terrain
    (90, 200, 255): 2,   # Sky
    (0, 199, 0): 3,      # Tree
    (90, 240, 0): 4,     # Vegetation
    (140, 140, 140): 5,  # Building
    (100, 60, 100): 6,   # Road
    (250, 100, 255): 7,  # GuardRail
    (255, 255, 0): 8,    # TrafficSign
    (200, 200, 0): 9,    # TrafficLight
    (255, 130, 0): 10,   # Pole
    (80, 80, 80): 11,    # Misc
    (160, 60, 60): 12,   # Truck
    (255, 127, 80): 13,  # Car
    (0, 139, 139): 14,   # Van
}
THING_IDS = {12, 13, 14}


def class_map_from_colors(img):
    out = np.zeros(img.shape[:2], np.int32)
    for color, tid in CLASS_COLORS.items():
        m = np.all(img == np.asarray(color), axis=-1)
        out[m] = tid
    return out


def build_panoptic_id(class_map, instance_map):
    """cat*10000 (+ instance id + 1 for things)."""
    pan = class_map.astype(np.int64) * 10000
    thing = np.isin(class_map, list(THING_IDS))
    pan = np.where(thing, pan + instance_map.astype(np.int64) + 1, pan)
    pan[class_map == 0] = 0
    return pan


def prepare_view(base, out_base=None):
    import cv2
    from PIL import Image

    from pvo_tpu_torch.pipeline.preparing import segments_info_from_map
    from pvo_tpu_torch.utils.io import id2rgb

    out_base = out_base or base
    cls_files = sorted(glob.glob(osp.join(
        base, "frames/classSegmentation/Camera_0/*.png")))
    inst_files = sorted(glob.glob(osp.join(
        base, "frames/instanceSegmentation/Camera_0/*.png")))
    if not cls_files:
        return 0

    pan_dir = osp.join(out_base, "panoptic_gt_id")
    sem_dir = osp.join(out_base, "stuff_labelTrainIds")
    os.makedirs(pan_dir, exist_ok=True)
    os.makedirs(sem_dir, exist_ok=True)

    images, annotations = [], []
    for k, cf in enumerate(cls_files):
        cimg = cv2.cvtColor(cv2.imread(cf), cv2.COLOR_BGR2RGB)
        cmap = class_map_from_colors(cimg)
        if k < len(inst_files):
            iimg = cv2.imread(inst_files[k], cv2.IMREAD_ANYDEPTH |
                              cv2.IMREAD_ANYCOLOR)
            if iimg is None:
                iimg = np.zeros(cmap.shape, np.int32)
            elif iimg.ndim == 3:
                iimg = iimg[..., 0].astype(np.int32)
        else:
            iimg = np.zeros(cmap.shape, np.int32)

        pan = build_panoptic_id(cmap, iimg)
        name = osp.basename(cf).replace("classgt_", "pan_")
        Image.fromarray(id2rgb(pan)).save(osp.join(pan_dir, name))
        Image.fromarray(cmap.astype(np.uint8)).save(
            osp.join(sem_dir, name))

        h, w = pan.shape
        images.append({"id": k, "file_name": name,
                       "height": h, "width": w})
        annotations.append({"image_id": k, "file_name": name,
                            "segments_info": segments_info_from_map(pan)})

    with open(osp.join(out_base, "panoptic_gt.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)

    # 5:1:1 split (reference vkitti2.py foo slice)
    n = len(cls_files)
    val_n = n // 7
    train_n = n - 2 * val_n
    with open(osp.join(out_base, "split_511.json"), "w") as f:
        json.dump({
            "train": list(range(0, train_n)),
            "val": list(range(train_n, train_n + val_n)),
            "test": list(range(train_n + val_n, n)),
        }, f)
    return len(cls_files)


def generate_dynamic_masks(base, thresh=0.5, device="cuda"):
    """GT dynamic masks from flow/pose consistency (reference
    tools/datasets/generate_dynamic_masks.py): static where the GT flow
    agrees with the camera-induced flow (f32, as the JAX tool computes
    it)."""
    import cv2

    from pvo_tpu_torch.geom import projective
    from pvo_tpu_torch.utils.io import (VKITTI_INTRINSICS,
                                        decode_vkitti_depth,
                                        decode_vkitti_flow, vkitti_poses_tq)

    dev = open_device(device)
    flows = sorted(glob.glob(osp.join(
        base, "frames/forwardFlow/Camera_0/*.png")))
    depths = sorted(glob.glob(osp.join(
        base, "frames/depth/Camera_0/*.png")))
    if not flows:
        return 0
    poses = torch.as_tensor(vkitti_poses_tq(osp.join(base, "extrinsic.txt")),
                            device=dev)
    intr = torch.as_tensor(VKITTI_INTRINSICS, device=dev).expand(1, 2, 4)
    out_dir = osp.join(base, "frames/dynamicMask/Camera_0")
    os.makedirs(out_dir, exist_ok=True)

    for k in range(len(flows)):
        raw = cv2.imread(flows[k], cv2.IMREAD_ANYCOLOR |
                         cv2.IMREAD_ANYDEPTH)
        gt_flow, gt_val = decode_vkitti_flow(raw)
        depth = decode_vkitti_depth(cv2.imread(
            depths[k], cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH))
        disp = torch.as_tensor(1.0 / np.maximum(depth, 1e-3),
                               dtype=torch.float32, device=dev)

        # the last frame has no successor: its index is clamped, as the
        # JAX tool's gather clamps it, so its camera flow is zero
        pair = poses[[k, min(k + 1, len(poses) - 1)]]
        cam_flow, valid = projective.induced_flow(
            pair[None], disp[None, None].repeat(1, 2, 1, 1), intr, [0], [1])
        d = np.linalg.norm(cam_flow[0, 0].cpu().numpy() - gt_flow, axis=-1)
        static = (d <= thresh).astype(np.float32)
        val = (gt_val * valid[0, 0, :, :, 0].cpu().numpy()).astype(
            np.float32)
        np.save(osp.join(out_dir, f"dymask_{k:05d}.npy"),
                np.stack([static, val], axis=-1))
    return len(flows)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True)
    p.add_argument("--scenes", nargs="+",
                   default=["Scene01", "Scene02", "Scene06",
                            "Scene18", "Scene20"])
    p.add_argument("--views", nargs="+",
                   default=["clone", "15-deg-left"])
    p.add_argument("--dynamic_masks", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    open_device(args.device)

    for scene in args.scenes:
        for view in args.views:
            base = osp.join(args.datapath, scene, view)
            n = prepare_view(base)
            print(f"{scene}/{view}: {n} frames prepared")
            if args.dynamic_masks:
                m = generate_dynamic_masks(base, device=args.device)
                print(f"{scene}/{view}: {m} dynamic masks")


if __name__ == "__main__":
    main()
