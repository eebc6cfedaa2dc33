"""Initial (fusion-free) panoptic segmentation over vkitti scenes (port of
``scripts/initial_segmentation.py``).

    python -m pvo_tpu_torch.scripts.initial_segmentation \
        --datapath <Virtual_KITTI2 root> [--weights panFPN.pth] \
        [--scenes Scene01 ...] [--views clone 15-deg-left] [--tiny] \
        [--scale 0.25] [--device cpu]

Runs Panoptic FPN in plain mode over each view's frames and writes
``<datapath>/<scene>/<view>/panFPN_segm/<frame>.png`` (the panoptic ids
as id2rgb PNGs) for the VO segment filter. ``--tiny`` is the 1-block
backbone; without ``--weights`` the weights are random from seed 0. Runs
on the card; ``--device cpu`` asks for the CPU.
"""

import argparse
import glob
import os
import os.path as osp

from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.utils.io import id2rgb
from pvo_tpu_torch.vps.panoptic_fpn import (PanopticFPN, PanopticPredictor,
                                            init_weights)


def load_model(weights, tiny=False, seed=0):
    """The checkpoint's model, or random weights from ``seed``."""
    if weights:
        from pvo_tpu_torch.utils.convert_vps import load_panoptic_fpn_torch
        return load_panoptic_fpn_torch(weights)
    blocks = (1, 1, 1, 1) if tiny else (3, 4, 6, 3)
    return init_weights(PanopticFPN(backbone_blocks=blocks), seed)


def read_image(path, scale):
    """A frame as BGR uint8 (detectron2's input order), resized by
    ``scale``."""
    import cv2
    img = cv2.imread(path)
    if scale != 1.0:
        img = cv2.resize(img, None, fx=scale, fy=scale)
    return img


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True,
                   help="Virtual_KITTI2 root")
    p.add_argument("--weights", default=None,
                   help="a detectron2 Panoptic FPN checkpoint")
    p.add_argument("--scenes", nargs="+",
                   default=["Scene01", "Scene02", "Scene06", "Scene18",
                            "Scene20"])
    p.add_argument("--views", nargs="+",
                   default=["clone", "15-deg-left"])
    p.add_argument("--tiny", action="store_true",
                   help="1-block backbone (CI on CPU)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="downscale factor for inference images")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = open_device(args.device)
    from PIL import Image

    predictor = None
    for scene in args.scenes:
        for view in args.views:
            imgs = sorted(glob.glob(osp.join(
                args.datapath, scene, view, "frames/rgb/Camera_0/*.jpg")))
            if not imgs:
                continue
            out_dir = osp.join(args.datapath, scene, view, "panFPN_segm")
            os.makedirs(out_dir, exist_ok=True)
            for f in imgs:
                img = read_image(f, args.scale)
                if predictor is None:
                    predictor = PanopticPredictor(
                        load_model(args.weights, args.tiny), device=device)
                pan, _, _, _ = predictor(img)
                name = osp.basename(f).replace(".jpg", ".png")
                Image.fromarray(id2rgb(pan)).save(osp.join(out_dir, name))
            print(f"{scene}/{view}: {len(imgs)} frames", flush=True)


if __name__ == "__main__":
    main()
