"""Fused VPS inference + tracking + matching + VPQ (port of
``scripts/test_vps.py``; the reference's tools/test_vps.sh stages 1-4 in
one script).

    python -m pvo_tpu_torch.scripts.test_vps --datapath <Virtual_KITTI2 root> \
        --scene Scene02 [--shared_data shared_data] [--view clone] \
        [--weights panFPN.pth] [--tiny] [--scale 0.25] [--device cpu]

Per scene: Panoptic FPN with flow-guided fusion over the clone 5:1:1
validation frames (flow from ``<shared_data>/full_flow/<scene>_<frame>.npy``),
instance ids propagated (tracking + matching), the relabelled maps written
to ``<shared_data>/panoptic_segm_fusion/inference/pan_seg/<scene>_<frame>.png``,
and, where ``panoptic_gt_id`` PNGs exist, VPQ over windows {1, 5, 10, 15,
20} printed as one JSON line and written to
``<shared_data>/vpq/<scene>/vpq-final.txt``. Runs on the card;
``--device cpu`` asks for the CPU.
"""

import argparse
import glob
import json
import os
import os.path as osp

import numpy as np

from pvo_tpu_torch.pipeline.matching import InstanceMatcher
from pvo_tpu_torch.pipeline.pq import vkitti_categories, vpq_compute
from pvo_tpu_torch.pipeline.tracking import forward_splat_ids
from pvo_tpu_torch.scripts.initial_segmentation import load_model, read_image
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.utils.io import id2rgb, rgb2id
from pvo_tpu_torch.vps.panoptic_fpn import PanopticPredictor


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True)
    p.add_argument("--scene", required=True)
    p.add_argument("--weights", default=None,
                   help="a detectron2 Panoptic FPN checkpoint")
    p.add_argument("--shared_data", default="shared_data")
    p.add_argument("--view", default="clone")
    p.add_argument("--use_depth", action="store_true",
                   help="not modelled: the JAX CLI takes the flag and reads "
                        "no depth, and the export's depth files hold "
                        "disparity; refused")
    p.add_argument("--tiny", action="store_true",
                   help="1-block backbone (CI on CPU)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="downscale factor for inference images")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.use_depth:
        p.error("--use_depth is not modelled (scripts/test_vps.py reads no "
                "depth either)")
    return args


def gt_segments(gt_maps):
    segs = []
    for g in gt_maps:
        frame = []
        for sid, area in zip(*np.unique(g, return_counts=True)):
            if sid == 0:
                continue
            frame.append({"id": int(sid), "category_id": int(sid // 10000),
                          "area": int(area), "iscrowd": 0})
        segs.append(frame)
    return segs


def pred_segments(maps):
    return [[{"id": int(sid), "category_id": int(sid // 10000)}
             for sid in np.unique(m) if sid != 0] for m in maps]


def main(argv=None):
    args = parse_args(argv)
    device = open_device(args.device)
    from PIL import Image

    base = osp.join(args.datapath, args.scene, args.view)
    imgs = sorted(glob.glob(osp.join(base, "frames/rgb/Camera_0/*.jpg")))
    # 5:1:1 validation slice (reference vkitti2.py foo split)
    n = len(imgs)
    val_n = n // 7
    train_n = n - 2 * val_n
    imgs = imgs[train_n:train_n + val_n]

    flow_dir = osp.join(args.shared_data, "full_flow")
    scene = args.scene
    out_dir = osp.join(args.shared_data, "panoptic_segm_fusion",
                       "inference", "pan_seg")
    os.makedirs(out_dir, exist_ok=True)

    predictor = None
    matcher = InstanceMatcher()
    final_maps = []
    prev_raw = None
    for k, f in enumerate(imgs):
        img = read_image(f, args.scale)
        if predictor is None:
            predictor = PanopticPredictor(load_model(args.weights, args.tiny),
                                          device=device)
        name = osp.basename(f).split(".")[0]
        flow = None
        fp = osp.join(flow_dir, f"{scene}_{name}.npy")
        if k > 0 and osp.exists(fp):
            flow = np.load(fp)
            if args.scale != 1.0:
                import cv2
                flow = cv2.resize(flow, img.shape[:2][::-1]) * args.scale
        pan, _, _, _ = predictor(img, video_id=scene, flow=flow)

        # id propagation: warp the previous fused map, match
        if prev_raw is None or flow is None:
            matcher.reset()
            final = matcher(pan, np.zeros_like(pan))
        else:
            final = matcher(pan, forward_splat_ids(prev_raw, flow))
        prev_raw = pan
        final_maps.append(final)
        Image.fromarray(id2rgb(final)).save(
            osp.join(out_dir, f"{scene}_{name}.png"))

    # ---- VPQ against GT ----
    gts = sorted(glob.glob(osp.join(base, "panoptic_gt_id", "*.png")))
    if not gts:
        print("no GT panoptic maps found; wrote predictions only")
        return
    gts = gts[train_n:train_n + val_n]
    gt_maps = [rgb2id(np.array(Image.open(g))) for g in gts]
    if args.scale != 1.0:
        # predictions were made at reduced scale; match GT size with
        # nearest-neighbour id-preserving upsampling
        import cv2
        gh, gw = gt_maps[0].shape
        final_maps = [cv2.resize(m, (gw, gh),
                                 interpolation=cv2.INTER_NEAREST)
                      for m in final_maps]
    avg, _ = vpq_compute(gt_maps, final_maps, gt_segments(gt_maps),
                         pred_segments(final_maps), vkitti_categories())
    out = {"scene": scene,
           "vpq_all": avg["All"]["pq"] * 100,
           "vpq_thing": avg["Things"]["pq"] * 100,
           "vpq_stuff": avg["Stuff"]["pq"] * 100}
    print(json.dumps(out))
    vdir = osp.join(args.shared_data, "vpq", scene)
    os.makedirs(vdir, exist_ok=True)
    with open(osp.join(vdir, "vpq-final.txt"), "w") as fh:
        json.dump(out, fh)


if __name__ == "__main__":
    main()
