"""Result visualization CLI (port of ``scripts/visualize_results.py``;
reference VPS_Module/tools/visualize_json_results.py + VO_Module offline
vis tools): render panoptic segmentations, flow fields and depth maps
as overlay PNGs for qualitative inspection. Plain numpy and cv2.

    python -m pvo_tpu_torch.scripts.visualize_results --images <dir> \
        [--pan_seg <dir of id2rgb PNGs>] [--flow <dir of .npy>] \
        [--depth <dir of .npy>] [--out vis_out] [--limit 50]

One PNG a frame: the image, then under it each overlay that has a file
of the frame's name.
"""

import argparse
import glob
import os
import os.path as osp

import numpy as np


def _color_for_id(seg_id):
    rng = np.random.RandomState(seg_id % (2 ** 31))
    return rng.randint(60, 255, 3).astype(np.uint8)


def overlay_panoptic(img, pan_ids, alpha=0.55):
    """img (H,W,3) uint8 RGB; pan_ids (H,W) int (cat*10000+inst)."""
    out = img.astype(np.float32).copy()
    color = np.zeros_like(img)
    for sid in np.unique(pan_ids):
        if sid == 0:
            continue
        color[pan_ids == sid] = _color_for_id(int(sid))
    m = (pan_ids > 0)[..., None]
    out = np.where(m, (1 - alpha) * out + alpha * color, out)
    return out.astype(np.uint8)


def depth_to_color(disp):
    """1/8-res disparity -> turbo-ish colormap image."""
    import cv2
    d = np.asarray(disp, np.float32)
    lo, hi = np.percentile(d, 2), np.percentile(d, 98)
    dn = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
    return cv2.applyColorMap((dn * 255).astype(np.uint8),
                             cv2.COLORMAP_TURBO)[:, :, ::-1]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--images", required=True,
                   help="dir with input RGB frames")
    p.add_argument("--pan_seg", default=None,
                   help="dir with id2rgb pan_seg PNGs")
    p.add_argument("--flow", default=None,
                   help="dir with full_flow .npy files")
    p.add_argument("--depth", default=None,
                   help="dir with depth .npy files")
    p.add_argument("--out", default="vis_out")
    p.add_argument("--limit", type=int, default=50)
    args = p.parse_args(argv)

    import cv2

    from pvo_tpu_torch.utils.flow_vis import flow_to_image
    from pvo_tpu_torch.utils.io import rgb2id

    os.makedirs(args.out, exist_ok=True)
    imgs = sorted(glob.glob(osp.join(args.images, "*.jpg")) +
                  glob.glob(osp.join(args.images, "*.png")))
    for path in imgs[:args.limit]:
        name = osp.splitext(osp.basename(path))[0]
        img = cv2.imread(path)[:, :, ::-1]
        panels = [img]

        if args.pan_seg:
            pp = osp.join(args.pan_seg, name + ".png")
            if osp.exists(pp):
                ids = rgb2id(cv2.imread(pp)[:, :, ::-1])
                if ids.shape != img.shape[:2]:
                    ids = cv2.resize(
                        ids.astype(np.int32),
                        (img.shape[1], img.shape[0]),
                        interpolation=cv2.INTER_NEAREST)
                panels.append(overlay_panoptic(img, ids))

        if args.flow:
            fp = osp.join(args.flow, name + ".npy")
            if osp.exists(fp):
                fl = flow_to_image(np.load(fp))
                if fl.shape[:2] != img.shape[:2]:
                    fl = cv2.resize(fl, (img.shape[1], img.shape[0]))
                panels.append(fl)

        if args.depth:
            dp = osp.join(args.depth, name + ".npy")
            if osp.exists(dp):
                dc = depth_to_color(np.load(dp))
                dc = cv2.resize(dc, (img.shape[1], img.shape[0]),
                                interpolation=cv2.INTER_NEAREST)
                panels.append(dc)

        grid = np.concatenate(panels, axis=0)
        cv2.imwrite(osp.join(args.out, name + ".png"),
                    grid[:, :, ::-1])
    print(f"wrote {min(len(imgs), args.limit)} panels to {args.out}")


if __name__ == "__main__":
    main()
