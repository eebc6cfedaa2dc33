"""Offline reconstruction export (port of
``scripts/export_reconstruction.py``; reference tools/vis.py, vis_2.py,
vis_ori.py, generate_demo.py).

    python -m pvo_tpu_torch.scripts.export_reconstruction \
        --datapath <vkitti2 scene dir> [--weights droid.pth] [--out viz] \
        [--max_frames 100] [--segm_filter] [--device cpu]

Tracks the scene's 15-deg-left images (``test_vo.image_stream``),
terminates with one global BA pass, and writes into ``--out`` the
filtered point cloud and keyframe trajectory
(:func:`pvo_tpu_torch.vo.visualization.droid_visualization`), six
inverse-depth maps ``depth_<k>.png`` (magma colour map over each map's
range) and six flow images ``flow_<k>.png`` of the video's ``full_flow``
x 8 (:func:`pvo_tpu_torch.utils.flow_vis.flow_to_image`). Runs on the
card unless ``--device cpu``.
"""

import argparse
import os
import os.path as osp

import numpy as np


def depth_image(inv_depth):
    """1 / max(depth, 1e-3) of an inverse-depth map, normalized over its
    range, as a magma BGR image."""
    import cv2
    d = 1.0 / np.maximum(inv_depth, 1e-3)
    lo, hi = float(d.min()), float(d.max())
    dn = (d - lo) / max(hi - lo, 1e-12)
    return cv2.applyColorMap((dn * 255).astype(np.uint8),
                             cv2.COLORMAP_MAGMA)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--out", default="viz")
    p.add_argument("--max_frames", type=int, default=100)
    p.add_argument("--segm_filter", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import cv2

    from pvo_tpu_torch.scripts.test_vo import image_stream
    from pvo_tpu_torch.utils.config import VOConfig
    from pvo_tpu_torch.utils.flow_vis import flow_to_image
    from pvo_tpu_torch.vo.system import VOSystem
    from pvo_tpu_torch.vo.visualization import droid_visualization

    cfg = VOConfig(segm_filter=args.segm_filter)
    sysm = VOSystem(cfg, weights_path=args.weights, device=args.device)

    for (t, img, intr, segm) in image_stream(
            args.datapath, cfg.image_size, "val", args.segm_filter):
        if t >= args.max_frames:
            break
        sysm.track(t, img, intr, segments=segm)
    sysm.terminate(None, backend_steps=(7,))

    os.makedirs(args.out, exist_ok=True)
    n_pts = droid_visualization(sysm.video, args.out)
    print(f"point cloud: {n_pts} pts -> {args.out}/cloud.ply")

    n = sysm.video.counter
    depth = sysm.get_depth()
    for k in range(0, n, max(n // 6, 1)):
        cv2.imwrite(osp.join(args.out, f"depth_{k:04d}.png"),
                    depth_image(depth[k]))

    flow = sysm.video.full_flow[:n].cpu().numpy()
    for k in range(0, len(flow), max(len(flow) // 6, 1)):
        cv2.imwrite(osp.join(args.out, f"flow_{k:04d}.png"),
                    flow_to_image(flow[k] * 8.0)[:, :, ::-1])
    print(f"exports in {args.out}/")


if __name__ == "__main__":
    main()
