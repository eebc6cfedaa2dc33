"""Reconstruction visualization & export (port of
:mod:`pvo_tpu.vo.visualization`).

Rebuild of the reference visualizer (VO_Module/droid_slam/
visualization.py) for a headless host: instead of a live Open3D window
in a subprocess, this filters depths by multi-view consistency (the
reference's CUDA depth_filter) and exports point clouds (PLY) and the
keyframe trajectory that any viewer can open. The consistency count, the
back-projection and the masks run on the video's device; only the
masked points and their colours come to the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pvo_tpu_torch.geom.depth_filter import (backproject_points,
                                             depth_consistency_count)
from pvo_tpu_torch.lie import se3


def check_readable(video):
    """Raise while the planner owns the video's buffers: a read there
    would force a sync into its frame program and see a stale counter."""
    if video.engaged:
        raise RuntimeError("the planner is engaged: read the video after "
                           "terminate() or get_traj() disengages it")


@torch.no_grad()
def consistent_points(video, filter_thresh=0.005, min_count=2, frames=None):
    """On the video's device: world points (M, h, w, 3), their mask
    (M, h, w) and colours (M, h, w, 3) uint8 of the keyframes ``frames``
    (default: all). A pixel is kept when at least ``min_count`` of its
    neighbour views agree with its depth and its disparity is above half
    its frame's mean (droid_visualization's masking,
    visualization.py:55-154)."""
    check_readable(video)
    dev = video.device
    inds = (torch.arange(video.counter, device=dev) if frames is None
            else torch.as_tensor(np.asarray(frames), device=dev))
    disps = video.disps[inds]
    thresh = filter_thresh * torch.sqrt(disps.mean(dim=(1, 2)))
    intr = video.intrinsics[0]
    counts = depth_consistency_count(video.poses, video.disps, intr, inds,
                                     thresh)
    points = backproject_points(video.poses, video.disps, intr, inds)
    masks = (counts >= min_count) & \
        (disps > 0.5 * disps.mean(dim=(1, 2), keepdim=True))
    return points, masks, video.images[inds][:, 3::8, 3::8]


def filtered_pointcloud(video, filter_thresh=0.005, min_count=2,
                        frames=None):
    """Return (points (N,3) f32, colors (N,3) uint8) of the consistent
    pixels (:func:`consistent_points`), as numpy: only these come to the
    host."""
    points, masks, colors = consistent_points(video, filter_thresh,
                                              min_count, frames)
    return points[masks].cpu().numpy(), colors[masks].cpu().numpy()


def write_ply(path, points, colors=None):
    """Minimal ASCII PLY writer (no external deps)."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.4f} {points[i, 1]:.4f} " \
                  f"{points[i, 2]:.4f}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} " \
                       f"{int(colors[i, 2])}"
            f.write(row + "\n")


def keyframe_c2w(video):
    """(counter, 4, 4) camera-to-world matrices of the keyframes, as
    numpy."""
    return se3.matrix(se3.inv(video.poses[:video.counter])).cpu().numpy()


def droid_visualization(video, out_dir="viz", every=8):
    """Batch export variant of the reference's live loop: write the
    filtered cloud (every ``every``-th point) as ``cloud.ply`` and the
    keyframes' camera centres as ``trajectory.txt``. Returns the
    cloud's size before the thinning."""
    os.makedirs(out_dir, exist_ok=True)
    pts, cols = filtered_pointcloud(video)
    write_ply(os.path.join(out_dir, "cloud.ply"), pts[::every],
              cols[::every])
    np.savetxt(os.path.join(out_dir, "trajectory.txt"),
               keyframe_c2w(video)[:, :3, 3])
    return pts.shape[0]
