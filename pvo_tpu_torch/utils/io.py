"""Bit-compatible dataset / artifact I/O (the port's own copy of
:mod:`pvo_tpu.utils.io`; poses go through the port's ``se3``).

Replicates the reference's exact decode semantics so trajectories, flow
.npy files, and panoptic PNGs interchange with the reference pipeline:
  * panoptic id<->rgb codec (panopticapi contract: id = R + 256 G +
    65536 B);
  * Virtual KITTI 2 16-bit flow decode (reference
    data_readers/vkitti2.py:123-131);
  * VKITTI depth PNG decode with DEPTH_SCALE=5 (vkitti2.py:114-121);
  * extrinsic.txt pose parsing (Camera_0 rows, 4x4 w2c; reference
    vkitti2.py:57-76 and test_vo.py:121-144).
"""

from __future__ import annotations

import numpy as np
import torch

from pvo_tpu_torch.lie import se3

VKITTI_DEPTH_SCALE = 5.0
VKITTI_INTRINSICS = np.array([725.0087, 725.0087, 620.5, 187.0],
                             np.float32)


def rgb2id(color):
    """Panoptic RGB PNG -> integer id map."""
    color = np.asarray(color, dtype=np.uint32)
    if color.ndim == 3:
        return (color[..., 0] + 256 * color[..., 1] +
                256 * 256 * color[..., 2])
    return color


def id2rgb(id_map):
    """Integer id map -> RGB uint8 (panopticapi layout)."""
    id_map = np.asarray(id_map, dtype=np.uint32)
    rgb = np.zeros(id_map.shape + (3,), np.uint8)
    rgb[..., 0] = id_map % 256
    rgb[..., 1] = (id_map // 256) % 256
    rgb[..., 2] = (id_map // 65536) % 256
    return rgb


def decode_vkitti_flow(bgr_u16):
    """VKITTI 16-bit flow PNG (BGR layout) -> (flow (H,W,2), valid)."""
    h, w, _ = bgr_u16.shape
    flow = 2.0 / (2 ** 16 - 1.0) * \
        bgr_u16[..., 2:0:-1].astype(np.float32) - 1.0
    flow[..., 0] *= w - 1
    flow[..., 1] *= h - 1
    valid = (bgr_u16[..., 0] > 0).astype(np.float32)
    return flow, valid


def decode_vkitti_depth(depth_u16):
    """VKITTI depth PNG (cm) -> scaled depth (DEPTH_SCALE balance)."""
    depth = np.asarray(depth_u16, np.float32) / (VKITTI_DEPTH_SCALE * 100)
    depth[~np.isfinite(depth)] = 1.0
    depth[depth == 0] = 1.0
    return depth


def load_vkitti_extrinsics(path, camera=0):
    """extrinsic.txt -> (T, 4, 4) w2c matrices for the given camera."""
    raw = np.loadtxt(path, delimiter=" ", skiprows=1)
    raw = raw[camera::2, 2:]
    return raw.reshape(-1, 4, 4).astype(np.float64)


def vkitti_poses_tq(path, camera=0, depth_scale=VKITTI_DEPTH_SCALE):
    """extrinsic.txt -> (T, 7) [t, q] w2c with translation scaled by
    1/DEPTH_SCALE (the reference's rot/trans balancing); computed in
    float64, rounded to float32 at the end."""
    mats = load_vkitti_extrinsics(path, camera)
    g = se3.from_matrix(torch.from_numpy(mats)).numpy()
    g[:, :3] /= depth_scale
    return g.astype(np.float32)


def write_kitti_poses(path, poses_c2w_mat):
    """Write trajectory in KITTI format (12 numbers per row)."""
    with open(path, "w") as f:
        for m in poses_c2w_mat:
            row = np.asarray(m[:3, :4]).reshape(-1)
            f.write(" ".join(f"{x:.9e}" for x in row) + "\n")
