"""TartanAir and Replica training datasets (port of
:mod:`pvo_tpu.data.tartan`; poses go through the port's ``lie``).

Rebuild of reference data_readers/tartan.py and replica.py against the
public layouts: TartanAir scenes hold image_left/*.png, depth_left/*.npy
and pose_left.txt (NED [x y z qx qy qz qw]); Replica (DROID-SLAM
release) holds results/frame*.jpg + results/depth*.png and traj.txt.
Both reuse the VKitti2Dataset sampling machinery through a shared
scene_info shape.
"""

from __future__ import annotations

import glob
import os.path as osp

import numpy as np
import torch

from pvo_tpu_torch.lie import se3, so3

from .vkitti2 import VKitti2Dataset

# NED (TartanAir) -> camera-frame remap
_NED2CAM = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float64)


def tartan_pose_to_w2c(traj):
    """TartanAir pose_left.txt rows [x y z qx qy qz qw] (c2w NED) ->
    (T, 7) w2c [t, q] in camera axes (the rotations in float64, the
    result float32)."""
    t = traj[:, :3] @ _NED2CAM.T
    q = torch.as_tensor(np.asarray(traj[:, 3:7], np.float64))
    # rotate quaternion frame: R_cam = P R_ned P^T
    R = _NED2CAM @ so3.quat_to_matrix(q).numpy() @ _NED2CAM.T
    q_cam = so3.quat_from_matrix(torch.as_tensor(R)).numpy()
    c2w = np.concatenate([t, q_cam], axis=1).astype(np.float32)
    return se3.inv(torch.as_tensor(c2w)).numpy()


class TartanAirDataset(VKitti2Dataset):
    INTRINSICS = np.array([320.0, 320.0, 320.0, 240.0], np.float32)

    def _build_index(self):
        info = {}
        for scene_dir in sorted(glob.glob(osp.join(self.root, "*",
                                                   "*", "*"))):
            images = sorted(glob.glob(osp.join(scene_dir,
                                               "image_left/*.png")))
            depths = sorted(glob.glob(osp.join(scene_dir,
                                               "depth_left/*.npy")))
            posef = osp.join(scene_dir, "pose_left.txt")
            if not images or not osp.exists(posef):
                continue
            traj = np.loadtxt(posef)
            poses = tartan_pose_to_w2c(traj)
            info[scene_dir] = {
                "images": images, "depths": depths, "poses": poses,
                "intrinsics": self.INTRINSICS.copy(), "graph": None,
                "dymasks": [], "segments": [],
            }
        return info

    @classmethod
    def _read_depth(cls, path):
        d = np.load(path).astype(np.float32)
        d[~np.isfinite(d)] = 1.0
        d[d <= 0] = 1.0
        return d


class ReplicaDataset(VKitti2Dataset):
    INTRINSICS = np.array([600.0, 600.0, 599.5, 339.5], np.float32)
    DEPTH_SCALE = 6553.5  # png scale of the DROID replica release

    def _build_index(self):
        info = {}
        for scene_dir in sorted(glob.glob(osp.join(self.root, "*"))):
            images = sorted(glob.glob(osp.join(scene_dir,
                                               "results/frame*.jpg")))
            depths = sorted(glob.glob(osp.join(scene_dir,
                                               "results/depth*.png")))
            posef = osp.join(scene_dir, "traj.txt")
            if not images or not osp.exists(posef):
                continue
            mats = torch.as_tensor(np.loadtxt(posef).reshape(-1, 4, 4))
            poses = se3.inv(se3.from_matrix(mats)).numpy()
            info[scene_dir] = {
                "images": images, "depths": depths,
                "poses": poses.astype(np.float32),
                "intrinsics": self.INTRINSICS.copy(), "graph": None,
                "dymasks": [], "segments": [],
            }
        return info

    @classmethod
    def _read_depth(cls, path):
        import cv2
        raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
        d = raw.astype(np.float32) / cls.DEPTH_SCALE
        d[d <= 0] = 1.0
        return d
