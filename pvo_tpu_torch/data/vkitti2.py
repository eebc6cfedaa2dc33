"""Virtual KITTI 2 training dataset (port of :mod:`pvo_tpu.data.vkitti2`).

Rebuild of the reference RGBDDataset/VKitti2 readers
(VO_Module/droid_slam/data_readers/base.py + vkitti2.py): pickle-cached
scene index, flow-graph frame sampling, per-mode sample tuples
(sup / semisup / unsup / flow_label), disparity normalization, and GT
dynamic-mask construction. Host numpy: the train loop moves the numpy
batches to the device. The draws of ``np.random.default_rng(seed)`` are
the JAX package's, so one seed gives the same clips.

One fault of the JAX class is not copied (J3 in ROADMAP.md): there the
index cache is named by class, split and ``aug_graph`` alone, so a
second dataset root silently reads the first root's index. Here the
cache's name also holds a hash of the absolute root, the scenes and
``flow_label``, which all change what the index holds.
"""

from __future__ import annotations

import glob
import hashlib
import os
import os.path as osp
import pickle
from typing import Dict, List, Optional

import numpy as np

import torch

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.utils import io as io_utils

from . import augmentation
from .graph_utils import build_frame_graph

SPLITS = {"train": "clone", "val": "15-deg-left",
          "test": "30-deg-right"}
SCENES = ["Scene01", "Scene02", "Scene06", "Scene18", "Scene20"]


class VKitti2Dataset:
    DEPTH_SCALE = io_utils.VKITTI_DEPTH_SCALE

    def __init__(self, root, split_mode="train", n_frames=6,
                 fmin=8.0, fmax=96.0, crop_size=(200, 400),
                 mode="semisup", flow_label=False, aug_graph=True,
                 scenes: Optional[List[str]] = None,
                 cache_dir=".cache_pvo", seed=1234):
        self.root = root
        self.split = SPLITS[split_mode]
        self.n_frames = n_frames
        self.fmin, self.fmax = fmin, fmax
        self.crop_size = tuple(crop_size)
        self.mode = mode
        self.flow_label = flow_label
        self.aug_graph = aug_graph
        self.rng = np.random.default_rng(seed)
        self.scenes = scenes or SCENES

        os.makedirs(cache_dir, exist_ok=True)
        key = hashlib.sha1(repr((osp.abspath(root), list(self.scenes),
                                 flow_label)).encode()).hexdigest()[:12]
        cache = osp.join(
            cache_dir,
            f"{type(self).__name__}_{split_mode}_{aug_graph}_{key}.pickle")
        if osp.exists(cache):
            with open(cache, "rb") as f:
                self.scene_info = pickle.load(f)
        else:
            self.scene_info = self._build_index()
            with open(cache, "wb") as f:
                pickle.dump(self.scene_info, f)

        self._scene_list = sorted(self.scene_info.keys())

    # ---------- index ----------

    def _build_index(self) -> Dict:
        info = {}
        for scene in self.scenes:
            base = osp.join(self.root, scene, self.split)
            images = sorted(glob.glob(
                osp.join(base, "frames/rgb/Camera_0/*.jpg")))
            depths = sorted(glob.glob(
                osp.join(base, "frames/depth/Camera_0/*.png")))
            if not images:
                continue
            poses = io_utils.vkitti_poses_tq(
                osp.join(base, "extrinsic.txt"))
            intr = io_utils.VKITTI_INTRINSICS.copy()

            graph = None
            if self.aug_graph:
                # subsampled depths for the covis graph
                ds = [self._read_depth(d)[::16, ::16] for d in depths]
                graph = build_frame_graph(
                    poses, np.stack(ds), intr / 16.0)

            entry = {"images": images, "depths": depths,
                     "poses": poses, "intrinsics": intr,
                     "graph": graph}
            entry["dymasks"] = sorted(glob.glob(
                osp.join(base, "frames/dynamicMask/Camera_0/*.npy")))
            entry["segments"] = sorted(glob.glob(
                osp.join(base, "panFPN_segm/*.png")))
            if self.flow_label:
                entry["fo_flows"] = sorted(glob.glob(
                    osp.join(base, "frames/forwardFlow/Camera_0/*.png")))
                entry["ba_flows"] = sorted(glob.glob(
                    osp.join(base,
                             "frames/backwardFlow/Camera_0/*.png")))
            info[scene] = entry
        return info

    # ---------- readers ----------

    @staticmethod
    def _read_image(path):
        import cv2
        img = cv2.imread(path)          # BGR, like the reference
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    @classmethod
    def _read_depth(cls, path):
        import cv2
        raw = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        return io_utils.decode_vkitti_depth(raw)

    @staticmethod
    def _read_segment(path):
        from PIL import Image
        return io_utils.rgb2id(np.array(Image.open(path)))

    # ---------- sampling ----------

    def __len__(self):
        return sum(len(v["images"]) for v in self.scene_info.values())

    def sample_clip(self):
        """Sample one co-visible training clip; returns a dict of numpy
        arrays shaped for the jitted train step (leading dim 1)."""
        scene = self._scene_list[
            int(self.rng.integers(0, len(self._scene_list)))]
        info = self.scene_info[scene]
        F = len(info["images"])
        N = self.n_frames

        if info["graph"] is not None and self.rng.random() < 0.5:
            # walk the covis graph forward-in-time
            inds = [int(self.rng.integers(0, F))]
            while len(inds) < N:
                nbrs = [j for j in info["graph"].get(inds[-1], [])
                        if j > inds[-1]]
                if not nbrs:
                    break
                inds.append(int(nbrs[0]))
            if len(inds) < N:
                start = int(self.rng.integers(0, max(F - N, 1)))
                inds = list(range(start, start + N))
        else:
            start = int(self.rng.integers(0, max(F - N, 1)))
            inds = list(range(start, start + N))
        inds = [min(i, F - 1) for i in inds]

        images = np.stack([self._read_image(info["images"][i])
                           for i in inds]).astype(np.float32)
        depths = np.stack([self._read_depth(info["depths"][i])
                           for i in inds])
        poses = info["poses"][inds]
        intr = info["intrinsics"].copy()

        segments = None
        if self.mode == "semisup" and info["segments"]:
            segments = [self._read_segment(info["segments"][i])
                        for i in inds]

        # GT dynamic masks + validity for sup/semisup (reference
        # base.py:164-218: dymask_read -> (mask, val) stacked, riding
        # the augmentor like depth; generated by
        # scripts/prepare_vkitti.py --dynamic_masks). Missing files
        # degrade to all-static/all-valid, matching the behavior on
        # scenes without dymask labels.
        masks = None
        if self.mode in ("sup", "semisup"):
            dm = info.get("dymasks") or []
            if len(dm) >= F:
                masks = np.stack([np.load(dm[i]) for i in inds]
                                 ).astype(np.float32)
            else:
                masks = np.ones(images.shape[:3] + (2,), np.float32)

        flows = None
        if self.flow_label and info.get("fo_flows"):
            import cv2
            flows = {}
            for key_, field in (("fo", "fo_flows"), ("ba", "ba_flows")):
                fl, vl = [], []
                for i in inds[:-1]:
                    raw = cv2.imread(
                        info[field][i],
                        cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
                    f, v = io_utils.decode_vkitti_flow(raw)
                    fl.append(f)
                    vl.append(v)
                flows[key_] = (np.stack(fl), np.stack(vl))

        images, depths, intr, segs8, masks_c = \
            augmentation.augment_clip(
                images, depths, intr, self.crop_size, self.rng,
                segments=segments, masks=masks)

        disps = 1.0 / np.maximum(depths, 1e-3)
        # normalize mean disparity to 1 and rescale translations
        s = disps[disps > 0.01].mean()
        disps = disps / s
        poses = poses.copy()
        poses[:, :3] *= s

        h, w = self.crop_size[0] // 8, self.crop_size[1] // 8
        out = {
            "images": images[None].astype(np.uint8),
            "poses_gt": poses[None].astype(np.float32),
            "disps_gt": disps[None].astype(np.float32),
            "disps_init": np.ones((1, N, h, w), np.float32),
            "intrinsics": (intr / 8.0)[None].repeat(N, 0).reshape(
                1, N, 4).astype(np.float32),
            "intrinsics_up": intr[None].repeat(N, 0).reshape(
                1, N, 4).astype(np.float32),
        }
        # reference init (train.py:143-146): frame 0 gets GT pose 0,
        # frames 1..N-1 all get GT pose 1 (the solver recovers the
        # rest); was identity in earlier rounds — a fidelity gap
        init = np.empty((1, N, 7), np.float32)
        init[0, 0] = poses[0]
        init[0, 1:] = poses[1]
        out["poses_init"] = init
        out["disps_gt_up"] = disps[None].astype(np.float32)
        if masks_c is not None:
            out["gt_masks"] = masks_c[None, ..., 0].astype(np.float32)
            out["gt_vals"] = masks_c[None, ..., 1].astype(np.float32)
        if segs8 is not None:
            out["segments"] = segs8[None]
        if flows is not None:
            # note: GT flows are at the ORIGINAL resolution; the crop
            # transform doesn't apply cleanly to sparse flow, so
            # flow_label clips skip augmentation cropping in the
            # reference too (sparse resize, augmentation.py:21-55)
            out["fo_flows"] = np.concatenate(
                [flows["fo"][0], flows["fo"][1][..., None]],
                -1)[None].astype(np.float32)
            out["ba_flows"] = np.concatenate(
                [flows["ba"][0], flows["ba"][1][..., None]],
                -1)[None].astype(np.float32)
        return out

    def build_motion_masks(self, poses, disps, intrinsics, gt_flows,
                           thresh=0.5):
        """GT static masks: camera-induced flow agrees with GT flow
        (reference base.py:279-301), on the CPU."""
        F = poses.shape[0]
        ii = np.arange(F - 1)
        jj = ii + 1
        with torch.no_grad():
            flow, valid = projective.induced_flow(
                torch.as_tensor(np.asarray(poses, np.float32))[None],
                torch.as_tensor(np.asarray(disps, np.float32))[None],
                torch.as_tensor(np.asarray(intrinsics, np.float32)
                                ).expand(1, F, 4),
                ii, jj)
        d = np.linalg.norm(flow.numpy()[0] - gt_flows, axis=-1)
        return (d <= thresh).astype(np.float32)
