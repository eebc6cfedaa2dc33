"""Stream readers and dataset factory (port of
:mod:`pvo_tpu.data.streams`, plain numpy and cv2).

Rebuild of reference VO_Module/droid_slam/data_readers/stream.py,
tartan.py, replica.py and factory.py: simple iterator-based readers for
demo/eval streams, TUM-format pose loaders (rgbd_utils.py:38-92), and a
dataset factory concatenating the port's training datasets.

``parse_list`` reads with ``np.str_``: the JAX module's ``np.unicode_``
was removed in NumPy 2.0, where its ``parse_list`` raises (fault J9, not
copied).
"""

from __future__ import annotations

import glob
import os.path as osp

import numpy as np


def parse_list(filepath, skiprows=0):
    return np.loadtxt(filepath, delimiter=" ", dtype=np.str_,
                      skiprows=skiprows)


def associate_frames(tstamp_image, tstamp_depth, tstamp_pose,
                     max_dt=0.08):
    """TUM timestamp association (reference rgbd_utils.py:56-76)."""
    associations = []
    for i, t in enumerate(tstamp_image):
        if tstamp_pose is None:
            j = np.argmin(np.abs(tstamp_depth - t))
            if np.abs(tstamp_depth[j] - t) < max_dt:
                associations.append((i, j))
        else:
            j = np.argmin(np.abs(tstamp_depth - t))
            k = np.argmin(np.abs(tstamp_pose - t))
            if (np.abs(tstamp_depth[j] - t) < max_dt and
                    np.abs(tstamp_pose[k] - t) < max_dt):
                associations.append((i, j, k))
    return associations


def load_tum_poses(pose_file):
    """TUM trajectory: t tx ty tz qx qy qz qw -> (T,) stamps, (T,7)."""
    data = np.loadtxt(pose_file, delimiter=" ", comments="#")
    return data[:, 0], data[:, 1:8].astype(np.float32)


class ImageStream:
    """Image-directory stream (reference stream.py RGBStream)."""

    def __init__(self, imagedir, intrinsics, stride=1, image_size=None):
        self.files = sorted(
            glob.glob(osp.join(imagedir, "*.png")) +
            glob.glob(osp.join(imagedir, "*.jpg")))[::stride]
        self.intrinsics = np.asarray(intrinsics, np.float32)
        self.image_size = image_size

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        import cv2
        for t, f in enumerate(self.files):
            img = cv2.imread(f)
            intr = self.intrinsics.copy()
            if self.image_size is not None:
                h1, w1 = self.image_size
                h0, w0 = img.shape[:2]
                img = cv2.resize(img, (w1, h1))
                intr *= np.array([w1 / w0, h1 / h0, w1 / w0, h1 / h0],
                                 np.float32)
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            img = img[: img.shape[0] // 8 * 8, : img.shape[1] // 8 * 8]
            yield t, img, intr, None


class RGBDStream(ImageStream):
    """Image + depth stream (reference stream.py RGBDStream)."""

    def __init__(self, imagedir, depthdir, intrinsics, stride=1,
                 depth_scale=1000.0, **kw):
        super().__init__(imagedir, intrinsics, stride, **kw)
        self.depth_files = sorted(
            glob.glob(osp.join(depthdir, "*.png")))[::stride]
        self.depth_scale = depth_scale

    def __iter__(self):
        import cv2
        for (t, img, intr, _), df in zip(super().__iter__(),
                                         self.depth_files):
            d = cv2.imread(df, cv2.IMREAD_ANYDEPTH)
            yield t, img, intr, d.astype(np.float32) / self.depth_scale


class StereoStream:
    """Left/right image-pair stream (reference stream.py:127-186).

    Pairs ``<datapath>/<left_root>/*.png`` with the same filename under
    ``right_root`` (unpaired lefts are skipped), takes the timestamp
    from the filename stem, optionally rectifies each side through a
    cv2.remap map, rescales the shared intrinsics to ``image_size`` and
    resizes both images (bilinear, align_corners like the reference's
    F.interpolate). Yields ``(t, image_l, image_r, intrinsics)`` with
    images as (H, W, 3) float32 RGB.
    """

    def __init__(self, datapath, intrinsics, rate=1,
                 image_size=(384, 512), map_left=None, map_right=None,
                 left_root="image_left", right_root="image_right"):
        self.intrinsics = np.asarray(intrinsics, np.float32)
        self.image_size = tuple(image_size)
        self.map_left = map_left
        self.map_right = map_right
        self.images_l, self.images_r, self.tstamps = [], [], []
        for img_l in sorted(
                glob.glob(osp.join(datapath, left_root, "*.png")))[::rate]:
            img_r = img_l.replace(left_root, right_root)
            if osp.isfile(img_r):
                stem = osp.splitext(osp.basename(img_l))[0]
                try:
                    t = float(stem)
                except ValueError:
                    t = float(len(self.tstamps))
                self.tstamps.append(t)
                self.images_l.append(img_l)
                self.images_r.append(img_r)

    def __len__(self):
        return len(self.images_l)

    @staticmethod
    def _read(imfile, imap):
        import cv2
        image = cv2.imread(imfile)
        if imap is not None:
            image = cv2.remap(image, imap[0], imap[1],
                              interpolation=cv2.INTER_LINEAR)
        return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)

    @staticmethod
    def _resize_ac(img, h1, w1):
        """numpy bilinear resize, torch align_corners=True semantics
        (src = dst * (S0-1)/(S1-1)) — the reference's F.interpolate
        call (stream.py:180-182)."""
        h0, w0 = img.shape[:2]

        def axis_ix(s0, s1):
            if s1 == 1 or s0 == 1:
                return (np.zeros(s1, np.int64), np.zeros(s1, np.int64),
                        np.zeros(s1, np.float32))
            src = np.arange(s1, dtype=np.float64) * (s0 - 1) / (s1 - 1)
            lo = np.clip(np.floor(src).astype(np.int64), 0, s0 - 2)
            return lo, lo + 1, (src - lo).astype(np.float32)

        ylo, yhi, wy = axis_ix(h0, h1)
        xlo, xhi, wx = axis_ix(w0, w1)
        top = (img[ylo][:, xlo] * (1 - wx[None, :, None]) +
               img[ylo][:, xhi] * wx[None, :, None])
        bot = (img[yhi][:, xlo] * (1 - wx[None, :, None]) +
               img[yhi][:, xhi] * wx[None, :, None])
        return top * (1 - wy[:, None, None]) + bot * wy[:, None, None]

    def __getitem__(self, index):
        img_l = self._read(self.images_l[index], self.map_left)
        img_r = self._read(self.images_r[index], self.map_right)
        h0, w0 = img_l.shape[:2]
        h1, w1 = self.image_size
        intr = self.intrinsics * np.array(
            [w1 / w0, h1 / h0, w1 / w0, h1 / h0], np.float32)
        img_l = self._resize_ac(img_l.astype(np.float32), h1, w1)
        img_r = self._resize_ac(img_r.astype(np.float32), h1, w1)
        return self.tstamps[index], img_l, img_r, intr

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def dataset_factory(names, **kwargs):
    """Concatenate training datasets by name (reference
    factory.py:19-35): vkitti2 (the PVO training set), tartan and
    replica (:mod:`pvo_tpu_torch.data.tartan`)."""
    datasets = []
    for name in names:
        if name == "vkitti2":
            from .vkitti2 import VKitti2Dataset
            datasets.append(VKitti2Dataset(**kwargs))
        elif name == "tartan":
            from .tartan import TartanAirDataset
            datasets.append(TartanAirDataset(**kwargs))
        elif name == "replica":
            from .tartan import ReplicaDataset
            datasets.append(ReplicaDataset(**kwargs))
        else:
            raise ValueError(f"unknown dataset {name}")
    if len(datasets) == 1:
        return datasets[0]

    class Concat:
        def __init__(self, ds):
            self.ds = ds

        def __len__(self):
            return sum(len(d) for d in self.ds)

        def sample_clip(self):
            i = np.random.randint(len(self.ds))
            return self.ds[i].sample_clip()

    return Concat(datasets)
