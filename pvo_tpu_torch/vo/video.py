"""DepthVideo: the shared SLAM state buffer (port of
:mod:`pvo_tpu.vo.video`).

A fixed-size ring of keyframe state on one device: images, w2c poses,
inverse depths (1/8 res), intrinsics, correlation/context features
(bf16), local panoptic-segment ids and BA damping. Timestamps live on
the host. Tensors are updated in place: the JAX package's fused
keyframe write (one jitted dispatch) becomes in-place writes on the
video's device.

``engaged`` is True while the planner's frame program owns the buffers
(:class:`pvo_tpu_torch.vo.planner.PlannerDriver` sets it): the counter
is stale then, and a reader that would force a sync into the program
(the visualizer, the live viewer) raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.geom.distance import frame_distance_bidirectional
from pvo_tpu_torch.lie import se3


class DepthVideo:
    FRAME_FIELDS = ("poses", "disps", "intrinsics", "nets", "inps",
                    "fmaps", "segms", "images")

    def __init__(self, image_size=(240, 808), buffer=512,
                 segm_filter=False, thresh=0.8, max_segments=96,
                 feat_dtype=torch.bfloat16, device="cpu"):
        self.ht, self.wd = image_size
        self.h, self.w = self.ht // 8, self.wd // 8
        self.buffer = buffer
        self.segm_filter = segm_filter
        self.thresh = thresh
        self.max_segments = max_segments
        self.device = torch.device(device)

        self.counter = 0
        self.ready = False
        self.engaged = False

        B, h, w = buffer, self.h, self.w
        z = dict(device=self.device)
        self.tstamp = np.zeros(B, np.float64)
        self.images = torch.zeros((B, self.ht, self.wd, 3),
                                  dtype=torch.uint8, **z)
        self.poses = se3.identity((B,), **z)
        self.disps = torch.ones((B, h, w), **z)
        self.intrinsics = torch.zeros((B, 4), **z)
        self.fmaps = torch.zeros((B, h, w, 128), dtype=feat_dtype, **z)
        self.nets = torch.zeros((B, h, w, 128), dtype=feat_dtype, **z)
        self.inps = torch.zeros((B, h, w, 128), dtype=feat_dtype, **z)
        self.segms = torch.zeros((B, h, w), dtype=torch.long, **z)
        self.damping = 1e-6 * torch.ones((B, h, w), **z)
        # read by VOSystem.get_flow; nothing writes it, as in the JAX
        # package's DepthVideo
        self.full_flow = torch.ones((B, h, w, 2), **z)

    def _remap_segments(self, segm):
        """Host remap of arbitrary panoptic ids -> local [0, S) ids;
        id 0 stays 0 ('no segment', never filtered)."""
        s = np.asarray(segm).reshape(self.h, self.w)
        uniq, inv = np.unique(s, return_inverse=True)
        labels = np.cumsum(uniq != 0).astype(np.int32)  # rank, 1-based
        labels[uniq == 0] = 0
        labels[labels > self.max_segments - 1] = 0      # overflow -> 0
        return labels[inv].reshape(self.h, self.w)

    def append(self, tstamp, image, pose=None, disp=None,
               intrinsics=None, fmap=None, net=None, inp=None,
               segm=None):
        self.set_frame(self.counter, tstamp, image, pose, disp,
                       intrinsics, fmap, net, inp, segm)

    def set_frame(self, ix, tstamp, image=None, pose=None, disp=None,
                  intrinsics=None, fmap=None, net=None, inp=None,
                  segm=None):
        """Write slot ``ix`` (numpy, tensors on any device, or scalars;
        a field left None keeps its value) and raise the counter past
        it. A whole keyframe (features, image and intrinsics given) is
        written as the JAX package's fused write does: its segment slot
        is cleared unless a map is given under the segment filter, and
        its pose and disparity are written only with a pose (the
        disparity 1 by default, a scalar filling the map)."""
        if ix >= self.counter:
            self.counter = ix + 1
        self.tstamp[ix] = float(tstamp)
        if all(x is not None for x in (fmap, net, inp, image, intrinsics)):
            if segm is None or not self.segm_filter:
                self.segms[ix] = 0
            if pose is None:
                disp = None
            elif disp is None:
                disp = 1.0
        for name, value in (("images", image), ("poses", pose),
                            ("disps", disp), ("intrinsics", intrinsics),
                            ("fmaps", fmap), ("nets", net), ("inps", inp)):
            if value is not None:
                buf = getattr(self, name)
                buf[ix] = torch.as_tensor(value).to(buf.device, buf.dtype)
        if segm is not None and self.segm_filter:
            self.segms[ix] = torch.as_tensor(self._remap_segments(segm),
                                             device=self.device)

    def remove_frame(self, ix):
        """Shift frame ix+1 down onto ix (keyframe removal)."""
        for name in self.FRAME_FIELDS:
            arr = getattr(self, name)
            arr[ix] = arr[ix + 1]
        self.tstamp[ix] = self.tstamp[ix + 1]

    def normalize(self):
        """Mean-disparity normalization of the committed frames."""
        t = self.counter
        s = self.disps[:t].mean()
        self.disps[:t] /= s
        self.poses[:t, :3] *= s

    def distance(self, ii, jj, beta=0.3):
        """Bidirectional frame distance of pairs (ii, jj), as numpy."""
        ii = torch.as_tensor(np.asarray(ii).reshape(-1), device=self.device)
        jj = torch.as_tensor(np.asarray(jj).reshape(-1), device=self.device)
        d = frame_distance_bidirectional(self.poses, self.disps,
                                         self.intrinsics[0], ii, jj, beta)
        return d.cpu().numpy()

    def reproject(self, ii, jj):
        """Pixels of frames ``ii`` mapped into frames ``jj``: coords
        (1, N, h, w, 2) and valid (1, N, h, w, 1)."""
        ii = torch.as_tensor(np.asarray(ii, np.int64), device=self.device)
        jj = torch.as_tensor(np.asarray(jj, np.int64), device=self.device)
        return projective.projective_transform(
            self.poses[None], self.disps[None], self.intrinsics[None], ii, jj)

    def distance_matrix(self, beta=0.3):
        """(counter, counter) frame distances, as numpy."""
        t = self.counter
        ii, jj = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
        return self.distance(ii.reshape(-1), jj.reshape(-1),
                             beta).reshape(t, t)

    def pose_at(self, ix):
        """The w2c pose [t, q] of slot ``ix``, as numpy."""
        return self.poses[ix].cpu().numpy()
