"""Non-keyframe poses: SE3 interpolation + motion-only BA refinement
(port of :mod:`pvo_tpu.vo.trajectory_filler`).

Every frame of the stream is staged in batches of 16 in the video rows
past the keyframes: its pose is interpolated in the SE3 tangent between
the bracketing keyframes, its features come from one batched fnet
encode, and 6 motion-only updates against both bracketing keyframes
refine it. Tail batches are padded to the full width by repeating the
last frame; padded rows are dropped at readback. The JAX package's
one-deep pipelining of batches is not ported: it hides relay round
trips, and the poses do not depend on it. Profiler ranges:
``vo.filler.fnet`` and the refinement graph's
``vo.filler.{volume,update,dba}``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.vo.factor_graph import FactorGraph
from pvo_tpu_torch.vo.net.droidnet import normalize_images


class TrajectoryFiller:
    def __init__(self, video, net, update, batch=16):
        """``net``: the f32 :class:`DroidNet` (its fnet encodes the
        frames); ``update``: the update operator of the refinement graph
        (the frontend's, in the compute dtype)."""
        self.video = video
        self.net = net
        self.update = update
        self.batch = batch
        self._graph = None

    def _fill(self, tstamps, images, intrinsics):
        """Poses (M, 7) w2c of one batch of M frames, on the device."""
        v = self.video
        dev = v.device
        N = v.counter
        M = len(tstamps)
        B = min(self.batch, v.buffer - N)
        if M > B:
            raise ValueError(
                f"trajectory filler stages {M} frames past the {N} "
                f"keyframes; video buffer ({v.buffer}) must be at least "
                f"keyframes + batch ({self.batch})")

        pad = B - M
        tstamps = list(tstamps) + [tstamps[-1]] * pad
        images = list(images) + [images[-1]] * pad
        intrinsics = list(intrinsics) + [intrinsics[-1]] * pad

        # bracketing keyframes and interpolation weights (host)
        ts = v.tstamp[:N]
        tt = np.asarray(tstamps, np.float64)
        t0 = np.array([np.sum(ts <= t) - 1 for t in tt])
        t1 = np.where(t0 < N - 1, t0 + 1, t0)
        dt = ts[t1] - ts[t0] + 1e-3
        wfac = torch.as_tensor((tt - ts[t0]) / dt, dtype=torch.float32,
                               device=dev)[:, None]

        x = torch.as_tensor(np.stack([np.asarray(im, np.uint8)
                                      for im in images]), device=dev)
        with record_function("vo.filler.fnet"):
            gmaps = self.net.fnet(normalize_images(x))
        intr8 = torch.as_tensor(np.stack([np.asarray(i, np.float32)
                                          for i in intrinsics]),
                                device=dev) / 8.0

        P0 = v.poses[torch.as_tensor(t0, device=dev)]
        P1 = v.poses[torch.as_tensor(t1, device=dev)]
        dP = se3.mul(P1, se3.inv(P0))
        rows = slice(N, N + B)
        v.poses[rows] = se3.mul(se3.exp(se3.log(dP) * wfac), P0)
        v.disps[rows] = 1.0
        v.fmaps[rows] = gmaps.to(v.fmaps.dtype)
        v.intrinsics[rows] = intr8
        v.tstamp[rows] = tt
        v.counter = N + B

        if self._graph is None:
            self._graph = FactorGraph(v, self.update,
                                      max_edges=2 * self.batch + 2,
                                      max_inactive=1)
            self._graph.layer = "vo.filler"
        graph = self._graph
        kk = np.arange(N, N + B)
        graph.add_factors(t0, kk)
        graph.add_factors(t1, kk)
        graph.update(N, N + B, motion_only=True, steps=6)
        graph.clear_edges()

        poses = v.poses[N:N + M].clone()
        v.counter = N
        return poses

    @torch.no_grad()
    def __call__(self, image_stream):
        """image_stream yields (tstamp, image (H, W, 3) RGB uint8,
        intrinsics, ...). Returns (T, 7) w2c poses for every frame, on
        the video's device."""
        poses, batch = [], ([], [], [])
        for item in image_stream:
            for acc, val in zip(batch, item[:3]):
                acc.append(val)
            if len(batch[0]) == self.batch:
                poses.append(self._fill(*batch))
                batch = ([], [], [])
        if batch[0]:
            poses.append(self._fill(*batch))
        return torch.cat(poses)
