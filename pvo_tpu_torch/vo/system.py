"""The VO system facade: track / terminate (port of
:mod:`pvo_tpu.vo.system`, classic host-topology path).

Wires MotionFilter -> Frontend -> Backend -> TrajectoryFiller around a
shared DepthVideo.
Per ``track`` call (frame t): commit frame t-1's admission, run frame
t's motion filter (which writes slot ``counter`` when admitted), then
the frontend's per-keyframe update; the order is the JAX package's.

Numerics on the card follow the JAX accelerator path: the update
operator and GraphAgg compute in bf16, video features and (by default)
the per-edge hidden state are stored bf16, the encoders, the motion
filter's probe, geometry and DBA run in f32. TF32 is switched off for
matmuls and cuDNN convolutions when the system is built.

Not ported yet: the device-resident planner (``cfg.pipeline`` is
ignored: the port always runs the classic host loop) and the YUV upload
packing (``cfg.yuv420_upload`` is ignored).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from pvo_tpu_torch.geom.upsample import upsample_inter
from pvo_tpu_torch.utils.config import VOConfig
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.vo.backend import Backend
from pvo_tpu_torch.vo.factor_graph import FactorGraph
from pvo_tpu_torch.vo.frontend import Frontend
from pvo_tpu_torch.vo.motion_filter import MotionFilter
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.vo.trajectory_filler import TrajectoryFiller
from pvo_tpu_torch.vo.video import DepthVideo


class VOSystem:
    """End-to-end visual odometry (the reference's ``Droid``)."""

    def __init__(self, cfg: Optional[VOConfig] = None,
                 net: Optional[DroidNet] = None,
                 weights_path: Optional[str] = None, device="cuda",
                 seed=0, net_dtype=torch.bfloat16):
        """``net``: weights to use; else loaded from ``weights_path``;
        else random from ``seed``. ``device``: the card by default; the
        CPU runs only when asked for (``device="cpu"``). ``net_dtype``:
        storage dtype of the frontend's per-edge hidden state (parity
        tests pin f32)."""
        self.device = open_device(device)
        self.cfg = cfg or VOConfig()

        if net is None and weights_path is not None:
            from pvo_tpu_torch.utils.convert import load_droidnet_torch
            net = load_droidnet_torch(weights_path)
        if net is None:
            net = DroidNet.from_seed(seed)
        self.net = net.to(self.device).eval()

        # bf16 recurrent operator on the card (the reference autocasts
        # fp16); the motion filter keeps the f32 module
        update = self.net.update
        if self.cfg.dtype_features == "bfloat16" and \
                self.device.type == "cuda":
            update = copy.deepcopy(update).to(torch.bfloat16)
        self.update = update

        cfg = self.cfg
        self.video = DepthVideo(
            image_size=cfg.image_size, buffer=cfg.buffer,
            segm_filter=cfg.segm_filter, thresh=cfg.thresh,
            max_segments=cfg.max_segments, device=self.device)
        self.filterx = MotionFilter(self.net, self.video,
                                    thresh=cfg.filter_thresh)
        graph = FactorGraph(
            self.video, update, max_edges=cfg.max_edges,
            max_inactive=cfg.max_inactive,
            max_factors=48,  # reference droid_frontend.py:14
            beta=cfg.beta, net_dtype=net_dtype)
        self.frontend = Frontend(graph, self.video, cfg)
        self.backend = Backend(self.video, cfg, update)
        self.traj_filler = TrajectoryFiller(self.video, self.net, update)
        self._pending_adm = None

    @torch.no_grad()
    def track(self, tstamp, image, intrinsics, segments=None):
        """image: (H, W, 3) uint8 RGB at cfg.image_size; intrinsics: (4,)
        [fx, fy, cx, cy] at full resolution; segments: (h, w) panoptic
        ids at 1/8 resolution (used when cfg.segm_filter)."""
        if self._pending_adm is not None:
            self.filterx.resolve_track(self._pending_adm)
        self._pending_adm = self.filterx.track_async(
            tstamp, image, intrinsics, segments)
        self.frontend()

    @torch.no_grad()
    def terminate(self, image_stream=None, need_inv=True,
                  backend_steps=(7, 12)):
        """Run the last frontend update and the global BA passes. Returns
        [t, q] poses (c2w, or w2c when ``need_inv`` is False): (T, 7) for
        every frame of ``image_stream`` (the stream :meth:`track` saw,
        again, see :class:`TrajectoryFiller`), else the (counter, 7)
        keyframe poses."""
        if self._pending_adm is not None:
            self.filterx.resolve_track(self._pending_adm)
            self._pending_adm = None
        self.frontend()
        self.frontend.flush()
        for steps in backend_steps:
            self.backend(steps)
        if image_stream is None:
            traj = self.video.poses[:self.video.counter]
        else:
            traj = self.traj_filler(image_stream)
        if need_inv:
            traj = se3.inv(traj)
        return traj.cpu().numpy()

    def get_traj(self):
        """(counter, 7) keyframe w2c poses."""
        return self.video.poses[:self.video.counter].cpu().numpy()

    @torch.no_grad()
    def get_depth(self):
        """(counter, H, W) keyframe inverse depths, upsampled x8
        bilinearly on the device and read back once."""
        d = self.video.disps[:self.video.counter][..., None]
        return upsample_inter(d)[..., 0].cpu().numpy()

    @torch.no_grad()
    def get_flow(self):
        """(counter, H, W, 2) upsampled ``video.full_flow`` x 8 (a
        buffer of ones that nothing writes, as in the JAX package)."""
        f = self.video.full_flow[:self.video.counter] * 8.0
        return upsample_inter(f).cpu().numpy()
