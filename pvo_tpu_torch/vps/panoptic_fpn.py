"""Panoptic FPN with flow-guided feature fusion (the port's own copy of
:mod:`pvo_tpu.vps.panoptic_fpn`).

ResNet-50 + FPN backbone, semantic head, RPN, ROI heads, the panoptic
stitch with the vkitti id scheme (cat*10000 + instance), and the PVO
fusion mode: the previous frame's FPN features forward-splatted by the VO
flow (optionally depth-ordered), concatenated with the current ones and
fused by a 3x3 conv (512 -> 256) before the heads.

The dense path runs on the device, eagerly, with a host wait inside each
of its two NMS calls (``ops.nms``); the per-image stitch is host numpy, as
in the JAX package and the reference. Layers carry
``torch.profiler.record_function`` ranges named ``vps.<layer>``.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from pvo_tpu_torch.utils.device import open_device

from . import categories as C
from .fpn import FPN
from .resnet import FrozenBN, ResNet50
from .roi_heads import ROIHeads
from .rpn import RPN
from .semseg import SemSegFPNHead

PIXEL_MEAN = np.array([103.530, 116.280, 123.675], np.float32)  # BGR
PIXEL_STD = np.array([1.0, 1.0, 1.0], np.float32)


class PanopticFPN(nn.Module):
    """State-dict names as detectron2's PanopticFPN (``backbone.*``,
    ``proposal_generator.rpn_head.*``, ``roi_heads.*``,
    ``sem_seg_head.*``) plus PVO's ``fusion_conv1``."""

    def __init__(self, num_thing_classes=C.NUM_THING_CLASSES,
                 num_semseg_classes=C.NUM_SEMSEG_CLASSES, fusion_alpha=1.0,
                 backbone_blocks=(3, 4, 6, 3)):
        super().__init__()
        self.fusion_alpha = fusion_alpha
        self.backbone = FPN(ResNet50(backbone_blocks))
        self.proposal_generator = RPN()
        self.roi_heads = ROIHeads(num_thing_classes)
        self.sem_seg_head = SemSegFPNHead(num_semseg_classes)
        self.fusion_conv1 = nn.Conv2d(512, 256, 3, padding=1)
        # False when a checkpoint without PVO's fusion conv was loaded
        self.has_fusion = True

    def features(self, images_bgr):
        """images_bgr: (B, 3, H, W) float BGR (0..255), in the model's
        dtype. Returns {p2..p6}."""
        dt = images_bgr.dtype
        mean = torch.as_tensor(PIXEL_MEAN, dtype=dt,
                               device=images_bgr.device)[None, :, None, None]
        std = torch.as_tensor(PIXEL_STD, dtype=dt,
                              device=images_bgr.device)[None, :, None, None]
        x = (images_bgr - mean) / std
        with record_function("vps.backbone"):
            res = self.backbone.bottom_up(x)
        with record_function("vps.fpn"):
            return self.backbone.top_down(res)

    def fuse(self, feats_cur, feats_warp):
        """Concat current + alpha * warped-ref features, fuse 512->256."""
        if not self.has_fusion:
            raise RuntimeError("the loaded checkpoint has no fusion_conv1: "
                               "this model runs the plain path only")
        return {k: self.fusion_conv1(torch.cat(
            [v, self.fusion_alpha * feats_warp[k]], dim=1))
            for k, v in feats_cur.items()}

    def heads(self, feats, image_hw, max_dets=100):
        with record_function("vps.semseg"):
            sem_logits = self.sem_seg_head(feats, image_hw)
        with record_function("vps.rpn"):
            proposals, _, pvalid = self.proposal_generator(feats, image_hw)
        dets = self.roi_heads(feats, proposals, pvalid, image_hw,
                              max_dets=max_dets)
        return sem_logits, dets

    def forward(self, images_bgr, feats_warp=None, max_dets=100):
        """Full inference for ONE image (B=1). Returns (sem_logits
        (1, S, H, W), detections)."""
        feats = self.features(images_bgr)
        if feats_warp is not None:
            with record_function("vps.fusion"):
                feats = self.fuse(feats, feats_warp)
        return self.heads(feats, images_bgr.shape[2:], max_dets=max_dets)


def init_weights(model, seed=0):
    """Random weights from ``seed`` (a ``torch.Generator``): convolutions
    He-normal over fan-out, linears normal over fan-in, biases zero, the
    norms the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                if isinstance(m, nn.Linear):
                    std = w.shape[1] ** -0.5
                else:
                    fan_out = w.shape[0] * w[0, 0].numel()
                    if isinstance(m, nn.ConvTranspose2d):
                        fan_out = w.shape[1] * w[0, 0].numel()
                    std = (2.0 / fan_out) ** 0.5
                w.copy_(torch.randn(w.shape, generator=g) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (FrozenBN, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return model


# ---------------- flow transport (device) ----------------


def pose_transport_depth(depth, pose_ref_w2c, pose_cur_w2c, intrinsics):
    """Reproject a reference depth map into the current camera (reference
    panoptic_fpn.py:388-408): lift every reference pixel to a camera
    point, move it through cur_w2c @ inv(ref_w2c), and return its z, still
    on the REFERENCE pixel grid.

    depth: (H, W); pose_*_w2c: (4, 4); intrinsics: (fx, fy, cx, cy).
    """
    H, W = depth.shape
    dev = depth.device
    fx, fy, cx, cy = [torch.as_tensor(v, dtype=torch.float32, device=dev)
                      for v in intrinsics]
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    Z = depth.float()
    X = (u - cx) / fx * Z
    Y = (v - cy) / fy * Z
    pts = torch.stack([X, Y, Z, torch.ones_like(Z)], 0).reshape(4, -1)
    rel = pose_cur_w2c.float() @ torch.linalg.inv(pose_ref_w2c.float())
    return (rel @ pts)[2].reshape(H, W)


def _bitcompat_uint16(fl):
    """numpy-style float -> uint16 C-cast (truncate, wrap mod 2^16): the
    reference's npy-flow path casts the flow so (panoptic_fpn.py:313-314),
    and negative components wrap out of bounds. Kept on purpose."""
    return torch.bitwise_and(torch.trunc(fl).to(torch.int32),
                             0xFFFF).to(torch.float32)


def resize_bilinear(x, hw):
    """(..., h0, w0) -> (..., h, w) as ``jax.image.resize(..., "bilinear")``:
    antialiased when it shrinks."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(1, -1, *x.shape[-2:]), size=tuple(hw),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(*lead, *hw)


def splat_targets(flow, hw, bitcompat=False):
    """Flat target index of every pixel of an (h, w) level, h*w where it
    lands outside. flow: (2, H, W) full-res f32."""
    H, W = flow.shape[1:]
    h, w = hw
    fl = resize_bilinear(flow, hw)
    if bitcompat:
        # the reference keeps full-res pixel values at every level
        fl = _bitcompat_uint16(fl)
    else:
        fl = fl * torch.tensor([w / W, h / H], dtype=fl.dtype,
                               device=fl.device)[:, None, None]
    yy = torch.arange(h, device=fl.device)[:, None]
    xx = torch.arange(w, device=fl.device)[None, :]
    u1 = (xx + fl[0]).to(torch.int32).reshape(-1)
    v1 = (yy + fl[1]).to(torch.int32).reshape(-1)
    inb = (u1 >= 0) & (u1 < w) & (v1 >= 0) & (v1 < h)
    return torch.where(inb, v1 * w + u1, h * w).long()


def flow_warp_features(feats: Dict[str, torch.Tensor], flow, depth=None,
                       bitcompat=False):
    """Forward-splat reference features to the current frame by flow.

    feats: {level: (1, C, h, w)} of the REFERENCE frame; flow: (H, W, 2)
    full-res f32; depth: optional (H', W') reference depth at any
    resolution. Where several pixels land on one target the last one in
    splat order wins: without depth the last in raster order, with depth
    the nearest (far-to-near order, a stable sort of -depth). The winner
    is picked explicitly, the largest splat position per target by
    ``scatter_reduce("amax")``, then one gather: a scatter of the features
    would leave the winner of a duplicate undefined on the card.

    bitcompat=True replays the reference's npy-flow quirks (flow resized
    to each level without rescaling its values, then C-cast to uint16).
    """
    with record_function("vps.splat"):
        return _flow_warp(feats, flow.float().permute(2, 0, 1), depth,
                          bitcompat)


def _flow_warp(feats, flow, depth, bitcompat):
    out = {}
    for k, f in feats.items():
        _, Cc, h, w = f.shape
        n = h * w
        tgt = splat_targets(flow, (h, w), bitcompat)
        src = torch.arange(n, device=tgt.device)
        if depth is not None:
            d = resize_bilinear(depth.float(), (h, w)).reshape(-1)
            src = torch.argsort(-d, stable=True)  # far first
            tgt = tgt[src]
        pos = torch.arange(n, device=tgt.device)
        win = torch.full((n + 1,), -1, dtype=torch.long,
                         device=tgt.device).scatter_reduce(
            0, tgt, pos, "amax")[:n]
        hit = win >= 0
        gathered = f[0].reshape(Cc, n)[:, src[win.clamp(min=0)]]
        out[k] = torch.where(hit, gathered,
                             torch.zeros((), dtype=f.dtype,
                                         device=f.device)).reshape(1, Cc, h, w)
    return out


# ---------------- panoptic stitching (host) ----------------


def paste_masks(mask_logits, boxes, out_hw, thresh=0.5):
    """Paste (D, 28, 28) mask logits into full-res boolean masks
    (host numpy; detectron2 paste_masks_in_image semantics)."""
    H, W = out_hw
    D, ms, _ = mask_logits.shape
    out = np.zeros((D, H, W), bool)
    for i in range(D):
        x0, y0, x1, y1 = boxes[i]
        x0i, y0i = int(np.floor(x0)), int(np.floor(y0))
        x1i, y1i = int(np.ceil(x1)), int(np.ceil(y1))
        x0i, y0i = max(x0i, 0), max(y0i, 0)
        x1i, y1i = min(x1i, W), min(y1i, H)
        if x1i <= x0i or y1i <= y0i:
            continue
        # sample the 28x28 logits at pixel centers within the box
        ys = (np.arange(y0i, y1i) + 0.5 - y0) / max(y1 - y0, 1e-6) * ms
        xs = (np.arange(x0i, x1i) + 0.5 - x0) / max(x1 - x0, 1e-6) * ms
        ys = np.clip(ys - 0.5, 0, ms - 1)
        xs = np.clip(xs - 0.5, 0, ms - 1)
        yf, xf = np.floor(ys).astype(int), np.floor(xs).astype(int)
        yc = np.minimum(yf + 1, ms - 1)
        xc = np.minimum(xf + 1, ms - 1)
        wy = (ys - yf)[:, None]
        wx = (xs - xf)[None, :]
        m = mask_logits[i]
        patch = ((1 - wy) * (1 - wx) * m[yf][:, xf] +
                 (1 - wy) * wx * m[yf][:, xc] +
                 wy * (1 - wx) * m[yc][:, xf] +
                 wy * wx * m[yc][:, xc])
        out[i, y0i:y1i, x0i:x1i] = patch > np.log(
            thresh / (1 - thresh))
    return out


def combine_panoptic(dets, sem_seg, overlap_threshold=0.5,
                     stuff_area_thresh=4096,
                     instances_score_thresh=0.5):
    """Stitch instances + semantics into a panoptic id map with the
    vkitti id scheme (reference panoptic_fpn.py:497-588).

    dets: dict of numpy arrays (boxes, scores, classes, mask_logits,
    valid). sem_seg: (H, W) contiguous semantic ids.
    Returns (panoptic (H, W) int32, segments_info list).
    """
    H, W = sem_seg.shape
    pan = np.zeros((H, W), np.int32)
    segments = []

    valid = np.asarray(dets["valid"])
    scores = np.asarray(dets["scores"])
    order = np.argsort(-scores)
    masks = paste_masks(np.asarray(dets["mask_logits"]),
                        np.asarray(dets["boxes"]), (H, W))

    seg_id = 0
    for i in order:
        if not valid[i] or scores[i] < instances_score_thresh:
            continue
        m = masks[i]
        area = int(m.sum())
        if area == 0:
            continue
        inter = int((m & (pan > 0)).sum())
        if inter / area > overlap_threshold:
            continue
        if inter > 0:
            m = m & (pan == 0)
        seg_id += 1
        cat = C.THING_ID2CAT[int(dets["classes"][i])]
        inst_id = cat * 10000 + seg_id
        pan[m] = inst_id
        segments.append({"id": inst_id, "isthing": True,
                         "score": float(scores[i]),
                         "category_id": cat, "instance_id": int(i)})

    for lbl in np.unique(sem_seg):
        if lbl == 0:
            continue
        m = (sem_seg == lbl) & (pan == 0)
        area = int(m.sum())
        if area < stuff_area_thresh:
            continue
        seg_id += 1
        cat = C.STUFF_ID2CAT[int(lbl)]
        pan[m] = cat * 10000
        segments.append({"id": cat * 10000, "isthing": False,
                         "category_id": cat, "area": area})

    return pan, segments


# ---------------- high-level runner ----------------


class PanopticPredictor:
    """The dense path on the device + the host panoptic stitch, with the
    fusion state (the previous frame's FPN features) kept per video
    (reference inference_fusion, panoptic_fpn.py:254-308)."""

    def __init__(self, model, max_dets=100, bf16=False, device="cuda"):
        """``model``: a :class:`PanopticFPN` (a copy of it is moved to
        ``device``; the caller's module stays as it is).
        ``bf16=True`` runs the dense path in bfloat16 (weights and image;
        detections and the semantic map come back as f32 and uint8).
        ``device`` defaults to the card and raises without one."""
        self.device = open_device(device)
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.model = copy.deepcopy(model).to(self.device, self.dtype).eval()
        self.max_dets = max_dets
        self._video_id = None
        self._prev = None  # the previous frame's FPN features
        self._prev_pose = None
        self.combine_kwargs = {}
        # replay the reference's npy-flow resize/uint16 quirks
        # (panoptic_fpn.py:310-344) bit-for-bit
        self.bitcompat_flow = False
        # reproject ref depth through relative extrinsics before the
        # depth-ordered splat (reference depth_proj_op path)
        self.depth_proj = False
        self.intrinsics = None  # (fx, fy, cx, cy) for depth_proj

    def _flow_dtype(self):
        # the splat truncates to integer offsets; flow is rounded through
        # f16 as the JAX package ships it, except for the bit-compatible
        # replay, whose uint16 cast must see the exact values
        return torch.float32 if self.bitcompat_flow else torch.float16

    def _depth_dtype(self):
        return (torch.float32 if (self.bitcompat_flow or self.depth_proj)
                else torch.float16)

    def stage_inputs(self, flow=None, depth=None):
        """Start the uploads of a future frame's host flow/depth now
        (rounded as :meth:`submit` rounds them, non-blocking from pinned
        memory), returning device tensors :meth:`submit` takes as they
        are. ``depth`` may be the VO export's 1/8-res map."""
        return (self._upload(flow, self._flow_dtype()),
                self._upload(depth, self._depth_dtype()))

    @torch.no_grad()
    def _run(self, x_u8, feats_ref=None, flow=None, depth=None,
             pose_ref=None, pose_cur=None, bitcompat=False):
        x = x_u8.to(self.dtype)
        H, W = x.shape[2:]
        m = self.model
        feats = m.features(x)
        run_feats = feats
        if feats_ref is not None:
            with record_function("vps.fusion"):
                if pose_ref is not None:
                    depth = pose_transport_depth(depth, pose_ref, pose_cur,
                                                 self.intrinsics)
                warp = flow_warp_features(feats_ref, flow, depth,
                                          bitcompat=bitcompat)
                run_feats = m.fuse(feats, warp)
        sem_logits, dets = m.heads(run_feats, (H, W),
                                   max_dets=self.max_dets)
        sem = torch.argmax(sem_logits[0], dim=0).to(torch.uint8)
        dets = {k: v.float() if v.is_floating_point() else v
                for k, v in dets.items()}
        return sem, dets, feats

    def _upload(self, a, dt):
        """A host array or a device tensor (or None) as an f32 device
        tensor rounded through ``dt``. A device tensor is rounded on the
        device; a host array on the host, then copied from pinned memory
        without blocking the host."""
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(self.device).to(dt).float()
        t = torch.from_numpy(np.asarray(a, np.float32)).to(dt)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True).float()

    def submit(self, image_bgr, video_id=None, flow=None, depth=None,
               pose_w2c=None):
        """Dispatch the dense path for one frame. Returns a pending handle
        for :meth:`result`; the readbacks are queued here. The fusion state
        advances at submit time, so submitting frame t+1 before resolving
        frame t keeps the video's semantics.

        flow: (H, W, 2) ref -> cur, a host array or a device tensor (the
        loop mode: VO produced it on the card); depth likewise, at any
        resolution. A device-resident depth is taken in f32, as the JAX
        package takes it."""
        H0, W0 = image_bgr.shape[:2]
        ph = (-H0) % 32
        pw = (-W0) % 32
        image_bgr = np.asarray(image_bgr)
        if ph or pw:
            image_bgr = np.pad(image_bgr, ((0, ph), (0, pw), (0, 0)))
        x = torch.from_numpy(np.ascontiguousarray(
            np.clip(image_bgr, 0, 255).astype(np.uint8)))
        x = x.to(self.device, non_blocking=True).permute(2, 0, 1)[None]
        fusion = (flow is not None and video_id is not None and
                  video_id == self._video_id and self._prev is not None)
        if fusion:
            if depth is None:
                d = None
            elif isinstance(depth, torch.Tensor):
                d = depth.to(self.device).float()
            else:
                d = self._upload(depth, self._depth_dtype())
            depth_proj = (d is not None and self.depth_proj and
                          pose_w2c is not None and
                          self._prev_pose is not None)
            pose = (lambda p: torch.as_tensor(
                np.asarray(p, np.float32), device=self.device))
            sem_dev, dets, feats_cur = self._run(
                x, self._prev, self._upload(flow, self._flow_dtype()), d,
                pose(self._prev_pose) if depth_proj else None,
                pose(pose_w2c) if depth_proj else None,
                bitcompat=self.bitcompat_flow)
        else:
            sem_dev, dets, feats_cur = self._run(x)

        self._prev = feats_cur
        self._video_id = video_id
        self._prev_pose = pose_w2c
        if self.device.type == "cuda":
            # queue the readbacks behind the frame's kernels
            sem_dev = sem_dev.to("cpu", non_blocking=True)
            dets = {k: v.to("cpu", non_blocking=True)
                    for k, v in dets.items()}
            done = torch.cuda.Event()
            done.record()
        else:
            done = None
        return (sem_dev, dets, (H0, W0), done)

    def result(self, pending):
        """Resolve a :meth:`submit` handle: wait for the readbacks, then
        the host panoptic stitch. Returns (pan, segments_info, sem, dets);
        ``sem`` is a (H, W) uint8 map of contiguous semantic class ids."""
        sem_dev, dets, (H0, W0), done = pending
        if done is not None:
            done.synchronize()
        sem = sem_dev.numpy()[:H0, :W0]
        dets_np = {k: v.numpy() for k, v in dets.items()}
        with record_function("vps.stitch"):
            pan, segs = combine_panoptic(dets_np, sem,
                                         **self.combine_kwargs)
        return pan, segs, sem, dets_np

    def __call__(self, image_bgr, video_id=None, flow=None, depth=None,
                 pose_w2c=None):
        """image_bgr: (H, W, 3) float/uint8 BGR. pose_w2c: optional (4, 4)
        world-to-camera extrinsic for the depth_proj path. Returns
        (panoptic (H, W) int32, segments_info, sem_seg uint8, dets).

        Inputs whose H/W are not multiples of 32 are zero-padded
        bottom/right (detectron2's ImageList size_divisibility) and the
        semantic map cropped back; boxes are clipped to the padded size.
        """
        return self.result(self.submit(image_bgr, video_id, flow, depth,
                                       pose_w2c))
