"""Keyframe admission by predicted flow magnitude (port of
:mod:`pvo_tpu.vo.motion_filter`).

Every incoming frame is encoded with fnet; a one-edge correlation
against the last keyframe plus one update-module iteration estimates
the mean flow; frames above the threshold become keyframes and get the
context encoder and a write into the video at slot ``counter``. The
host learns the decision when the probe is read; the counter is
committed by :meth:`MotionFilter.resolve_track`, one call later in the
system's track order (as in the JAX package). The planner's phase B is
:func:`track_body_device`, which decides on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.vo.net import corr as corr_ops
from pvo_tpu_torch.vo.net import cuda_corr
from pvo_tpu_torch.vo.net.droidnet import normalize_images


def _probe(update, fmap_prev, gmap, net, inp):
    """Mean |flow delta| of one update iteration at zero flow; K3 on the
    card, the plain f32 lookup on the CPU."""
    h, w = gmap.shape[:2]
    coords0 = projective.coords_grid(h, w, device=gmap.device)[None]
    if gmap.is_cuda:
        corr = cuda_corr.corr_lookup(fmap_prev[None].contiguous(),
                                     gmap[None].contiguous(), coords0)
    else:
        corr = corr_ops.corr_and_lookup(fmap_prev[None].float(),
                                        gmap[None].float(), coords0)
    cdt = next(update.parameters()).dtype
    motion = torch.zeros((1, h, w, 8), dtype=cdt, device=gmap.device)
    out = update(net[None].to(cdt), inp[None].to(cdt), corr.to(cdt),
                 motion)
    return torch.linalg.norm(out["delta"].float(), dim=-1).mean()


def track_body(net, video, fmap_prev, net_prev, inp_prev, image, intr8,
               segm, ix, thresh, first):
    """One frame: encode, probe, and on admission encode the context and
    write slot ``ix`` of the video. Returns (admitted, new filter state
    (fmap, net, inp))."""
    x = normalize_images(image[None])
    gmap = net.fnet(x)[0]
    if first:
        admitted = True
    else:
        delta = _probe(net.update, fmap_prev, gmap, net_prev, inp_prev)
        admitted = bool(delta.item() > thresh)
    if not admitted:
        return False, (fmap_prev, net_prev, inp_prev)

    ctx = net.cnet(x)[0]
    hid, inp = ctx.split(128, dim=-1)
    hid, inp = torch.tanh(hid), torch.relu(inp)
    v = video
    v.fmaps[ix] = gmap.to(v.fmaps.dtype)
    v.nets[ix] = hid.to(v.nets.dtype)
    v.inps[ix] = inp.to(v.inps.dtype)
    v.segms[ix] = segm
    v.images[ix] = image
    v.intrinsics[ix] = intr8
    if first:
        v.poses[ix] = torch.tensor([0, 0, 0, 0, 0, 0, 1.0],
                                   device=v.poses.device)
        v.disps[ix] = 1.0
    return True, (gmap, hid, inp)


def track_body_device(net, video, fmap_prev, net_prev, inp_prev, image,
                      intr8, segm, ix, thresh):
    """:func:`track_body` with the decision left on the device (the
    planner's phase B): the probe's admission is a device bool, slot
    ``ix`` (a device index) of the video and the filter state
    (``fmap_prev``, ``net_prev``, ``inp_prev``, written in place) take
    the frame only where it holds, and nothing reads the card. The
    context encoder runs on every frame. Returns the admission."""
    x = normalize_images(image[None])
    gmap = net.fnet(x)[0]
    delta = _probe(net.update, fmap_prev, gmap, net_prev, inp_prev)
    admitted = delta > thresh
    ctx = net.cnet(x)[0]
    hid, inp = ctx.split(128, dim=-1)
    hid, inp = torch.tanh(hid), torch.relu(inp)
    v = video
    i = ix.reshape(1)
    for buf, val in ((v.fmaps, gmap), (v.nets, hid), (v.inps, inp),
                     (v.segms, segm), (v.images, image),
                     (v.intrinsics, intr8)):
        buf[i] = torch.where(admitted, val.to(buf.dtype)[None], buf[i])
    for buf, val in ((fmap_prev, gmap), (net_prev, hid), (inp_prev, inp)):
        buf.copy_(torch.where(admitted, val, buf))
    return admitted


class MotionFilter:
    def __init__(self, net, video, thresh=2.5):
        """``net``: the f32 :class:`DroidNet` (fnet, cnet, update)."""
        self.net = net
        self.video = video
        self.thresh = thresh
        self.count = 0
        h, w, dev = video.h, video.w, video.device
        self._fmap = torch.zeros((h, w, 128), device=dev)
        self._net = torch.zeros((h, w, 128), device=dev)
        self._inp = torch.zeros((h, w, 128), device=dev)

    def prepare(self, tstamp, image, intrinsics, segments=None):
        """Host-side per-frame inputs of :func:`track_body`."""
        v = self.video
        dev = v.device
        if segments is not None and v.segm_filter:
            segm = torch.as_tensor(v._remap_segments(segments),
                                   dtype=torch.long, device=dev)
        else:
            segm = torch.zeros((v.h, v.w), dtype=torch.long, device=dev)
        image = torch.as_tensor(np.ascontiguousarray(image),
                                dtype=torch.uint8).to(dev)
        intr8 = torch.as_tensor(np.asarray(intrinsics, np.float32),
                                device=dev) / 8.0
        return {"image": image, "intr8": intr8, "segm": segm,
                "thresh": float(self.thresh),
                "first": v.counter == 0, "tstamp": float(tstamp)}

    def track_async(self, tstamp, image, intrinsics, segments=None):
        """Run the frame now; the counter is committed by
        :meth:`resolve_track`. Returns the pending (admitted, tstamp)."""
        p = self.prepare(tstamp, image, intrinsics, segments)
        admitted, state = track_body(
            self.net, self.video, self._fmap, self._net, self._inp,
            p["image"], p["intr8"], p["segm"], self.video.counter,
            p["thresh"], p["first"])
        self._fmap, self._net, self._inp = state
        return admitted, p["tstamp"]

    def resolve_track(self, pending):
        """Commit a :meth:`track_async` decision: counter and tstamp."""
        admitted, tstamp = pending
        v = self.video
        if admitted:
            v.tstamp[v.counter] = tstamp
            v.counter += 1
            self.count = 0
        else:
            self.count += 1
        return admitted

    def track(self, tstamp, image, intrinsics, segments=None):
        """image: (H, W, 3) uint8 RGB; intrinsics (4,) full-res."""
        return self.resolve_track(self.track_async(
            tstamp, image, intrinsics, segments))
