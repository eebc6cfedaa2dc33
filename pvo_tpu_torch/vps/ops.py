"""Detection ops of the port: box transforms, NMS and ROIAlign in plain
torch (there is no torchvision on the card's machine).

The port's own copy of :mod:`pvo_tpu.vps.ops`, with the same semantics:

  * box transforms as detectron2's Box2BoxTransform (weights, clamped
    dw/dh);
  * ``nms``: greedy suppression in score order, ties in input order (a
    stable sort, as ``jnp.argsort``). The (N, N) suppression matrix is
    formed once on the device and read back as packed bits; the greedy
    sweep then runs on the host, so a call waits for the device twice
    (the live count, the bits) and not once per pick;
  * ``roi_align_flat``: ROIAlign (aligned=True) with a fixed
    ``samples x samples`` grid per bin, each box pooling from its own level
    of a flat buffer. The four bilinear corners of every sample are one
    weighted bag of ``F.embedding_bag``, so the (R, bins * samples^2, C)
    gathers are never materialized: the output is the largest tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def encode_boxes(src, target, weights=(1.0, 1.0, 1.0, 1.0)):
    """Box2BoxTransform.get_deltas (src=anchors/proposals)."""
    wx, wy, ww, wh = weights
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    sx = src[..., 0] + 0.5 * sw
    sy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tx = target[..., 0] + 0.5 * tw
    ty = target[..., 1] + 0.5 * th
    return torch.stack([
        wx * (tx - sx) / sw, wy * (ty - sy) / sh,
        ww * torch.log(tw / sw), wh * torch.log(th / sh)], dim=-1)


def decode_boxes(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """Box2BoxTransform.apply_deltas."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3] / wh, max=BBOX_XFORM_CLIP)

    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def clip_boxes(boxes, height, width):
    x0 = torch.clamp(boxes[..., 0], 0, width)
    y0 = torch.clamp(boxes[..., 1], 0, height)
    x1 = torch.clamp(boxes[..., 2], 0, width)
    y1 = torch.clamp(boxes[..., 3], 0, height)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def box_area(boxes):
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)


def box_iou(a, b):
    """IoU matrix (N, M) for (N,4) x (M,4)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def _pack_rows(mask):
    """(m, n) bool -> (m, ceil(n / 8)) uint8, bit k of byte q = column
    8q + k (little-endian bit order)."""
    m, n = mask.shape
    pad = (-n) % 8
    if pad:
        mask = F.pad(mask, (0, pad))
    bits = mask.view(m, -1, 8).to(torch.uint8)
    shifts = torch.arange(8, device=mask.device, dtype=torch.uint8)
    return (bits << shifts).sum(-1, dtype=torch.uint8)


def greedy_sweep(rows, alive, max_out):
    """The greedy pass over a packed suppression matrix on the host.

    rows: (m, bytes) uint8 numpy, row i's bit j set where box j (later in
    score order) overlaps box i past the threshold; alive: (m,) bool.
    Returns the kept positions, at most ``max_out``, in score order."""
    keep = []
    removed = 0
    for i in range(len(alive)):
        if not alive[i] or (removed >> i) & 1:
            continue
        keep.append(i)
        if len(keep) == max_out:
            break
        removed |= int.from_bytes(rows[i].tobytes(), "little")
    return keep


def nms(boxes, scores, iou_threshold, max_out):
    """Greedy NMS. Returns (keep_indices (max_out,), keep_valid).

    Boxes with a non-finite score are ignored. Indices refer to the input
    order; padded outputs carry the index of the best-scored box with
    valid=False (as :func:`pvo_tpu.vps.ops.nms`)."""
    with record_function("vps.nms"):
        return _nms(boxes, scores, iou_threshold, max_out)


def _nms(boxes, scores, iou_threshold, max_out):
    dev = boxes.device
    # NaN sorts last, as in jnp.argsort(-scores)
    key = torch.nan_to_num(scores, nan=-torch.inf, posinf=torch.inf,
                           neginf=-torch.inf)
    s, order = torch.sort(key, descending=True, stable=True)
    alive = torch.isfinite(s).cpu().numpy()
    live = np.flatnonzero(alive)
    m = int(live[-1]) + 1 if live.size else 0
    keep = []
    if m:
        b = boxes[order[:m]]
        sup = torch.triu(box_iou(b, b) > iou_threshold, diagonal=1)
        keep = greedy_sweep(_pack_rows(sup).cpu().numpy(), alive[:m],
                            max_out)
    pos = np.zeros(max_out, np.int64)
    pos[:len(keep)] = keep
    valid = np.zeros(max_out, bool)
    valid[:len(keep)] = True
    pos = torch.from_numpy(pos).to(dev, non_blocking=True)
    valid = torch.from_numpy(valid).to(dev, non_blocking=True)
    return order[pos], valid


def batched_nms(boxes, scores, class_ids, iou_threshold, max_out):
    """Per-class NMS via the coordinate-offset trick."""
    max_coord = torch.max(boxes) + 1.0
    offsets = class_ids.to(boxes.dtype)[:, None] * max_coord
    return nms(boxes + offsets, scores, iou_threshold, max_out)


def roi_align(features, boxes, out_size=7, spatial_scale=1.0, samples=2):
    """ROIAlign (aligned=True) on one feature map.

    features: (C, H, W); boxes: (R, 4) in image coords.
    Returns (R, C, out_size, out_size).
    """
    C, H, W = features.shape
    R = boxes.shape[0]
    dev = boxes.device
    return roi_align_flat(
        features.reshape(C, H * W).t(), boxes * spatial_scale,
        torch.full((R,), H, dtype=torch.int64, device=dev),
        torch.full((R,), W, dtype=torch.int64, device=dev),
        torch.zeros(R, dtype=torch.int64, device=dev),
        out_size=out_size, samples=samples)


def roi_align_flat(flat, boxes, Hb, Wb, offb, out_size=7, samples=2):
    """ROIAlign (aligned=True) from a FLAT (N, C) feature buffer with
    per-box geometry: box ``r`` reads rows ``offb[r] + y * Wb[r] + x`` of
    a level that is ``Hb[r]`` x ``Wb[r]``, with ``boxes`` already in that
    level's pixel scale. Returns (R, C, out_size, out_size) in ``flat``'s
    dtype; the sample positions and weights are formed in ``boxes``'
    dtype.

    Each output bin is the mean over its ``samples^2`` points of the
    bilinear blend of four corners, a corner outside the level counting
    zero (:func:`pvo_tpu.vps.ops.roi_align_flat`): one bag of
    ``4 * samples^2`` weighted rows of ``flat``.
    """
    with record_function("vps.roi_align"):
        return _roi_align_flat(flat, boxes, Hb, Wb, offb, out_size, samples)


def _roi_align_flat(flat, boxes, Hb, Wb, offb, out_size, samples):
    C = flat.shape[1]
    R = boxes.shape[0]
    dt = boxes.dtype
    b = boxes - 0.5  # aligned=True half-pixel shift
    x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    bw = (x1 - x0) / out_size
    bh = (y1 - y0) / out_size

    ix = torch.arange(out_size, dtype=dt, device=boxes.device)
    sx = (torch.arange(samples, dtype=dt, device=boxes.device) + 0.5) / \
        samples
    grid = ix[None, :, None] + sx[None, None, :]          # (1, out, s)
    gx = x0[:, None, None] + grid * bw[:, None, None]     # (R, out, s)
    gy = y0[:, None, None] + grid * bh[:, None, None]

    # sample positions ordered (R, bin_y, bin_x, sy, sx)
    shape = (R, out_size, out_size, samples, samples)
    ys = gy[:, :, None, :, None].expand(shape).reshape(R, -1)
    xs = gx[:, None, :, None, :].expand(shape).reshape(R, -1)
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    fy = ys - y0f
    fx = xs - x0f

    Hf = Hb.to(dt)[:, None]
    Wf = Wb.to(dt)[:, None]
    Wi = Wb[:, None]
    off = offb[:, None]
    idx, wts = [], []
    for yi, xi, w in ((y0f, x0f, (1 - fy) * (1 - fx)),
                      (y0f, x0f + 1, (1 - fy) * fx),
                      (y0f + 1, x0f, fy * (1 - fx)),
                      (y0f + 1, x0f + 1, fy * fx)):
        inb = (yi >= 0) & (yi < Hf) & (xi >= 0) & (xi < Wf)
        yc = torch.minimum(torch.clamp(yi, min=0), Hf - 1).long()
        xc = torch.minimum(torch.clamp(xi, min=0), Wf - 1).long()
        idx.append(off + yc * Wi + xc)
        wts.append(w * inb)
    n = out_size * out_size
    s2 = samples * samples
    # (R, 4, bins * s2) -> one bag of 4 * s2 rows per (box, bin)
    idx = torch.stack(idx, 1).view(R, 4, n, s2).permute(0, 2, 1, 3)
    wts = torch.stack(wts, 1).view(R, 4, n, s2).permute(0, 2, 1, 3) / s2
    out = F.embedding_bag(idx.reshape(R * n, 4 * s2), flat,
                          per_sample_weights=wts.reshape(R * n, 4 * s2)
                          .to(flat.dtype), mode="sum")
    return out.view(R, out_size, out_size, C).permute(0, 3, 1, 2)
