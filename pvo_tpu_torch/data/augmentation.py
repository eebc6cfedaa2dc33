"""Training-time augmentation for RGB-D clips (port of
:mod:`pvo_tpu.data.augmentation`, the same numpy/cv2 code: one rng gives
the same clips as the JAX package's; cv2 is imported where it is used).

Rebuild of the reference RGBDAugmentor (VO_Module/droid_slam/
data_readers/augmentation.py): color jitter, random log-scale resize +
crop with intrinsics adjustment, and matching downsampling of segment
maps to network (1/8) resolution. Host-side numpy/cv2 (data pipeline).
"""

from __future__ import annotations

import numpy as np


def color_jitter(images, rng, brightness=0.25, contrast=0.25,
                 saturation=0.25, hue=0.1):
    """images: (F, H, W, 3) float RGB in [0, 255]."""
    x = images.astype(np.float32) / 255.0
    b = 1.0 + rng.uniform(-brightness, brightness)
    c = 1.0 + rng.uniform(-contrast, contrast)
    s = 1.0 + rng.uniform(-saturation, saturation)
    h = rng.uniform(-hue, hue)

    x = x * b
    mean = x.mean(axis=(1, 2, 3), keepdims=True)
    x = (x - mean) * c + mean
    gray = x.mean(axis=-1, keepdims=True)
    x = (x - gray) * s + gray
    # cheap hue rotation: roll channels proportionally
    if abs(h) > 1e-3:
        x = (1 - abs(h)) * x + abs(h) * np.roll(x, 1 if h > 0 else -1,
                                                axis=-1)
    return np.clip(x, 0, 1) * 255.0


def resize_crop(images, depths, intrinsics, crop_size, rng,
                scale_jitter=True, segments=None, masks=None):
    """Random log-uniform up-scale then random crop, adjusting
    intrinsics (reference augmentation.py:57-139). ``masks``:
    optional (F, H, W, C) per-pixel labels (gt dynamic masks +
    validity, reference base.py:189-218) — resized NEAREST and
    cropped like depth, returned at full crop resolution."""
    F, H, W = images.shape[:3]
    ch, cw = crop_size

    min_scale = max(ch / H, cw / W)
    if scale_jitter:
        scale = 2 ** rng.uniform(np.log2(min_scale) if min_scale > 1
                                 else 0.0, 0.25)
        scale = max(scale, min_scale)
    else:
        scale = max(min_scale, 1.0)

    nH, nW = int(round(H * scale)), int(round(W * scale))
    try:
        import cv2
    except ImportError:
        raise RuntimeError("cv2 required for augmentation") from None

    imgs = np.stack([cv2.resize(im, (nW, nH)) for im in images])
    deps = np.stack([cv2.resize(d, (nW, nH),
                                interpolation=cv2.INTER_NEAREST)
                     for d in depths])
    intr = intrinsics * np.array([nW / W, nH / H, nW / W, nH / H],
                                 np.float32)

    y0 = rng.integers(0, nH - ch + 1)
    x0 = rng.integers(0, nW - cw + 1)
    imgs = imgs[:, y0:y0 + ch, x0:x0 + cw]
    deps = deps[:, y0:y0 + ch, x0:x0 + cw]
    intr = intr - np.array([0, 0, x0, y0], np.float32)

    out_seg = None
    if segments is not None:
        segs = np.stack([cv2.resize(
            s.astype(np.float32), (nW, nH),
            interpolation=cv2.INTER_NEAREST) for s in segments])
        segs = segs[:, y0:y0 + ch, x0:x0 + cw]
        # 1/8 resolution for the network (augmentation.py:136-138)
        out_seg = segs[:, 3::8, 3::8].astype(np.int32)

    out_masks = None
    if masks is not None:
        out_masks = np.stack([cv2.resize(
            m.astype(np.float32), (nW, nH),
            interpolation=cv2.INTER_NEAREST) for m in masks])
        out_masks = out_masks[:, y0:y0 + ch, x0:x0 + cw]

    return imgs, deps, intr, out_seg, out_masks


def augment_clip(images, depths, intrinsics, crop_size, rng,
                 segments=None, masks=None, do_jitter=True):
    if do_jitter and rng.random() < 0.5:
        images = color_jitter(images, rng)
    return resize_crop(images, depths, intrinsics, crop_size, rng,
                       segments=segments, masks=masks)
