"""The camera stream every cell tracks: a random texture (from the
seed) sliding under a fixed motion, and a panoptic map of about 90
segments a frame (4x4 cells at 1/8 resolution) moving with it.

Frozen from the program's bench scripts (``synth_stream``), with the
texture drawn by a generator that takes any seed. The motion, the
segments and the intrinsics (vkitti2's focal length, scaled to the
width) do not depend on the seed, so every seed gives the same sizes and
the same amount of motion.
"""

from __future__ import annotations

import numpy as np

SEGMENTS = 90


class Stream:
    def __init__(self, seed, height, width):
        rng = np.random.default_rng(int(seed))
        self.H, self.W = height, width
        self.base = rng.integers(0, 255, (height + 64, width + 64, 3),
                                 dtype=np.uint8)
        self.h, self.w = height // 8, width // 8
        self.yy, self.xx = np.meshgrid(np.arange(self.h), np.arange(self.w),
                                       indexing="ij")
        f = 725.0087 * width / 1242
        self.intr = np.array([f, f, width / 2.0, height / 2.0], np.float32)

    def frame(self, t, ts=None):
        """(timestamp, image (H, W, 3) uint8, intrinsics (4,), segments
        (h, w)) of frame ``t``; the timestamp is ``t`` unless ``ts``
        gives it."""
        dy, dx = (2 * t) % 64, (3 * t) % 64
        segm = ((((self.yy + t) // 4) * (self.w // 4 + 1) +
                 (self.xx + 2 * t) // 4) % SEGMENTS + 1).astype(
                     np.int32) * 10000 + 3
        return (t if ts is None else ts,
                self.base[dy:dy + self.H, dx:dx + self.W], self.intr, segm)

    def frames(self, n):
        return [self.frame(t) for t in range(n)]
