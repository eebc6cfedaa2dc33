"""Configuration of the VO system: the port's own copy of the JAX
package's ``VOConfig`` (same fields, same defaults, held equal by
``tests/test_torch_kernel_bounds.py``). The port imports nothing of the
JAX package. ``pipeline`` engages the device-resident planner after
initialization, as in the JAX package (``False``: the classic host loop
on every frame). ``yuv420_upload`` is read by nothing in the port (no
upload packing); it stays so that one configuration drives both
packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class VOConfig:
    """Inference-time VO / SLAM configuration."""
    image_size: Tuple[int, int] = (240, 808)
    buffer: int = 512
    use_aff_bri: bool = False

    beta: float = 0.6
    filter_thresh: float = 1.75
    warmup: int = 12
    keyframe_thresh: float = 2.25
    frontend_thresh: float = 12.0
    frontend_window: int = 25
    frontend_radius: int = 2
    frontend_nms: int = 1
    max_age: int = 25
    frontend_iters1: int = 4
    frontend_iters2: int = 2

    backend_thresh: float = 15.0
    backend_radius: int = 2
    backend_nms: int = 3

    segm_filter: bool = False
    thresh: float = 0.8          # dynamic-segment vote threshold
    max_segments: int = 96       # static per-frame segment slots

    # the JAX package's frame upload packing; ignored here (frames are
    # uploaded as uint8 RGB)
    yuv420_upload: bool = True

    # the device-resident planner (vo/planner.py), engaged after
    # initialization; False keeps the classic host loop
    pipeline: bool = True

    # edge-store capacities
    max_edges: int = 128         # frontend active-edge bucket
    max_inactive: int = 96
    dtype_features: str = "bfloat16"

    @property
    def feat_hw(self):
        return self.image_size[0] // 8, self.image_size[1] // 8
