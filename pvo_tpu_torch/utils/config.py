"""Configuration of the VO system: the port's own copies of the JAX
package's ``VOConfig`` and ``TrainConfig`` (same fields, same defaults,
held equal by ``tests/test_torch_kernel_bounds.py`` and
``tests/test_torch_port_update_vanilla.py``). The port imports nothing
of the JAX package. ``pipeline`` engages the device-resident planner after
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


@dataclasses.dataclass
class TrainConfig:
    """VO training configuration (reference train.py defaults). The
    port's trainers take these settings as CLI arguments."""
    mode: str = "semisup"        # sup | semisup | unsup
    iters: int = 15
    n_frames: int = 6
    lr: float = 5e-4
    steps: int = 20000
    clip: float = 2.5
    crop_size: Tuple[int, int] = (200, 400)
    fmin: float = 8.0
    fmax: float = 96.0
    restart_prob: float = 0.2
    edges: int = 20
    aug_graph: bool = True       # 50% droid covis graph / 50% ring
    flow_label: bool = False
    use_aff_bri: bool = False
    downsample: bool = True
    ssim: bool = True
    ce_reg: bool = False
    con_loss: bool = False
    ph_loss: bool = True
    occ_ph: bool = False
    batch: int = 1
    # loss weights (reference train.py:362-381)
    w1: float = 40.0             # geodesic pose loss
    w2: float = 0.01             # residual loss
    w3: float = 0.20             # cam-flow loss
    w4: float = 5.0              # photometric loss
    w5: float = 0.001            # ce regularization
    w6: float = 0.05             # art-label (self-labeled mask) loss
    w7: float = 0.01             # consistency loss
    w8: float = 0.05             # flow loss
    w9: float = 0.01             # gt-label mask loss
    w10: float = 100.0           # cam photometric loss
    ckpt_every: int = 2000
