#!/bin/bash
# The port's twin of tools/initial_segmentation.sh: plain Panoptic FPN
# over the clone + 15-deg-left views, PNGs into datasets/.../panFPN_segm/.
# Usage: initial_segmentation.sh [DATA [WEIGHTS [DEVICE]]]; DEVICE is
# cuda (the default) or cpu.
set -e
DATA=${1:-datasets/Virtual_KITTI2}
WEIGHTS=${2:-}
DEVICE=${3:-cuda}
python -m pvo_tpu_torch.scripts.initial_segmentation --datapath "$DATA" \
    ${WEIGHTS:+--weights "$WEIGHTS"} --device "$DEVICE"
