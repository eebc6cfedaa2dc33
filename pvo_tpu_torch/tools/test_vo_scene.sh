#!/bin/bash
# The port's twin of tools/test_vo_scene.sh: per-scene pose evaluation
# and flow/depth export over the 5 vkitti2 scenes.
# Usage: test_vo_scene.sh [DATA [WEIGHTS [DEVICE]]]; DEVICE is cuda (the
# default) or cpu.
set -e
DATA=${1:-datasets/Virtual_KITTI2}
WEIGHTS=${2:-}
DEVICE=${3:-cuda}
for s in Scene01 Scene02 Scene06 Scene18 Scene20; do
    python -m pvo_tpu_torch.scripts.test_vo --datapath "$DATA/$s" \
        --segm_filter ${WEIGHTS:+--weights "$WEIGHTS"} --device "$DEVICE"
    python -m pvo_tpu_torch.scripts.test_vo2 --datapath "$DATA/$s" \
        ${WEIGHTS:+--weights "$WEIGHTS"} --device "$DEVICE"
done
