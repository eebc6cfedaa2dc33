#!/bin/bash
# The port's twin of tools/test_vps.sh: fused VPS, tracking, matching and
# VPQ per vkitti2 scene.
# Usage: test_vps.sh [DATA [WEIGHTS [DEVICE]]]; DEVICE is cuda (the
# default) or cpu.
set -e
DATA=${1:-datasets/Virtual_KITTI2}
WEIGHTS=${2:-}
DEVICE=${3:-cuda}
for s in Scene01 Scene02 Scene06 Scene18 Scene20; do
    python -m pvo_tpu_torch.scripts.test_vps --datapath "$DATA" --scene "$s" \
        ${WEIGHTS:+--weights "$WEIGHTS"} --device "$DEVICE"
done
