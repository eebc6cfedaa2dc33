"""Stage 2 — instance id matching/propagation across frames (the port's
own copy of :mod:`pvo_tpu.pipeline.matching`).

Rebuild of reference VPS_Module/tools/2_matching.py: IoU-match the
flow-warped previous panoptic map against the current one over THING
segments (categories 12..14, everything else zeroed), propagate matched
instance ids, and mint fresh ``cat*10000 + empty_id`` ids for unmatched
segments. Best-match dedup keeps only the highest-IoU claimant per
warped segment.
"""

from __future__ import annotations

import numpy as np

OFFSET = 2 ** 30
MAX_INS = 10000
MAX_THING_CAT = 14


def _filter_thing(ps_map):
    out = ps_map.copy()
    cat = out // MAX_INS
    out[(cat > MAX_THING_CAT) | (cat == 0)] = 0
    return out


class InstanceMatcher:
    """Stateful per-sequence id propagation."""

    def __init__(self, start_id=1):
        self.empty_id = start_id
        self.ref_match = None

    def reset(self):
        self.ref_match = None

    def _fresh(self, cat):
        new_id = int(cat) * MAX_INS + self.empty_id
        self.empty_id += 1
        return new_id

    def __call__(self, cur_map, warped_prev_map):
        """cur_map: (H, W) fused panoptic ids of the current frame;
        warped_prev_map: previous frame's RELABELED ids warped to the
        current frame. Returns the relabeled current map."""
        pan_res = cur_map.copy()
        cur_things = _filter_thing(cur_map)
        pred_things = _filter_thing(warped_prev_map)

        if self.ref_match is None:
            self.ref_match = {}
            for item in np.unique(cur_things):
                if item == 0:
                    continue
                new_id = self._fresh(item // MAX_INS)
                pan_res[cur_things == item] = new_id
                self.ref_match[int(item)] = new_id
            return pan_res

        pred_areas = dict(zip(*np.unique(pred_things,
                                         return_counts=True)))
        int_ids = cur_things.astype(np.int64) * OFFSET + \
            pred_things.astype(np.int64)
        int_vals, int_areas = np.unique(int_ids, return_counts=True)

        # IoU-ish score: intersection / warped-pred area
        scores = {}
        for int_id, area in zip(int_vals, int_areas):
            gt_id = int(int_id // OFFSET)
            pred_id = int(int_id % OFFSET)
            if gt_id == 0 or pred_id == 0:
                continue
            if gt_id // MAX_INS != pred_id // MAX_INS:
                continue
            scores[(gt_id, pred_id)] = area / pred_areas[pred_id]

        # best warped segment per current segment
        best = {}
        for (g, p), s in scores.items():
            if g not in best or s > best[g][1]:
                best[g] = (p, s)

        # dedup: one claimant per warped segment (highest score)
        claimed = {}
        for g, (p, s) in best.items():
            if p not in claimed or s > best[claimed[p]][1]:
                claimed[p] = g

        cur_match = {}
        for item in np.unique(cur_things):
            if item == 0:
                continue
            g = int(item)
            cat = g // MAX_INS
            if g in best and claimed.get(best[g][0]) == g and \
                    best[g][0] in self.ref_match:
                new_id = self.ref_match[best[g][0]]
            else:
                new_id = self._fresh(cat)
            pan_res[cur_things == g] = new_id
            cur_match[g] = new_id

        self.ref_match = cur_match
        return pan_res


def match_sequence(cur_maps, warped_maps, start_id=1):
    """Relabel a whole sequence. warped_maps[i] must be the OUTPUT of
    tracking applied to the PREVIOUS relabeled map — the reference
    pipeline warps raw fused maps, so we warp-as-we-go here using the
    provided per-frame warp outputs keyed by raw ids, translating via
    the running match table."""
    m = InstanceMatcher(start_id)
    out = []
    for cur, warped in zip(cur_maps, warped_maps):
        out.append(m(cur, warped))
    return out
