"""Panoptic evaluation collector (the port's own copy of
:mod:`pvo_tpu.pipeline.evaluator`).

Rebuild of the reference's modified COCOPanopticEvaluator
(VPS_Module/detectron2/evaluation/panoptic_evaluation.py:25-203): writes
prediction PNGs to ``<output>/pan_seg/`` (the persistent location the
downstream tracking stages read — the PVO delta vs stock detectron2,
which used a tempdir), collects segments_info, and computes PQ keyed by
trainId.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import List

import numpy as np


class PanopticEvaluator:
    def __init__(self, output_dir):
        self.output_dir = output_dir
        self.pan_dir = osp.join(output_dir, "pan_seg")
        os.makedirs(self.pan_dir, exist_ok=True)
        self.reset()

    def reset(self):
        self._predictions: List[dict] = []
        self._maps = {}

    def process(self, file_name, panoptic_map, segments_info):
        """Persist one prediction PNG + record its segments."""
        from PIL import Image

        from pvo_tpu_torch.utils.io import id2rgb

        base = osp.splitext(osp.basename(file_name))[0] + ".png"
        Image.fromarray(id2rgb(panoptic_map)).save(
            osp.join(self.pan_dir, base))
        self._predictions.append({"file_name": base,
                                  "segments_info": segments_info})
        self._maps[base] = np.asarray(panoptic_map)

    def evaluate(self, gt_maps, gt_segments, categories=None):
        """PQ over collected predictions vs aligned ground truth."""
        from .pq import pq_compute, vkitti_categories

        categories = categories or vkitti_categories()
        pred_maps = [self._maps[p["file_name"]]
                     for p in self._predictions]
        pred_segs = [p["segments_info"] for p in self._predictions]
        res, stat = pq_compute(gt_maps, pred_maps, gt_segments,
                               pred_segs, categories)
        with open(osp.join(self.output_dir, "pq_results.json"),
                  "w") as f:
            json.dump({k: v for k, v in res.items()}, f, indent=2)
        self._print_table(res)
        return res

    @staticmethod
    def _print_table(res):
        print(f"{'':10s}{'PQ':>8s}{'SQ':>8s}{'RQ':>8s}{'#cat':>6s}")
        for name in ("All", "Things", "Stuff"):
            r = res[name]
            print(f"{name:10s}{100 * r['pq']:8.2f}"
                  f"{100 * r['sq']:8.2f}{100 * r['rq']:8.2f}"
                  f"{r['n']:6d}")
