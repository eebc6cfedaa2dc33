"""Panoptic quality (PQ) and video panoptic quality (VPQ) metrics (the
port's own copy of :mod:`pvo_tpu.pipeline.pq`).

Self-contained rebuild of the reference's vendored panopticapi
pq_compute (VPS_Module/detectron2/evaluation/pq_compute.py, keyed by
trainId) and the tube-based VPQ of tools/4_eval_vpq.py: a k-frame tube
is matched as one segment set (areas summed over the tube), TP at tube
IoU > 0.5 with VOID/crowd discounting, and VPQ reported as the average
over window sizes k in {1, 5, 10, 15, 20}.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

OFFSET = 256 * 256 * 256
VOID = 0


class PQStatCat:
    __slots__ = ("iou", "tp", "fp", "fn")

    def __init__(self):
        self.iou = 0.0
        self.tp = 0
        self.fp = 0
        self.fn = 0

    def __iadd__(self, other):
        self.iou += other.iou
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        return self


class PQStat:
    def __init__(self):
        self.per_cat: Dict[int, PQStatCat] = defaultdict(PQStatCat)

    def __getitem__(self, cat):
        return self.per_cat[cat]

    def __iadd__(self, other):
        for cat, st in other.per_cat.items():
            self.per_cat[cat] += st
        return self

    def average(self, categories: Dict[int, dict], isthing=None):
        pq = sq = rq = 0.0
        n = 0
        per_class = {}
        for cat_id, info in categories.items():
            if isthing is not None and bool(info["isthing"]) != isthing:
                continue
            st = self.per_cat[cat_id]
            tp, fp, fn = st.tp, st.fp, st.fn
            if tp + fp + fn == 0:
                per_class[cat_id] = {"pq": 0.0, "sq": 0.0, "rq": 0.0}
                continue
            n += 1
            pq_c = st.iou / (tp + 0.5 * fp + 0.5 * fn)
            sq_c = st.iou / tp if tp else 0.0
            rq_c = tp / (tp + 0.5 * fp + 0.5 * fn)
            per_class[cat_id] = {"pq": pq_c, "sq": sq_c, "rq": rq_c,
                                 "tp": tp, "fp": fp, "fn": fn}
            pq += pq_c
            sq += sq_c
            rq += rq_c
        if n == 0:
            return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}, per_class
        return ({"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n},
                per_class)


def _segments_by_id(segments_info: Sequence[dict]):
    out = {}
    for el in segments_info:
        sid = int(el["id"])
        if sid in out:
            out[sid]["area"] += el.get("area", 0)
        else:
            out[sid] = dict(el)
    return out


def tube_pq_stat(gt_maps, pred_maps, gt_segments, pred_segments,
                 categories):
    """PQ statistics for ONE tube (list of aligned frames).

    gt_maps/pred_maps: lists of (H, W) int id maps; *_segments: lists
    of segments_info lists. For k=1 this is plain per-frame PQ.
    """
    vid_gt = np.stack(gt_maps).astype(np.uint64)
    vid_pred = np.stack(pred_maps).astype(np.uint64)

    gt_segs: Dict[int, dict] = {}
    pred_segs: Dict[int, dict] = {}
    for m, s in zip(gt_maps, gt_segments):
        # GT areas are TRUSTED from segments_info (the reference never
        # recomputes them from the PNG — pq_compute.py:88,
        # 4_eval_vpq.py:96-100); only predictions get their areas
        # recounted below
        frame = _segments_by_id(s)
        for k, v in frame.items():
            if k in gt_segs:
                gt_segs[k]["area"] += v.get("area", 0)
            else:
                gt_segs[k] = dict(v)
    for m, s in zip(pred_maps, pred_segments):
        frame = _segments_by_id(s)
        ids, cnt = np.unique(m, return_counts=True)
        for i, c in zip(ids, cnt):
            if int(i) in frame:
                frame[int(i)]["area"] = int(c)
        for k, v in frame.items():
            if k in pred_segs:
                pred_segs[k]["area"] += v.get("area", 0)
            else:
                pred_segs[k] = dict(v)

    # intersection-area histogram — the evaluation hot loop; runs in
    # the native hash-count helper when it builds (pvo_tpu_torch.native)
    from pvo_tpu_torch import native
    labels, counts = native.pair_counts(
        vid_gt.astype(np.int64), vid_pred.astype(np.int64), OFFSET)
    gt_pred_map = {(int(l // OFFSET), int(l % OFFSET)): int(c)
                   for l, c in zip(labels, counts)}

    stat = PQStat()
    gt_matched, pred_matched = set(), set()
    for (g, p), inter in gt_pred_map.items():
        if g not in gt_segs or p not in pred_segs:
            continue
        ginfo, pinfo = gt_segs[g], pred_segs[p]
        if ginfo.get("iscrowd", 0) == 1:
            continue
        if ginfo["category_id"] != pinfo["category_id"]:
            continue
        union = (pinfo["area"] + ginfo["area"] - inter -
                 gt_pred_map.get((VOID, p), 0))
        iou = inter / union if union > 0 else 0.0
        if iou > 0.5:
            cat = ginfo["category_id"]
            stat[cat].tp += 1
            stat[cat].iou += iou
            gt_matched.add(g)
            pred_matched.add(p)

    crowd_by_cat = {}
    for g, info in gt_segs.items():
        if g in gt_matched:
            continue
        if info.get("iscrowd", 0) == 1:
            crowd_by_cat[info["category_id"]] = g
            continue
        stat[info["category_id"]].fn += 1

    for p, info in pred_segs.items():
        if p in pred_matched:
            continue
        inter = gt_pred_map.get((VOID, p), 0)
        if info["category_id"] in crowd_by_cat:
            inter += gt_pred_map.get(
                (crowd_by_cat[info["category_id"]], p), 0)
        if info["area"] > 0 and inter / info["area"] > 0.5:
            continue
        stat[info["category_id"]].fp += 1

    return stat


def _pq_worker(args):
    gt_maps, pred_maps, gt_segments, pred_segments, categories = args
    stat = PQStat()
    for g, p, gs, ps in zip(gt_maps, pred_maps, gt_segments,
                            pred_segments):
        stat += tube_pq_stat([g], [p], [gs], [ps], categories)
    return stat


def pq_compute(gt_maps, pred_maps, gt_segments, pred_segments,
               categories, workers=None):
    """Per-frame PQ over a dataset (the reference pq_compute keyed by
    trainId). ``workers``: number of processes for the per-frame stats
    (reference pq_compute_multi_core, pq_compute.py:217-236 splits the
    annotation list over cpu_count()//2 workers); None/0/1 runs
    single-process (the right call below ~hundreds of frames — the C
    hash kernel makes one frame ~ms-scale)."""
    n = len(gt_maps)
    if workers is None:
        workers = 0
    if workers in (0, 1) or n < 2 * workers:
        stat = _pq_worker((gt_maps, pred_maps, gt_segments,
                           pred_segments, categories))
    else:
        import multiprocessing as mp
        bounds = np.linspace(0, n, workers + 1).astype(int)
        chunks = [(gt_maps[a:b], pred_maps[a:b], gt_segments[a:b],
                   pred_segments[a:b], categories)
                  for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        stat = PQStat()
        with mp.get_context("fork").Pool(len(chunks)) as pool:
            for part in pool.map(_pq_worker, chunks):
                stat += part
    res = {}
    for name, flag in (("All", None), ("Things", True),
                       ("Stuff", False)):
        avg, per_class = stat.average(categories, isthing=flag)
        res[name] = avg
    return res, stat


def vpq_compute(gt_maps, pred_maps, gt_segments, pred_segments,
                categories, windows=(1, 5, 10, 15, 20)):
    """VPQ over one sequence: PQ of all k-frame tubes, for each window
    size, then the average across windows (reference
    4_eval_vpq.py:296-314)."""
    results = {}
    for k in windows:
        stat = PQStat()
        for idx in range(0, len(gt_maps) - k + 1):
            sl = slice(idx, idx + k)
            stat += tube_pq_stat(gt_maps[sl], pred_maps[sl],
                                 gt_segments[sl], pred_segments[sl],
                                 categories)
        entry = {}
        for name, flag in (("All", None), ("Things", True),
                           ("Stuff", False)):
            avg, _ = stat.average(categories, isthing=flag)
            entry[name] = avg
        results[k] = entry

    avg = {}
    for name in ("All", "Things", "Stuff"):
        avg[name] = {
            m: float(np.mean([results[k][name][m] for k in windows]))
            for m in ("pq", "sq", "rq")}
    return avg, results


def vkitti_categories():
    from pvo_tpu_torch.vps.categories import VKITTI_CATEGORIES
    return {c["trainId"]: {"isthing": c["isthing"], "name": c["name"]}
            for c in VKITTI_CATEGORIES}
