"""Global bundle adjustment backend (port of :mod:`pvo_tpu.vo.backend`).

Normalize the video, build a fresh full-history factor graph from
proximity factors, and run the low-memory update loop: beyond
``edge_chunk`` edges the update streams over edge chunks with the fused
correlation kernel (K3) and keeps the hidden state in bf16. Its
update's profiler ranges are ``vo.backend.{volume,update,dba}``.
"""

from __future__ import annotations

import torch

from pvo_tpu_torch.vo.factor_graph import FactorGraph


class Backend:
    def __init__(self, video, cfg, update, max_edges=8192, edge_chunk=256):
        self.video = video
        self.cfg = cfg
        self.update = update
        self.max_edges = max_edges
        self.edge_chunk = edge_chunk

    def __call__(self, steps=12):
        cfg = self.cfg
        self.video.normalize()
        graph = FactorGraph(
            self.video, self.update, max_edges=self.max_edges,
            max_inactive=1, edge_chunk=self.edge_chunk,
            net_dtype=torch.bfloat16)
        graph.layer = "vo.backend"
        # add_proximity_factors counts 2 entries per (i, j) pair, so
        # max_edges // 2 admits exactly max_edges edges
        graph.add_proximity_factors(
            rad=cfg.backend_radius, nms=cfg.backend_nms,
            thresh=cfg.backend_thresh, beta=cfg.beta,
            max_new=self.max_edges // 2)
        graph.update_lowmem(steps=steps)
        graph.clear_edges()
