"""Sliding-window local bundle adjustment frontend (port of
:mod:`pvo_tpu.vo.frontend`).

Initialization at ``warmup`` keyframes (neighborhood factors + 8
updates, proximity factors + 12 updates), then per keyframe: age-based
factor retirement, proximity proposal, 4+2 recurrent updates, redundant
keyframe removal. The packet protocol of the JAX package is kept in
order: each update returns a host packet (removal-probe distance + the
window distance matrix) that is applied at the start of the NEXT
keyframe's update, so the removal decision and the distances used for
the proposal are exactly the ones the reference host logic sees.
"""

from __future__ import annotations

import numpy as np

DMAT_WINDOW = 32


class Frontend:
    def __init__(self, graph, video, cfg):
        self.graph = graph
        self.video = video
        self.cfg = cfg

        self.t0 = 0
        self.t1 = 0
        self.is_initialized = False
        self.count = 0

        self.max_age = cfg.max_age
        self.iters1 = cfg.frontend_iters1
        self.iters2 = cfg.frontend_iters2

        # pending packet: (host array, d0, t1 at update, steps2)
        self._packet = None
        # resolved distance matrix for THIS frame's topology
        self._dmat = None
        self._d0 = 0

    # ---------------- packet protocol ----------------

    def resolve(self):
        """Apply any pending packet (the planner's engage resolves the
        classic state first)."""
        self._resolve_packet()

    def _resolve_packet(self):
        if self._packet is None:
            return
        host, d0, t1p, steps2 = self._packet
        self._packet = None
        self._apply_packet(host, d0, t1p, steps2)

    def _apply_packet(self, host, d0, t1p, steps2):
        d = float(host[0])
        dmat = host[1:].reshape(DMAT_WINDOW, DMAT_WINDOW)

        if d < self.cfg.keyframe_thresh:
            # remove the redundant keyframe (the extra updates were
            # already skipped by the update's keep-keyframe branch)
            ix = t1p - 2
            self.rm_keyframe_deferred(ix)
            self.t1 -= 1
            self.video.counter -= 1
            k = ix - d0
            if 0 <= k < DMAT_WINDOW:
                dmat = np.delete(np.delete(dmat, k, 0), k, 1)
                pad = DMAT_WINDOW - dmat.shape[0]
                dmat = np.pad(dmat, ((0, pad), (0, pad)),
                              constant_values=np.inf)
        elif steps2:
            # the keep-keyframe branch ran the extra updates: credit
            # their age now
            self.graph.age_credit(steps2)

        self._dmat = dmat
        self._d0 = d0

    def rm_keyframe_deferred(self, ix):
        """Keyframe removal one host step after the probe: every slot
        above ``ix`` shifts down one, including slot ``counter`` (the
        next-keyframe seed and this frame's speculative write)."""
        v = self.video
        for off in range(ix, v.counter):
            v.remove_frame(off)
        g = self.graph
        m = (g.ii == ix) | (g.jj == ix)
        g.ii = np.where(g.ii >= ix, g.ii - 1, g.ii)
        g.jj = np.where(g.jj >= ix, g.jj - 1, g.jj)
        g.ii_inac = np.where(g.ii_inac >= ix, g.ii_inac - 1, g.ii_inac)
        g.jj_inac = np.where(g.jj_inac >= ix, g.jj_inac - 1, g.jj_inac)
        g.rm_factors(m, store=False)

    def _distance_lookup(self, ii, jj):
        """Pair distances for the proximity proposal: from the packet's
        matrix when available, else computed on the video."""
        if self._dmat is not None:
            a = np.asarray(ii) - self._d0
            b = np.asarray(jj) - self._d0
            ok = (a >= 0) & (a < DMAT_WINDOW) & (b >= 0) & \
                (b < DMAT_WINDOW)
            d = np.full(len(a), np.inf)
            d[ok] = self._dmat[a[ok], b[ok]]
            return d
        return np.asarray(self.video.distance(ii, jj, beta=self.cfg.beta),
                          np.float64)

    # ---------------- per-keyframe update ----------------

    def _update(self):
        cfg = self.cfg
        self.count += 1
        self.t1 += 1

        self._resolve_packet()

        if self.graph.n_edges > 0:
            self.graph.rm_factors(self.graph.age > self.max_age, store=True)

        self.graph.add_proximity_factors(
            self.t1 - 5, max(self.t1 - cfg.frontend_window, 0),
            rad=cfg.frontend_radius, nms=cfg.frontend_nms,
            thresh=cfg.frontend_thresh, beta=cfg.beta, remove=True,
            distance_fn=self._distance_lookup)

        packet, d0 = self.graph.update(
            None, None, use_inactive=True, steps=self.iters1,
            dist_pair=(self.t1 - 3, self.t1 - 2), steps2=self.iters2,
            kf_thresh=cfg.keyframe_thresh, seed_ix=self.t1,
            dmat_window=DMAT_WINDOW)
        if packet is not None:
            self._packet = (packet, d0, self.t1, self.iters2)

    def _initialize(self):
        self.t0 = 0
        self.t1 = self.video.counter

        self.graph.add_neighborhood_factors(self.t0, self.t1, r=3)
        self.graph.update(1, use_inactive=True, steps=8)

        self.graph.add_proximity_factors(
            0, 0, rad=2, nms=2, thresh=self.cfg.frontend_thresh)
        self.graph.update(1, use_inactive=True, steps=12)

        v = self.video
        v.poses[self.t1] = v.poses[self.t1 - 1]
        v.disps[self.t1] = v.disps[self.t1 - 4:self.t1].mean()

        self.is_initialized = True
        self.video.ready = True

    def __call__(self):
        if not self.is_initialized and \
                self.video.counter == self.cfg.warmup:
            self._initialize()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()

    def flush(self):
        """Apply any pending packet (a deferred keyframe removal must
        land before global BA)."""
        self._resolve_packet()
        self._dmat = None
