"""Factor graph over keyframes: edge store + recurrent update + DBA.

Port of :mod:`pvo_tpu.vo.factor_graph` on the classic host-topology
path:

* graph topology (edge lists, ages, inactive/bad stores) is host numpy,
  verbatim from the JAX package, so the decisions match
  ``tests/ref_host_logic.RefHostOracle``;
* per-edge state (flow targets, confidences, dynamic-mask logits, GRU
  hidden states) are device tensors whose rows follow the host edge
  order. A retirement applies its ring store and swap-compaction to the
  tensors at once; edges added since the last update are initialized at
  the start of the next one;
* :meth:`FactorGraph.update` is one eager call of what the JAX package
  runs as one device program: ``steps`` recurrent updates (correlation,
  update operator, segment vote, GraphAgg damping, DBA), the
  keyframe-removal distance probe, ``steps2`` more updates when the
  keyframe is kept, next-keyframe seeding and the window distance
  matrix, returned to the caller as one host packet.

Each update call names its layers with ``record_function`` ranges under
the graph's ``layer`` (``vo.frontend``, set to ``vo.backend`` and
``vo.filler`` by their owners): ``<layer>.volume`` (the correlation
operands built once per call: K1's volumes or K3's pooled pyramid),
``<layer>.update`` (correlation, update operator, heads, GraphAgg) and
``<layer>.dba``. The ctypes-launched corr kernels are attributed to no
range; a profile reads them from their own kernel rows.

On the card the updates use the CUDA kernels: for narrow streams
(:func:`cuda_corr.volume_cache_ok`, the JAX accelerator path's test) K1
builds the volumes of the edges once per call and K2 reads them every
iteration; wider streams take K3 on every iteration, as the JAX path
does; the chunked backend update and the motion filter use K3. K3 reads
the video's features by the edges' frame indices, against a pyramid
pooled once per update call (:meth:`FactorGraph._lookup_frames`). On the
CPU every call site uses the plain lookups of
:mod:`pvo_tpu_torch.vo.net.corr`.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.geom.distance import (frame_distance,
                                         window_distance_matrix)
from pvo_tpu_torch.vo import dba as dba_mod
from pvo_tpu_torch.vo.net import corr as corr_ops
from pvo_tpu_torch.vo.net import cuda_corr, cuda_segsum
from pvo_tpu_torch.vo.net.gru import GATES

DY_THRESH = 0.5
MASK_NUM = 2
# edges per plain (CPU) correlation chunk
CORR_CHUNK = 16

# GRU gate-conv input channel layout: [net | ctx | corr-enc | flow-enc]
GRU_CTX_LO, GRU_CTX_HI = 128, 256


def segment_vote_filter(bin_mask, segm_e, valid, S_MAX, seg_thresh):
    """Dynamic-segment vote: a panoptic segment whose dynamic-pixel
    fraction exceeds ``seg_thresh`` is forced fully dynamic; segment
    id 0 ('no segment') is never voted.

    bin_mask (E,h,w,2) bool static mask; segm_e (E,h,w) local ids in
    [0, S_MAX); valid (E,) edge mask."""
    E, h, w = segm_e.shape
    seg = segm_e.reshape(E, h * w).long()
    dyn = ((~bin_mask[..., 0]) | (~bin_mask[..., 1])).reshape(E, h * w)
    zeros = torch.zeros((E, S_MAX), device=seg.device)
    tot = zeros.scatter_add(1, seg, torch.ones_like(seg, dtype=zeros.dtype))
    dyn_cnt = zeros.scatter_add(1, seg, dyn.to(zeros.dtype))
    killed = (dyn_cnt / tot.clamp(min=1.0)) > seg_thresh
    killed = killed & valid[:, None]
    killed[:, 0] = False
    kill_pix = killed.gather(1, seg)
    return bin_mask & (~kill_pix.reshape(E, h, w))[..., None]


def split_gru_ctx(update):
    """Split the GRU gate kernels' context-channel slices out of an
    update module. Returns ``(w_nc, w_ctx)``: per gate, the kernel
    without the context input channels and the (128, 128, 3, 3) context
    slice. The context features are constant across one update call's
    iterations, so their gate contribution is computed once
    (:func:`gru_ctx_pre`)."""
    w_nc, w_ctx = {}, {}
    for gate in GATES:
        k = getattr(update.gru, gate).weight
        w_ctx[gate] = k[:, GRU_CTX_LO:GRU_CTX_HI].contiguous()
        w_nc[gate] = torch.cat([k[:, :GRU_CTX_LO], k[:, GRU_CTX_HI:]], 1)
    return w_nc, w_ctx


def gru_ctx_pre(w_ctx, ctx):
    """Gate contributions (pz, pr, pq) of the context features; ctx and
    outputs (E, h, w, 128) NHWC in ctx's dtype."""
    x = ctx.permute(0, 3, 1, 2)
    return tuple(F.conv2d(x, w_ctx[g].to(ctx.dtype), padding=1)
                 .permute(0, 2, 3, 1) for g in GATES)


def update_core(graph, net, target, raw, dy, ii, jj, valid, w0, K,
                corr_fn, ctx_pre, segms_e):
    """One recurrent update over the edges (ii, jj) of ``graph``'s video:
    correlation, update operator, heads, segment vote and GraphAgg's
    damping. ``net``/``target``/``raw``/``dy`` (E, h, w, .) are the
    edges' state; rows with ``valid`` False are padding: their weight is
    0 and GraphAgg drops them. ``w0`` may be an int or a 0-d device
    tensor. Returns (net, target, weight, raw, dy, flow, eta (K,h,w),
    frame_has_edge (K,)); nothing reads the card. Late-bound by its
    callers (the classic update and the planner), so a test can swap in
    an oracle core for both."""
    upd = graph.update_op
    cdt = next(upd.parameters()).dtype
    coords0, coords1, motn = graph._coords_motion(ii, jj, target, dy, raw)
    corr = corr_fn(coords1)
    out = upd(net.to(cdt), None, corr.to(cdt), motn.to(cdt),
              ctx_pre=ctx_pre, gru_nc=graph.gru_nc)
    net_c = out["net"]
    net, target, weight, raw, dy, flow = graph._heads(
        out, coords0, coords1, raw, segms_e, valid)
    weight = weight * valid[:, None, None, None].float()

    m = torch.where(valid, ii - w0, torch.full_like(ii, K))
    mean, counts = upd.agg.scatter_mean_counts(
        upd.agg.pre(net_c.permute(0, 3, 1, 2)), m, K)
    eta, _ = upd.agg.post(mean.to(net_c.dtype), upmask=False)
    return net, target, weight, raw, dy, flow, eta[:, 0].float(), counts > 0


class FactorGraph:
    STATE = ("net", "target", "weight", "raw_mask", "delta_dy", "full_flow")
    # prefix of the update's profiler ranges (module docstring)
    layer = "vo.frontend"

    def __init__(self, video, update, max_edges=96, max_inactive=96,
                 max_factors=-1, beta=0.3, edge_chunk=None,
                 net_dtype=torch.float32):
        """``update``: the :class:`DynamicUpdateModule` (with its
        GraphAgg) in the compute dtype. ``edge_chunk``: when set and the
        graph holds more edges, the recurrent update streams over edge
        chunks of this size (backend scale). ``net_dtype``: storage dtype
        of the per-edge hidden state."""
        self.video = video
        self.update_op = update
        self.beta = beta
        self.max_edges = max_edges
        self.max_inactive = max_inactive
        self.max_factors = max_factors
        self.edge_chunk = edge_chunk
        self.net_dtype = net_dtype
        self.gru_nc, self.gru_ctx = split_gru_ctx(update)
        self._init_edges()

    def _init_edges(self):
        """Empty host topology and edge-state tensors."""
        self.h, self.w = self.video.h, self.video.w
        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.age = np.zeros(0, np.int64)
        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.ii_bad = np.zeros(0, np.int64)
        self.jj_bad = np.zeros(0, np.int64)
        # edges added since the last update (state not initialized yet)
        self.fresh = np.zeros(0, bool)

        self.net = self._rows(0, 128, self.net_dtype)
        self.target = self._rows(0, 2)
        self.weight = self._rows(0, 2)
        self.raw_mask = self._rows(0, MASK_NUM)
        self.delta_dy = self._rows(0, 2)
        self.full_flow = self._rows(0, 2)
        self.target_inac = self._rows(0, 2)
        self.weight_inac = self._rows(0, 2)
        self._last_d0 = 0

    def _rows(self, n, c, dtype=torch.float32):
        return torch.zeros((n, self.h, self.w, c), dtype=dtype,
                           device=self.video.device)

    # ---------------- host topology ops ----------------

    @property
    def n_edges(self):
        return len(self.ii)

    def _existing(self):
        return set(zip(self.ii.tolist(), self.jj.tolist())) | \
            set(zip(self.ii_inac.tolist(), self.jj_inac.tolist()))

    def add_factors(self, ii, jj, remove=False):
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        eset = self._existing()
        keep = [k for k in range(len(ii)) if (ii[k], jj[k]) not in eset]
        ii, jj = ii[keep], jj[keep]
        if len(ii) == 0:
            return

        # active-edge cap: the reference's ``argsort(age) >= cap - new``
        # mask applied in edge order (a permutation quirk replicated
        # verbatim so the decision traces match)
        if remove and self.max_factors > 0 and \
                self.n_edges + len(ii) > self.max_factors:
            drop = np.argsort(self.age, kind="stable") >= \
                self.max_factors - len(ii)
            self.rm_factors(drop, store=True)

        # capacity: retire the oldest edges to the inactive store
        overflow = self.n_edges + len(ii) - self.max_edges
        if overflow > 0:
            order = np.argsort(-self.age)
            drop = np.zeros(self.n_edges, bool)
            drop[order[:overflow]] = True
            self.rm_factors(drop, store=True)

        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(len(ii), np.int64)])
        self.fresh = np.concatenate([self.fresh, np.ones(len(ii), bool)])
        for name in self.STATE:
            t = getattr(self, name)
            setattr(self, name, torch.cat(
                [t, self._rows(len(ii), t.shape[-1], t.dtype)]))

    def rm_factors(self, mask, store=False):
        """Retire edges: ``store`` appends their (target, weight) to the
        inactive FIFO (capacity ``max_inactive``; an edge never updated
        is stored with zero weight); survivors above the new edge count
        swap into the holes below it, on the host arrays and the state
        tensors alike."""
        mask = np.asarray(mask, bool)
        k = int(mask.sum())
        if k == 0:
            return
        drop_idx = np.nonzero(mask)[0]
        if store:
            dev = self.video.device
            d = torch.as_tensor(drop_idx, device=dev)
            fresh = torch.as_tensor(self.fresh[drop_idx], device=dev)
            w_new = torch.where(fresh[:, None, None, None], 0.0,
                                self.weight[d])
            MI = self.max_inactive
            self.target_inac = torch.cat([self.target_inac,
                                          self.target[d]])[-MI:]
            self.weight_inac = torch.cat([self.weight_inac, w_new])[-MI:]
            self.ii_inac = np.concatenate([self.ii_inac, self.ii[mask]])[-MI:]
            self.jj_inac = np.concatenate([self.jj_inac, self.jj[mask]])[-MI:]

        n = len(mask)
        n_new = n - k
        drop_set = set(drop_idx.tolist())
        holes = [d for d in drop_idx if d < n_new]
        movers = [r for r in range(n_new, n) if r not in drop_set]
        for name in ("ii", "jj", "age", "fresh"):
            arr = getattr(self, name).copy()
            arr[holes] = arr[movers]
            setattr(self, name, arr[:n_new])
        if holes:
            dev = self.video.device
            h_t = torch.as_tensor(holes, device=dev)
            m_t = torch.as_tensor(movers, device=dev)
            for name in self.STATE:
                getattr(self, name)[h_t] = getattr(self, name)[m_t]
        for name in self.STATE:
            setattr(self, name, getattr(self, name)[:n_new])

    def filter_edges(self):
        """Drop long-range edges with negligible confidence."""
        if self.n_edges == 0:
            return
        conf = self.weight.mean(dim=(1, 2, 3)).cpu().numpy()
        mask = (np.abs(self.ii - self.jj) > 2) & (conf < 0.001)
        self.ii_bad = np.concatenate([self.ii_bad, self.ii[mask]])
        self.jj_bad = np.concatenate([self.jj_bad, self.jj[mask]])
        self.rm_factors(mask, store=False)

    def clear_edges(self):
        self.rm_factors(np.ones(self.n_edges, bool), store=False)

    # ---------------- graph construction ----------------

    def add_neighborhood_factors(self, t0, t1, r=3):
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        keep = (np.abs(ii - jj) > 0) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def add_proximity_factors(self, t0=0, t1=0, rad=2, nms=2, beta=0.25,
                              thresh=16.0, remove=False, max_new=None,
                              distance_fn=None):
        """Distance-based edge proposal with diamond-NMS suppression.
        ``distance_fn``: optional host pair-distance source (the
        frontend's packet matrix) in place of a device call."""
        t = self.video.counter
        ix = np.arange(t0, t)
        jx = np.arange(t1, t)
        if len(ix) == 0 or len(jx) == 0:
            return
        ii, jj = np.meshgrid(ix, jx, indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)

        if distance_fn is not None:
            d = np.asarray(distance_fn(ii, jj), np.float64).copy()
        else:
            d = np.asarray(self.video.distance(ii, jj, beta=beta),
                           np.float64).copy()
        d[ii - rad < jj] = np.inf
        d[d > 100] = np.inf

        offs = {rv: np.array(
            [(di, dj) for di in range(-nms, nms + 1)
             for dj in range(-nms, nms + 1)
             if abs(di) + abs(dj) <= rv], np.int64).reshape(-1, 2)
            for rv in range(nms + 1)}

        def suppress(si, sj):
            si = np.asarray(si, np.int64).reshape(-1)
            sj = np.asarray(sj, np.int64).reshape(-1)
            r = np.clip(np.abs(si - sj) - 2, 0, nms)
            for rv in np.unique(r):
                o = offs[int(rv)]
                sel = r == rv
                i1 = si[sel][:, None] + o[None, :, 0]
                j1 = sj[sel][:, None] + o[None, :, 1]
                ok = ((i1 >= t0) & (i1 < t) & (j1 >= t1) & (j1 < t))
                d[(i1[ok] - t0) * (t - t1) + (j1[ok] - t1)] = np.inf

        ei = np.concatenate([self.ii, self.ii_bad, self.ii_inac])
        ej = np.concatenate([self.jj, self.jj_bad, self.jj_inac])
        lr = np.abs(ei - ej) > 2
        suppress(ei[lr], ej[lr])

        es = []
        for i in range(t0, t):
            for j in range(i + 1, min(i + rad + 1, t)):
                es.append((i, j))
                es.append((j, i))

        # greedy accept in distance order; only candidates initially
        # under thresh can be accepted (suppression only raises d)
        order = np.argsort(d)[: int(np.count_nonzero(d <= thresh))]
        for k in order:
            if d[k] > thresh:
                continue
            if max_new is not None and len(es) >= 2 * max_new:
                break
            i, j = int(ii[k]), int(jj[k])
            es.append((i, j))
            es.append((j, i))
            suppress(i, j)

        if es:
            es = np.asarray(es, np.int64)
            self.add_factors(es[:, 0], es[:, 1], remove)

    # ---------------- the update ----------------

    def update(self, t0=None, t1=None, itrs=2, use_inactive=False,
               EP=1e-7, motion_only=False, steps=1, dist_pair=None,
               steps2=0, kf_thresh=0.0, seed_ix=None, dmat_window=0):
        """``steps`` updates, then the post-BA bidirectional distance of
        ``dist_pair`` (keyframe-removal probe); ``steps2`` more updates
        only when that distance >= ``kf_thresh``; ``seed_ix``: slot seeded
        with the previous pose / mean disp; ``dmat_window`` > 0 appends
        the window distance matrix. Returns (host packet, d0)."""
        if self.n_edges == 0:
            return None, 0
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        if t1 is None:
            t1 = int(max(self.ii.max(), self.jj.max())) + 1
        packet = self._update(t0, t1, itrs, use_inactive, EP, motion_only,
                              lm=1e-4, ep=0.1, damp_fac=0.2, steps=steps,
                              dist_pair=dist_pair, steps2=steps2,
                              kf_thresh=kf_thresh, seed_ix=seed_ix,
                              dmat_window=dmat_window)
        # the steps2 updates are credited by the caller
        # (Frontend._apply_packet -> age_credit) when they ran
        self.age += steps
        return packet, self._last_d0

    def age_credit(self, extra):
        self.age += extra

    def update_lowmem(self, t0=None, t1=None, itrs=2, EP=1e-7, steps=8):
        """Global-BA update loop: lighter damping (lm=1e-5, ep=1e-2,
        damping factor 1.0)."""
        t0_ = max(1, int(self.ii.min()) + 1) if t0 is None else t0
        t1_ = int(self.video.counter) if t1 is None else t1
        self._update(t0_, t1_, itrs, False, EP, False, lm=1e-5, ep=1e-2,
                     damp_fac=1.0, steps=steps)

    def _init_fresh(self, intr_b):
        """State of edges added since the last update: target <-
        reprojection, hidden <- the source frame's context net, rest 0."""
        if not self.fresh.any():
            return
        v = self.video
        f = torch.as_tensor(np.nonzero(self.fresh)[0], device=v.device)
        coords, _ = projective.projective_transform(
            v.poses[None], v.disps[None], intr_b, self.ii[self.fresh],
            self.jj[self.fresh])
        self.target[f] = coords[0]
        for name in ("weight", "raw_mask", "delta_dy", "full_flow"):
            getattr(self, name)[f] = 0.0
        self.net[f] = v.nets[torch.as_tensor(self.ii[self.fresh],
                                             device=v.device)].to(
                                                 self.net.dtype)
        self.fresh[:] = False

    def _update(self, t0, t1, itrs, use_inactive, EP, motion_only, lm, ep,
                damp_fac, steps=1, dist_pair=None, steps2=0, kf_thresh=0.0,
                seed_ix=None, dmat_window=0):
        v = self.video
        dev = v.device
        F_ = v.poses.shape[0]
        n = self.n_edges
        intrinsics = v.intrinsics[0]
        intr_b = intrinsics.expand(1, F_, 4)
        self._init_fresh(intr_b)

        ii = torch.as_tensor(self.ii, device=dev)
        jj = torch.as_tensor(self.jj, device=dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)

        # inactive edges taking part in BA
        if use_inactive and len(self.ii_inac) > 0:
            sel = np.nonzero((self.ii_inac >= t0 - 3) &
                             (self.jj_inac >= t0 - 3))[0]
        else:
            sel = np.zeros(0, np.int64)
        sel_t = torch.as_tensor(sel, device=dev)
        extra_target = self.target_inac[sel_t]
        extra_weight = self.weight_inac[sel_t]
        ii_ba = np.concatenate([self.ii_inac[sel], self.ii])
        jj_ba = np.concatenate([self.jj_inac[sel], self.jj])
        valid_ba = np.ones(len(ii_ba), bool)
        w0 = int(ii_ba.min())
        K = int(ii_ba.max()) - w0 + 1
        P = int(t1 - t0)
        pa, pb, pv = dba_mod.build_edge_pairs(ii_ba, valid_ba)
        ba_args = [torch.as_tensor(a, device=dev)
                   for a in (ii_ba, jj_ba, valid_ba, pa, pb, pv)]

        chunk = self.edge_chunk if (self.edge_chunk and
                                    n > self.edge_chunk) else None
        cdt = next(self.update_op.parameters()).dtype
        core = dict(ii=ii, jj=jj, valid=valid, w0=w0, K=K)
        with record_function(f"{self.layer}.volume"):
            self._loop_invariants(core, chunk, cdt)

        def one_step():
            with record_function(f"{self.layer}.update"):
                if chunk is None:
                    eta, has_edge = self._update_core(**core)
                else:
                    eta, has_edge = self._update_core_chunked(chunk=chunk,
                                                              **core)
                krows = torch.arange(K, device=dev) + w0
                v.damping[krows] = torch.where(has_edge[:, None, None], eta,
                                               v.damping[krows])
                eta_k = damp_fac * v.damping[krows] + EP
            with record_function(f"{self.layer}.dba"):
                v.poses, v.disps = dba_mod.dba(
                    v.poses, v.disps, intrinsics,
                    torch.cat([extra_target, self.target]),
                    torch.cat([extra_weight, self.weight]), eta_k, *ba_args,
                    t0, t1, w0, P=P, K=K, iters=itrs,
                    motion_only=motion_only, ep=ep, lm=lm)

        for _ in range(steps):
            one_step()

        # post-BA keyframe-distance probe (frontend removal decision)
        di, dj = dist_pair if dist_pair is not None else (0, 0)
        d = 0.5 * (frame_distance(v.poses, v.disps, intrinsics, [di], [dj],
                                  self.beta) +
                   frame_distance(v.poses, v.disps, intrinsics, [dj], [di],
                                  self.beta))
        d = d.cpu().numpy()
        if steps2 > 0 and d[0] >= kf_thresh:
            for _ in range(steps2):
                one_step()

        if seed_ix is not None:
            v.poses[seed_ix] = v.poses[seed_ix - 1]
            v.disps[seed_ix] = v.disps[seed_ix - 1].mean()

        d0 = max(0, int(v.counter) + 1 - dmat_window) if dmat_window else 0
        self._last_d0 = d0
        if dmat_window:
            dmat = window_distance_matrix(v.poses, v.disps, intrinsics, d0,
                                          dmat_window, self.beta)
            return np.concatenate([d, dmat.reshape(-1).cpu().numpy()])
        return d

    def _loop_invariants(self, core, chunk, cdt):
        """Add this call's loop invariants to ``core``: on the card the
        correlation volumes (K1) of narrow streams, else the frames and
        pyramid that K3 reads on every step; the context gate terms and
        the edge segments. The chunked update takes only K3's frames."""
        v = self.video
        dev = v.device
        ii, jj = core["ii"], core["jj"]
        if chunk is not None:
            if dev.type == "cuda":
                core["frames"] = self._lookup_frames()
            return
        if dev.type == "cuda" and cuda_corr.volume_cache_ok(self.h, self.w):
            vols = cuda_corr.build_volumes(v.fmaps[ii], v.fmaps[jj])
            core["corr_fn"] = lambda c1: cuda_corr.corr_extract(vols, c1)
        elif dev.type == "cuda":
            frames = self._lookup_frames()
            core["corr_fn"] = lambda c1: cuda_corr.corr_lookup_indexed(
                *frames, c1)
        else:
            core["corr_fn"] = lambda c1: corr_ops.chunked_corr_lookup(
                v.fmaps, ii, jj, c1, chunk=CORR_CHUNK)
        core["ctx_pre"] = gru_ctx_pre(self.gru_ctx, v.inps[ii].to(cdt))
        core["segms_e"] = v.segms[ii]

    def _lookup_frames(self):
        """K3's operands for this call's edges: the features of the
        frames the edges touch (a slice of the video), their pyramid,
        pooled here once, and the edges' frame indices into the slice."""
        v = self.video
        lo = int(min(self.ii.min(), self.jj.min()))
        hi = int(max(self.ii.max(), self.jj.max())) + 1
        fmaps = v.fmaps[lo:hi]
        to_dev = lambda a: torch.as_tensor(a - lo, dtype=torch.int32,
                                           device=v.device)
        return (fmaps, cuda_corr.lookup_pyramid(fmaps), to_dev(self.ii),
                to_dev(self.jj))

    def _heads(self, out, coords0, coords1, raw, segms_e, valid):
        """Post-GRU state: dynamic mask (+ segment vote), new target,
        weight, dynamic flow and full flow, all f32."""
        v = self.video
        out = {k: t.float() for k, t in out.items()}
        raw = raw + out["delta_mask"]
        bin_mask = torch.sigmoid(raw) >= DY_THRESH
        if v.segm_filter:
            bin_mask = segment_vote_filter(bin_mask, segms_e, valid,
                                           v.max_segments, v.thresh)
        bin_mask = bin_mask.float()
        target = coords1 + out["delta"]
        weight = torch.sigmoid(out["weight_logits"] +
                               (1.0 - bin_mask) * 10.0)
        dy = out["delta_dy"] * (1.0 - bin_mask)
        flow = coords1 + dy - coords0
        return out["net"], target, weight, raw, dy, flow

    def _coords_motion(self, ii, jj, target, dy, raw):
        v = self.video
        coords0 = projective.coords_grid(self.h, self.w, device=v.device)
        intr_b = v.intrinsics[0].expand(1, v.poses.shape[0], 4)
        coords1, _ = projective.projective_transform(
            v.poses[None], v.disps[None], intr_b, ii, jj)
        coords1 = coords1[0]
        motn = torch.cat([target - coords0, target - coords0 + dy,
                          target - coords1, raw], dim=-1).clamp(-64.0, 64.0)
        return coords0, coords1, motn

    def _update_core(self, ii, jj, valid, w0, K, corr_fn, ctx_pre, segms_e):
        """One recurrent update over all edges (:func:`update_core`);
        writes the edge state and returns (eta (K,h,w), frame_has_edge
        (K,))."""
        (net, self.target, self.weight, self.raw_mask, self.delta_dy,
         self.full_flow, eta, has_edge) = update_core(
            self, self.net, self.target, self.raw_mask, self.delta_dy, ii,
            jj, valid, w0, K, corr_fn, ctx_pre, segms_e)
        self.net = net.to(self.net.dtype)
        return eta, has_edge

    def _update_core_chunked(self, ii, jj, valid, w0, K, chunk,
                             frames=None):
        """Streaming variant for the global-BA backend: edges in chunks of
        ``chunk``, peak activation memory one chunk's; GraphAgg's
        scatter-sum accumulates across chunks via its pre/post split.
        ``frames``: :meth:`_lookup_frames` (on the card)."""
        v = self.video
        upd = self.update_op
        cdt = next(upd.parameters()).dtype
        n = ii.shape[0]
        sum_acc = torch.zeros((K + 1, 128, self.h, self.w), device=v.device)
        cnt_acc = torch.zeros(K + 1, device=v.device)
        for o in range(0, n, chunk):
            sl = slice(o, o + chunk)
            ii_c, jj_c, valid_c = ii[sl], jj[sl], valid[sl]
            coords0, coords1, motn = self._coords_motion(
                ii_c, jj_c, self.target[sl], self.delta_dy[sl],
                self.raw_mask[sl])
            if frames is not None:
                fmaps, pyr, ii_f, jj_f = frames
                corr = cuda_corr.corr_lookup_indexed(fmaps, pyr, ii_f[sl],
                                                     jj_f[sl], coords1)
            else:
                corr = corr_ops.chunked_corr_lookup(
                    v.fmaps, ii_c, jj_c, coords1, chunk=CORR_CHUNK)
            out = upd(self.net[sl].float().to(cdt), v.inps[ii_c].to(cdt),
                      corr.to(cdt), motn.to(cdt))
            net_c = out["net"]
            (net, self.target[sl], self.weight[sl], self.raw_mask[sl],
             self.delta_dy[sl], self.full_flow[sl]) = self._heads(
                out, coords0, coords1, self.raw_mask[sl], v.segms[ii_c],
                valid_c)
            self.net[sl] = net.to(self.net.dtype)
            m = ii_c - w0
            cuda_segsum.sums([
                (sum_acc, m, upd.agg.pre(net_c.permute(0, 3, 1, 2)).float()),
                (cnt_acc, m, valid_c.float())])
        mean = sum_acc[:K] / cnt_acc[:K].clamp(min=1.0)[:, None, None, None]
        eta, _ = upd.agg.post(mean.to(cdt), upmask=False)
        return eta[:, 0].float(), cnt_acc[:K] > 0
