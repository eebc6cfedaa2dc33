"""The device-resident planner: the tracking loop with no host read a
frame (port of :mod:`pvo_tpu.vo.planner`, the JAX package's default
tracking path, ``VOConfig.pipeline``).

The classic path keeps the graph's topology on the host and reads the
frontend update's packet (the keyframe-removal distance and the window
distance matrix) back every frame before it builds the next keyframe's
edges. The planner moves that whole decision procedure into one device
program a frame: the decisions of frame t are a function of what the
device holds after frame t-1, so program t computes them first.

  phase A  the deferred keyframe removal from the last frame's probe
           (video rows shifted, edges remapped, distance matrix
           remapped) or the credit of the last frame's extra steps, as
           predicated selects;
  phase B  the motion filter's probe and the masked write of slot
           ``counter`` (:func:`motion_filter.track_body_device`);
  phase C  (where an update is due) aged-edge retirement into the
           inactive ring, the proximity proposal from the device's
           distance matrix, the reference's ``argsort(age)`` cap
           eviction, the fresh edges' append and initialization, K1's
           volumes and the context terms, ``steps`` updates through
           :func:`factor_graph.update_core` and :func:`dba.dba`, the
           removal probe, ``steps2`` more updates where the keyframe
           stays, the next pose's seed, the age advance and the next
           window distance matrix. The update runs in one of two
           regimes: compact (``EB_S`` active edges, ``EI_S`` inactive
           ones, ``PAIRS_S`` pairs) where the counts fit, else full width
           (``PlannerDriver.EBMAX`` edges, the whole inactive ring,
           ``PAIRS`` pairs). They differ only in the order of f32 sums.

Every topology operation is a function of device tensors with static
shapes; the JAX planner's greedy ``while_loop`` is a fixed loop of
``MAXACC`` predicated trips. On the card :class:`PlannerDriver` captures
the program once per system as a CUDA graph (:mod:`graph_capture`) after
eager warm-up frames, and replays it every frame: removal, admission and
the credit are predicated selects, the update, the regime and the extra
steps are CUDA conditional nodes. On the CPU the same program runs
eagerly and its branches read their predicate on the host. The host
reads back a small decision record a frame, through pinned memory and a
CUDA event, two frames behind; the topology mirrors are rebuilt from the
device at disengage (terminate, the backend, the accessors).

An overflow of a static width (a flag of ``F_*``) leaves the device state
consistent but its decisions differ from the classic path's:
:class:`PlannerDriver` disengages to the classic path and backs off. Not
ported: the JAX module's ``PVO_EB_S``/``PVO_EI_S``/``PVO_PAIRS_S``
environment knobs (tuning tools of the TPU rounds) and
``step_cost_analysis`` (an XLA cost query; the port's benches report
device time and busy share).
"""

from __future__ import annotations

import logging
import types

import numpy as np
import torch

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.geom.distance import frame_distance, window_distance_matrix
from pvo_tpu_torch.vo import dba as dba_mod
from pvo_tpu_torch.vo import factor_graph as fg
from pvo_tpu_torch.vo import graph_capture
from pvo_tpu_torch.vo.motion_filter import track_body_device
from pvo_tpu_torch.vo.net import corr as corr_ops
from pvo_tpu_torch.vo.net import cuda_corr

# static grid widths of the proximity proposal: i in [t1-5, t) (5
# values), j in [t1 - frontend_window, t) within the distance matrix
CI = 8
MAXACC = 24          # greedy-accepted pairs a frame (flag on overflow)
NEWPAD = 2 * (CI * 2) + 2 * MAXACC   # candidate append list width
REC_W = 12           # decision-record width

# the compact regime's widths: active edges, inactive BA extras,
# same-source pairs
EB_S = 24
EI_S = 24
PAIRS_S = 256
FORCE_LARGE = False  # tests: take the full-width regime every frame

# scal[] layout (int64 device state vector)
S_COUNTER, S_T1, S_PENDING, S_PROBE_T1, S_D0, S_N, S_INACN, S_FLAGS = \
    range(8)
SCAL_W = 8

# sticky flags: the program had to deviate from the classic decision
# (dropped candidates, truncated widths); PlannerDriver disengages
F_PROX_OVF = 1       # greedy NMS hit MAXACC with candidates left
F_PAIR_OVF = 2       # edge-pair count exceeded the PAIRS width
F_WIN_OVF = 4        # BA pose/depth window exceeded P/K
F_EMPTY = 8          # edge set empty after the proposal
F_GRID_OVF = 16      # proposal candidate ranges exceeded CI/CJ
F_EDGE_OVF = 32      # fresh-edge append exceeded EBMAX

_FLAG_NAMES = {F_PROX_OVF: "PROX_OVF", F_PAIR_OVF: "PAIR_OVF",
               F_WIN_OVF: "WIN_OVF", F_EMPTY: "EMPTY",
               F_GRID_OVF: "GRID_OVF", F_EDGE_OVF: "EDGE_OVF"}


def flag_names(flags):
    return "|".join(n for b, n in _FLAG_NAMES.items() if flags & b) \
        or "none"


log = logging.getLogger("pvo_tpu_torch.planner")

# record[] layout; R_SMALL and R_STEPS2 say which sections of the
# program ran (the regime, the extra steps)
R_ADM, R_RAN, R_REMOVED, R_RMIX, R_COUNTER, R_T1, R_N, R_INACN, \
    R_FLAGS, R_NNEW, R_SMALL, R_STEPS2 = range(12)

# the update branch's outputs, preset to the skip branch's values
B_T1, B_D0, B_FLAGS, B_NNEW, B_RAN, B_SMALL, B_STEPS2 = range(7)

I64 = torch.int64
INF = float("inf")


# ---------------------------------------------------------------------
# device topology operations
# ---------------------------------------------------------------------


def _set_drop(base, dst, vals):
    """``base`` with ``vals[k]`` written at ``dst[k]``; destinations
    outside ``[0, len(base))`` dropped (an extra slot takes them, the
    only place two writes may meet)."""
    n = base.shape[0]
    dst = torch.where((dst >= 0) & (dst < n), dst, torch.full_like(dst, n))
    out = torch.cat([base, base[:1]])
    out.scatter_(0, dst, vals.to(base.dtype))
    return out[:n]


def _swap_compact_perm(drop, n, E):
    """Swap-compaction permutation (the plan of the host's
    ``FactorGraph.rm_factors``): surviving rows >= n_new fill the dropped
    holes below n_new, ascending holes with ascending movers. Returns
    (perm (E,): the source row of each row, n_new); rows >= n_new keep
    identity (their content is dead)."""
    idx = torch.arange(E, dtype=I64, device=drop.device)
    dropm = drop & (idx < n)
    k = dropm.sum()
    n_new = n - k
    is_hole = dropm & (idx < n_new)
    is_mover = (~dropm) & (idx < n) & (idx >= n_new)
    hole_rank = torch.cumsum(is_hole.long(), 0) - 1
    mover_rank = torch.cumsum(is_mover.long(), 0) - 1
    mover_pos = _set_drop(torch.full_like(idx, E),
                          torch.where(is_mover, mover_rank,
                                      torch.full_like(idx, E)), idx)
    perm = torch.where(is_hole, mover_pos[hole_rank.clamp(0, E - 1)], idx)
    return perm, n_new


def _roll_back(x, r):
    """``jnp.roll(x, -r, axis=0)`` for a device count ``r``."""
    n = x.shape[0]
    src = (torch.arange(n, device=x.device) + r) % n
    return x[src]


def _retire_edges(gt, bufs, drop, store):
    """Drop the masked edges: with ``store`` first the inactive ring's
    FIFO stores (the host ``rm_factors(store=True)``, the oldest entries
    evicted), then the swap-compaction of the topology and of the edge
    state. ``gt``: dict of ii/jj/age/valid/n/inac_*; ``bufs``: (net,
    target, weight, raw, dy, flow, t_inac, w_inac), compacted in place.
    Returns (gt, bufs)."""
    net, target, weight, raw, dy, flow, t_inac, w_inac = bufs
    E = gt["ii"].shape[0]
    MI = t_inac.shape[0]
    n = gt["n"]
    gt = dict(gt)
    idx = torch.arange(E, dtype=I64, device=drop.device)
    dropm = drop & (idx < n) & gt["valid"]
    k = dropm.sum()

    if store:
        inac_n = gt["inac_n"]
        rank = torch.cumsum(dropm.long(), 0) - 1
        over = (inac_n + k - MI).clamp(min=0)
        roll = torch.minimum(over, inac_n)      # evicted old entries
        surv = k - (over - roll)                # stores that land
        st_row = inac_n - roll + rank - (k - surv)
        st_row = torch.where(dropm & (st_row >= 0) & (st_row < MI),
                             st_row, torch.full_like(st_row, MI))
        # the ring row each store lands in, read as a gather
        src = _set_drop(torch.full((MI,), -1, dtype=I64,
                                   device=drop.device), st_row, idx)
        hit = src >= 0
        src = src.clamp(min=0)

        def ring(old, new):
            rolled = _roll_back(old, roll)
            m = hit.reshape((-1,) + (1,) * (old.dim() - 1))
            return torch.where(m, new[src].to(old.dtype), rolled)

        t_inac.copy_(ring(t_inac, target[:E]))
        w_inac.copy_(ring(w_inac, weight[:E]))
        gt["inac_ii"] = ring(gt["inac_ii"], gt["ii"])
        gt["inac_jj"] = ring(gt["inac_jj"], gt["jj"])
        gt["inac_valid"] = ring(gt["inac_valid"],
                                torch.ones_like(gt["valid"]))
        gt["inac_n"] = torch.minimum(inac_n + k, torch.full_like(k, MI))

    perm, n_new = _swap_compact_perm(dropm, n, E)
    for key in ("ii", "jj", "age"):
        gt[key] = gt[key][perm]
    gt["valid"] = idx < n_new
    gt["n"] = n_new
    for buf in (net, target, weight, raw, dy, flow):
        buf[:E] = buf[:E][perm]
    return gt, bufs


def _device_proximity(gt, dmat, d0, t, t1v, CJ, rad, nms, thresh, window):
    """The proximity edge proposal from the device's distance matrix, the
    host ``add_proximity_factors`` value for value: candidates (i in
    [t1v-5, t), j in [max(t1v-window, 0), t)), suppression by the
    existing long-range edges, then a greedy accept in distance order
    with diamond-NMS suppression (suppression only writes inf, so the
    argmin of the survivors is the host's sorted scan). Returns (new_ii,
    new_jj (NEWPAD,), n_new, flags)."""
    dev = dmat.device
    i0 = t1v - 5
    j0 = (t1v - window).clamp(min=0)
    ig = i0 + torch.arange(CI, dtype=I64, device=dev)
    jg = j0 + torch.arange(CJ, dtype=I64, device=dev)
    mi = ig < t
    mj = jg < t
    flags = torch.where((t - i0 > CI) | (t - j0 > CJ),
                        F_GRID_OVF, 0).to(I64)

    a = ig - d0
    b = jg - d0
    WD = dmat.shape[0]
    okd = ((a >= 0) & (a < WD))[:, None] & ((b >= 0) & (b < WD))[None]
    dval = dmat[a.clamp(0, WD - 1)][:, b.clamp(0, WD - 1)]
    inf = torch.full_like(dval, INF)
    d = torch.where(okd & mi[:, None] & mj[None, :], dval, inf)
    d = torch.where(ig[:, None] - rad < jg[None, :], inf, d)
    d = torch.where(d > 100.0, inf, d)

    # suppression from the existing long-range edges, active and inactive
    ei = torch.cat([gt["ii"], gt["inac_ii"]])
    ej = torch.cat([gt["jj"], gt["inac_jj"]])
    ev = torch.cat([gt["valid"], gt["inac_valid"]])
    lr = ev & ((ei - ej).abs() > 2)
    r_e = ((ei - ej).abs() - 2).clamp(0, nms)
    man = ((ig[:, None, None] - ei[None, None, :]).abs() +
           (jg[None, :, None] - ej[None, None, :]).abs())
    sup = (lr[None, None, :] & (man <= r_e[None, None, :])).any(-1)
    d = torch.where(sup, inf, d)

    # the greedy accept: MAXACC predicated trips (a trip past the host's
    # last accept changes nothing)
    maxacc = MAXACC
    slots = torch.arange(maxacc, dtype=I64, device=dev)
    acc_i = torch.zeros(maxacc, dtype=I64, device=dev)
    acc_j = torch.zeros(maxacc, dtype=I64, device=dev)
    na = torch.zeros((), dtype=I64, device=dev)
    for _ in range(maxacc):
        active = (d.min() <= thresh) & (na < maxacc)
        k = torch.argmin(d.reshape(-1))
        i = i0 + k // CJ
        j = j0 + k % CJ
        hit = active & (slots == na)
        acc_i = torch.where(hit, i, acc_i)
        acc_j = torch.where(hit, j, acc_j)
        r = ((i - j).abs() - 2).clamp(0, nms)
        supd = ((ig[:, None] - i).abs() + (jg[None, :] - j).abs()) <= r
        d = torch.where(active & supd, inf, d)
        na = na + active.long()
    flags = flags | torch.where(d.min() <= thresh, F_PROX_OVF, 0)

    # the append list: neighbourhood pairs first (the host's prefix, i
    # then j ascending), then the accepted pairs, each as (i, j) and
    # (j, i)
    I = (i0 + torch.arange(CI, dtype=I64, device=dev))[:, None].expand(
        CI, rad)
    J = I + 1 + torch.arange(rad, dtype=I64, device=dev)[None]
    V = (I < t) & (J < t)
    va = slots < na
    ci_arr = torch.cat([torch.stack([I, J], -1).reshape(-1),
                        torch.stack([acc_i, acc_j], -1).reshape(-1)])
    cj_arr = torch.cat([torch.stack([J, I], -1).reshape(-1),
                        torch.stack([acc_j, acc_i], -1).reshape(-1)])
    cv_arr = torch.cat([torch.stack([V, V], -1).reshape(-1),
                        torch.stack([va, va], -1).reshape(-1)])

    # dedup against the existing edges only: duplicates inside the list
    # stay, as in the host's add_factors
    dup = ((ci_arr[:, None] == ei[None, :]) &
           (cj_arr[:, None] == ej[None, :]) & ev[None, :]).any(-1)
    keep = cv_arr & (~dup)
    n_new = keep.sum()
    rank = torch.cumsum(keep.long(), 0) - 1
    dst = torch.where(keep, rank, torch.full_like(rank, NEWPAD))
    zeros = torch.zeros(NEWPAD, dtype=I64, device=dev)
    return (_set_drop(zeros, dst, ci_arr), _set_drop(zeros, dst, cj_arr),
            n_new, flags)


def _build_pairs(ii_all, valid_all, PAIRS):
    """The device's ``dba.build_edge_pairs``: ordered (a, b) pairs of
    BA-edge slots sharing a source frame, row-major, compacted into the
    PAIRS width. Returns (pa, pb, pv, overflow)."""
    N = ii_all.shape[0]
    dev = ii_all.device
    same = ((ii_all[:, None] == ii_all[None, :]) &
            valid_all[:, None] & valid_all[None, :])
    flat = same.reshape(-1)
    rank = torch.cumsum(flat.long(), 0) - 1
    total = rank[-1] + 1
    ar = torch.arange(N * N, dtype=I64, device=dev)
    dst = torch.where(flat & (rank < PAIRS), rank,
                      torch.full_like(rank, PAIRS))
    zeros = torch.zeros(PAIRS, dtype=I64, device=dev)
    pa = _set_drop(zeros, dst, ar // N)
    pb = _set_drop(zeros, dst, ar % N)
    pv = torch.arange(PAIRS, dtype=I64, device=dev) < total
    return pa, pb, pv, total > PAIRS


def _append_edges(gt, new_ii, new_jj, n_new, EBMAX):
    """Append the fresh edges at rows [n, n + n_new). Rows beyond EBMAX
    are dropped and the count clamped, so that valid == (row < n) holds,
    with F_EDGE_OVF raised (the classic host appends them all: its width
    is max_edges). Returns (gt, fresh_mask, flags)."""
    dev = new_ii.device
    gt = dict(gt)
    idx = torch.arange(EBMAX, dtype=I64, device=dev)
    n0 = gt["n"]
    NC = new_ii.shape[0]
    ar = torch.arange(NC, dtype=I64, device=dev)
    dst = torch.where(ar < n_new, n0 + ar, torch.full_like(ar, EBMAX))
    gt["ii"] = _set_drop(gt["ii"], dst, new_ii)
    gt["jj"] = _set_drop(gt["jj"], dst, new_jj)
    gt["age"] = _set_drop(gt["age"], dst, torch.zeros_like(new_ii))
    n_tot = n0 + n_new
    flags = torch.where(n_tot > EBMAX, F_EDGE_OVF, 0).to(I64)
    gt["n"] = n_tot.clamp(max=EBMAX)
    gt["valid"] = idx < gt["n"]
    fresh_mask = (idx >= n0) & (idx < gt["n"])
    return gt, fresh_mask, flags


def _shift_window_rows(buf, ix, end, W4=4, when=None):
    """Keyframe removal's shift, in place: rows [ix, end) of the window
    [ix, ix + W4) take rows [ix+1, end] (the host ``remove_frame`` loop),
    where ``when`` (a device bool) holds."""
    F = buf.shape[0]
    dev = buf.device
    base = ix.clamp(0, F - W4)
    rows = base + torch.arange(W4, dtype=I64, device=dev)
    ok = (rows >= ix) & (rows < ix + W4) & (rows < end)
    if when is not None:
        ok = ok & when
    vals = buf[(rows + 1).clamp(0, F - 1)]
    m = ok.reshape((-1,) + (1,) * (buf.dim() - 1))
    buf[rows] = torch.where(m, vals, buf[rows])
    return buf


# ---------------------------------------------------------------------
# the frame program
# ---------------------------------------------------------------------


def corr_route(device, h, w):
    """How the program's update reads correlation at h x w features:
    "volume" (K1's volumes once an update call, K2 a step; the card,
    narrow streams), "indexed" (K3 a step on a pyramid pooled once; the
    card, wide streams) or "plain" (the chunked plain lookup; the CPU).
    On the CPU the first two run the kernels' plain versions."""
    if torch.device(device).type != "cuda":
        return "plain"
    return "volume" if cuda_corr.volume_cache_ok(h, w) else "indexed"


class PlannerProgram:
    """One frame of the planner on the state of ``system``, in place.
    Every Python value here is fixed when PlannerDriver builds it."""

    def __init__(self, system, st, EBMAX):
        sysm = system
        cfg = sysm.cfg
        fe, g, v = sysm.frontend, sysm.frontend.graph, sysm.video
        self.sys, self.st = sysm, st
        self.graph, self.video, self.net = g, v, sysm.net
        self.EBMAX = EBMAX
        self.K = self.P = 32
        self.PAIRS = 2048
        self.CJ = self.WD = 32
        self.iters = 2
        self.steps, self.steps2 = fe.iters1, fe.iters2
        self.max_age = cfg.max_age
        self.mf_thresh = float(sysm.filterx.thresh)
        self.rad, self.nms = cfg.frontend_radius, cfg.frontend_nms
        self.prox_thresh = float(cfg.frontend_thresh)
        self.window = cfg.frontend_window
        self.max_factors = g.max_factors
        self.damp_fac, self.EP, self.lm, self.ep = 0.2, 1e-7, 1e-4, 0.1
        self.beta = float(cfg.beta)
        self.kf_thresh = float(cfg.keyframe_thresh)

    # ---- helpers over the static state ----

    def _gt(self):
        st = self.st
        return {"ii": st.ii.clone(), "jj": st.jj.clone(),
                "age": st.age.clone(), "valid": st.valid.clone(),
                "inac_ii": st.inac_ii.clone(), "inac_jj": st.inac_jj.clone(),
                "inac_valid": st.inac_valid.clone(),
                "n": st.topo_n[0].clone(), "inac_n": st.topo_n[1].clone()}

    def _store_gt(self, gt):
        st = self.st
        for key in ("ii", "jj", "age", "valid", "inac_ii", "inac_jj",
                    "inac_valid"):
            getattr(st, key).copy_(gt[key])
        st.topo_n.copy_(torch.stack([gt["n"], gt["inac_n"]]))

    def _ebufs(self):
        st = self.st
        return (st.net, st.target, st.weight, st.raw, st.dy, st.flow,
                st.t_inac, st.w_inac)

    # ---- the program ----

    def __call__(self, br):
        st, v = self.st, self.video
        sc = st.scal.clone()
        counter, t1, pending = sc[S_COUNTER], sc[S_T1], sc[S_PENDING]
        probe_t1, d0_prev, flags0 = sc[S_PROBE_T1], sc[S_D0], sc[S_FLAGS]
        d_prev = st.dvec[0].clone()

        # evaluated before the removal, which lowers t1 and counter
        # together (the classic track order)
        update_will_run = t1 < counter
        do_resolve = update_will_run & (pending == 1)

        # ---- phase A: the last frame's probe ----
        removed = do_resolve & (d_prev < self.kf_thresh)
        rm_ix = probe_t1 - 2
        for buf in (v.poses, v.disps, v.intrinsics, v.nets, v.inps,
                    v.fmaps, v.segms, v.images):
            _shift_window_rows(buf, rm_ix, counter, when=removed)
        gt = self._gt()
        drop_a = ((gt["ii"] == rm_ix) | (gt["jj"] == rm_ix)) & \
            gt["valid"] & removed
        for key in ("ii", "jj", "inac_ii", "inac_jj"):
            gt[key] = torch.where(removed & (gt[key] >= rm_ix),
                                  gt[key] - 1, gt[key])
        WD = self.WD
        k = rm_ix - d0_prev
        idx = torch.arange(WD, dtype=I64, device=sc.device)
        mp = torch.where(idx >= k, idx + 1, idx)
        oob = mp >= WD
        mpc = mp.clamp(0, WD - 1)
        dm = st.dmat[mpc][:, mpc]
        dm = torch.where(oob[:, None] | oob[None, :],
                         torch.full_like(dm, INF), dm)
        st.dmat.copy_(torch.where(removed & (k >= 0) & (k < WD), dm,
                                  st.dmat))
        gt, _ = _retire_edges(gt, self._ebufs(), drop_a, store=False)
        credit = do_resolve & (~removed)
        gt["age"] = torch.where(credit & gt["valid"],
                                gt["age"] + self.steps2, gt["age"])
        counter = counter - removed.long()
        t1 = t1 - removed.long()
        pending = torch.where(do_resolve, torch.zeros_like(pending),
                              pending)
        self._store_gt(gt)

        # ---- phase B: the motion filter ----
        admitted = track_body_device(
            self.net, v, st.mf_fmap, st.mf_net, st.mf_inp, st.image,
            st.intr8, st.segm, counter, self.mf_thresh)

        # ---- phase C: the frontend update, where one is due ----
        st.bout.copy_(torch.stack([t1, d0_prev] + [torch.zeros_like(t1)]
                                  * 5))
        st.dout.copy_(d_prev.reshape(1))
        br.cond(update_will_run.reshape(()),
                lambda: self._update(br, counter, t1), "update")

        bo = st.bout
        ran = bo[B_RAN] == 1
        pending = torch.where(ran, torch.ones_like(pending), pending)
        probe_t1 = torch.where(ran, bo[B_T1], probe_t1)
        counter_out = counter + admitted.long()
        flags = flags0 | bo[B_FLAGS]
        n, inac_n = st.topo_n[0], st.topo_n[1]
        st.scal.copy_(torch.stack([counter_out, bo[B_T1], pending, probe_t1,
                                   bo[B_D0], n, inac_n, flags]))
        st.dvec.copy_(st.dout)
        st.record.copy_(torch.stack([
            admitted.long(), bo[B_RAN], removed.long(), rm_ix, counter_out,
            bo[B_T1], n, inac_n, flags, bo[B_NNEW], bo[B_SMALL],
            bo[B_STEPS2]]))

    def _update(self, br, counter, t1):
        st, v = self.st, self.video
        F = v.poses.shape[0]
        t1c = t1 + 1
        d0_prev = st.scal[S_D0]
        EBMAX = self.EBMAX
        gt = self._gt()
        ebufs = self._ebufs()

        # aged-edge retirement (the host frontend's first step)
        gt, _ = _retire_edges(gt, ebufs, gt["age"] > self.max_age,
                              store=True)

        new_ii, new_jj, n_new, flags = _device_proximity(
            gt, st.dmat, d0_prev, counter, t1c, self.CJ, self.rad, self.nms,
            self.prox_thresh, self.window)

        # the reference's cap eviction: edge k drops iff
        # argsort(age, stable)[k] >= cap - n_new
        need = (gt["n"] + n_new > self.max_factors) & (n_new > 0)
        keys = torch.where(gt["valid"], gt["age"],
                           torch.full_like(gt["age"], 1 << 30))
        srt = torch.argsort(keys, stable=True)
        drop_cap = need & (srt >= self.max_factors - n_new) & gt["valid"]
        gt, _ = _retire_edges(gt, ebufs, drop_cap, store=True)

        gt, fresh_mask, aflags = _append_edges(gt, new_ii, new_jj, n_new,
                                               EBMAX)
        flags = flags | aflags | torch.where(gt["n"] == 0, F_EMPTY, 0)
        self._store_gt(gt)

        # the regime: compute scales with the padded widths, so the
        # compact one runs wherever the true counts fit
        ii_r, jj_r, valid_r = gt["ii"], gt["jj"], gt["valid"]
        big = 1 << 20
        t0b = (torch.where(valid_r, ii_r, torch.full_like(ii_r, big)).min()
               + 1).clamp(min=1)
        t1b = torch.where(valid_r, torch.maximum(ii_r, jj_r),
                          torch.full_like(ii_r, -1)).max() + 1
        sel = (gt["inac_valid"] & (gt["inac_ii"] >= t0b - 3) &
               (gt["inac_jj"] >= t0b - 3))
        nsel = sel.sum()
        iiv = torch.cat([torch.where(sel, gt["inac_ii"],
                                     torch.full_like(gt["inac_ii"], F)),
                         torch.where(valid_r, ii_r,
                                     torch.full_like(ii_r, F))])
        cnt = (iiv[:, None] == torch.arange(F, device=iiv.device)[None]
               ).long().sum(0)
        pairs_total = (cnt * cnt).sum()
        small = (gt["n"] <= EB_S) & (nsel <= EI_S) & (pairs_total <= PAIRS_S)
        if FORCE_LARGE:
            small = small & False
        st.bout[B_SMALL] = small.long()
        ctx = dict(gt=gt, fresh_mask=fresh_mask, sel=sel, nsel=nsel,
                   t0b=t0b, t1b=t1b, t1c=t1c)
        MI = st.t_inac.shape[0]
        br.cond(small, lambda: self._regime(br, ctx, EB_S, EI_S, PAIRS_S,
                                            True), "compact")
        br.cond(~small, lambda: self._regime(br, ctx, EBMAX, MI, self.PAIRS,
                                             False), "full")

        # the next keyframe's seed (droid_frontend.py:64-66)
        i1 = t1c.reshape(1)
        v.poses[i1] = v.poses[i1 - 1]
        v.disps[i1] = v.disps[i1 - 1].mean().expand(v.disps.shape[1:])[None]

        # edges age by the base steps (the extra ones are credited when
        # the next frame resolves the probe)
        st.age.copy_(torch.where(gt["valid"], gt["age"] + self.steps,
                                 gt["age"]))

        # the window distance matrix of the next frame's proposal
        d0n = (counter + 1 - self.WD).clamp(min=0)
        st.dmat.copy_(window_distance_matrix(
            v.poses, v.disps, v.intrinsics[0], d0n, self.WD, self.beta))
        st.bout[:B_SMALL] = torch.stack([
            t1c, d0n, flags | st.bout[B_FLAGS], n_new,
            torch.ones_like(t1c)])

    def _regime(self, br, ctx, EBC, EIC, PAIRSC, compact):
        """The update phase at static widths: EBC active edges, EIC
        inactive BA extras (compacted, ring order kept) or the whole ring
        in place, PAIRSC same-source pairs."""
        st, v, g = self.st, self.video, self.graph
        dev = v.poses.device
        F = v.poses.shape[0]
        K, P = self.K, self.P
        gt, fresh_mask = ctx["gt"], ctx["fresh_mask"]
        intrinsics = v.intrinsics[0]
        ii_e, jj_e = gt["ii"][:EBC], gt["jj"][:EBC]
        valid_e = gt["valid"][:EBC]

        # fresh-edge initialization (the classic _init_fresh)
        intr_b = intrinsics.expand(1, F, 4)
        coords_new, _ = projective.projective_transform(
            v.poses[None], v.disps[None], intr_b, ii_e, jj_e)
        fm = fresh_mask[:EBC, None, None, None]
        st.target[:EBC] = torch.where(fm, coords_new[0], st.target[:EBC])
        for buf in (st.weight, st.raw, st.dy, st.flow):
            buf[:EBC] = torch.where(fm, torch.zeros_like(buf[:EBC]),
                                    buf[:EBC])
        st.net[:EBC] = torch.where(fm, v.nets[ii_e].to(st.net.dtype),
                                   st.net[:EBC])

        # the inactive BA extras
        sel, nsel = ctx["sel"], ctx["nsel"]
        MI = st.t_inac.shape[0]
        if compact:
            rank = torch.cumsum(sel.long(), 0) - 1
            dsti = torch.where(sel & (rank < EIC), rank,
                               torch.full_like(rank, EIC))
            srows = _set_drop(torch.zeros(EIC, dtype=I64, device=dev), dsti,
                              torch.arange(MI, dtype=I64, device=dev))
            iv = torch.arange(EIC, device=dev) < nsel
            i_ii = torch.where(iv, gt["inac_ii"][srows], 0)
            i_jj = torch.where(iv, gt["inac_jj"][srows], 0)
            extra_target, extra_weight = st.t_inac[srows], st.w_inac[srows]
        else:
            iv, i_ii, i_jj = sel, gt["inac_ii"], gt["inac_jj"]
            extra_target, extra_weight = st.t_inac, st.w_inac

        ii_ba = torch.cat([i_ii, ii_e])
        jj_ba = torch.cat([i_jj, jj_e])
        valid_ba = torch.cat([iv, valid_e])
        big = 1 << 20
        w0 = torch.where(valid_ba, ii_ba, torch.full_like(ii_ba, big)).min()
        kmax = torch.where(valid_ba, ii_ba, torch.full_like(ii_ba, -1)).max()
        t0b, t1b = ctx["t0b"], ctx["t1b"]
        rflags = torch.where((kmax - w0 + 1 > K) | (t1b - t0b > P),
                             F_WIN_OVF, 0)
        pa, pb, pv, p_ovf = _build_pairs(ii_ba, valid_ba, PAIRSC)
        rflags = rflags | torch.where(p_ovf, F_PAIR_OVF, 0)

        core = dict(ii=ii_e, jj=jj_e, valid=valid_e, w0=w0, K=K,
                    **self._invariants(ii_e, jj_e))

        def one_step():
            net, target, weight, raw, dy, flow, eta, has_edge = \
                fg.update_core(g, st.net[:EBC], st.target[:EBC],
                               st.raw[:EBC], st.dy[:EBC], **core)
            st.net[:EBC] = net.to(st.net.dtype)
            for buf, val in ((st.target, target), (st.weight, weight),
                             (st.raw, raw), (st.dy, dy), (st.flow, flow)):
                buf[:EBC] = val
            krows = (w0 + torch.arange(K, device=dev)).clamp(0, F - 1)
            v.damping[krows] = torch.where(has_edge[:, None, None], eta,
                                           v.damping[krows])
            eta_k = self.damp_fac * v.damping[krows] + self.EP
            poses, disps = dba_mod.dba(
                v.poses, v.disps, intrinsics,
                torch.cat([extra_target, st.target[:EBC]]),
                torch.cat([extra_weight, st.weight[:EBC]]), eta_k,
                ii_ba, jj_ba, valid_ba, pa, pb, pv, t0b, t1b, w0, P=P, K=K,
                iters=self.iters, motion_only=False, ep=self.ep, lm=self.lm)
            v.poses.copy_(poses)
            v.disps.copy_(disps)

        for _ in range(self.steps):
            one_step()

        # the removal probe and the extra steps where the keyframe stays
        t1c = ctx["t1c"]
        di, dj = (t1c - 3).reshape(1), (t1c - 2).reshape(1)
        d = 0.5 * (frame_distance(v.poses, v.disps, intrinsics, di, dj,
                                  self.beta) +
                   frame_distance(v.poses, v.disps, intrinsics, dj, di,
                                  self.beta))
        keep = d[0] >= self.kf_thresh
        st.bout[B_STEPS2] = keep.long()

        def extra():
            for _ in range(self.steps2):
                one_step()

        br.cond(keep, extra, "steps2")
        st.dout.copy_(d)
        st.bout[B_FLAGS] = rflags.long()

    def lookup_operands(self, ii_e, jj_e):
        """K3's operands on the indexed route for edges (ii_e, jj_e): the
        features of their 2E frames (gathered), those frames' pyramid,
        pooled once, and each edge's two rows of them."""
        v = self.video
        E = ii_e.shape[0]
        frames = v.fmaps[torch.cat([ii_e, jj_e])]
        fi = torch.arange(E, dtype=torch.int32, device=v.device)
        return frames, cuda_corr.lookup_pyramid(frames), fi, fi + E

    def _invariants(self, ii_e, jj_e):
        """The correlation operands of one update call (K1's volumes on
        the card for narrow streams, else a pyramid pooled once for K3;
        the plain lookup on the CPU), the context gate terms and the
        edges' segments."""
        v, g = self.video, self.graph
        cdt = next(g.update_op.parameters()).dtype
        route = corr_route(v.device, v.h, v.w)
        if route == "volume":
            vols = cuda_corr.build_volumes(v.fmaps[ii_e], v.fmaps[jj_e])
            corr_fn = lambda c1: cuda_corr.corr_extract(vols, c1)  # noqa
        elif route == "indexed":
            ops = self.lookup_operands(ii_e, jj_e)
            corr_fn = lambda c1: cuda_corr.corr_lookup_indexed(  # noqa
                *ops, c1)
        else:
            corr_fn = lambda c1: corr_ops.chunked_corr_lookup(  # noqa
                v.fmaps, ii_e, jj_e, c1, chunk=fg.CORR_CHUNK)
        return dict(corr_fn=corr_fn,
                    ctx_pre=fg.gru_ctx_pre(g.gru_ctx, v.inps[ii_e].to(cdt)),
                    segms_e=v.segms[ii_e])


# ---------------------------------------------------------------------
# the host driver
# ---------------------------------------------------------------------


class PlannerDriver:
    """Runs the planner's frames for a :class:`VOSystem`.

    Engaged by the system after initialization, once the classic path
    has resolved a distance matrix; disengaged (one blocking read of the
    device's state into the classic mirrors) before terminate, the
    backend and the accessors, so that everything downstream runs the
    classic code."""

    EBMAX = 48           # the reference frontend's max_factors
    RETRY_COOLDOWN = 30  # frames between engage attempts after a miss
    WARMUP = 2           # eager frames on the card before the capture
    REC_SLOTS = 4        # pinned record buffers in flight

    def __init__(self, system):
        self.sys = system
        self.engaged = False
        self.n_removed = 0
        self.overflow = 0
        self.n_overflows = 0
        self.cooldown = 0
        self._records = []       # [(slot, tstamp, replayed)]
        self._host_counter = 0
        self._last_refusal = None
        # on the card: capture the frame program as a CUDA graph (False:
        # run it eagerly, the reference the graph is held against)
        self.use_graph = True
        self.st = None
        self.program = None
        self.frame_graph = None
        self.eager_frames = 0
        self.frames = 0

    # ---------------- engagement ----------------

    def _blockers(self):
        """Engagement blockers from the host mirrors (no device read)."""
        fe = self.sys.frontend
        g = fe.graph
        out = []
        if not fe.is_initialized:
            out.append("not_initialized")
        if g.n_edges == 0:
            out.append("no_edges")
        if len(g.ii_bad) > 0:
            out.append(f"bad_edges={len(g.ii_bad)}")
        if g.n_edges > self.EBMAX:
            out.append(f"n_edges={g.n_edges}>{self.EBMAX}")
        if len(g.ii_inac) > g.max_inactive:
            out.append(f"inactive={len(g.ii_inac)}>{g.max_inactive}")
        return out

    def precheck(self):
        """The per-frame gate of an engage attempt: the host mirrors
        only; a refusal backs off RETRY_COOLDOWN frames and is logged
        once per distinct set of blockers."""
        if self.cooldown > 0:
            self.cooldown -= 1
            return False
        blockers = self._blockers()
        if blockers:
            if blockers != self._last_refusal:
                log.info("planner engage refused: %s", ", ".join(blockers))
                self._last_refusal = blockers
            self.cooldown = self.RETRY_COOLDOWN
            return False
        return True

    def can_engage(self):
        fe = self.sys.frontend
        return (not self._blockers() and fe._dmat is not None and
                fe._packet is None)

    def _statics(self):
        """The program's static buffers, allocated once per system: the
        video's frame buffers (adopted at the first engage), the edge
        state at the planner's widths, the topology, the scalars, the
        frame's inputs and the record."""
        sysm = self.sys
        g, v = sysm.frontend.graph, sysm.video
        dev = v.device
        st = types.SimpleNamespace()
        E, MI, h, w = self.EBMAX, g.max_inactive, v.h, v.w
        z = dict(device=dev)
        st.net = torch.zeros((E, h, w, 128), dtype=g.net_dtype, **z)
        for key in ("target", "weight", "raw", "dy", "flow"):
            setattr(st, key, torch.zeros((E, h, w, 2), **z))
        st.t_inac = torch.zeros((MI, h, w, 2), **z)
        st.w_inac = torch.zeros((MI, h, w, 2), **z)
        for key in ("ii", "jj", "age"):
            setattr(st, key, torch.zeros(E, dtype=I64, **z))
        st.valid = torch.zeros(E, dtype=torch.bool, **z)
        st.inac_ii = torch.zeros(MI, dtype=I64, **z)
        st.inac_jj = torch.zeros(MI, dtype=I64, **z)
        st.inac_valid = torch.zeros(MI, dtype=torch.bool, **z)
        st.topo_n = torch.zeros(2, dtype=I64, **z)
        st.scal = torch.zeros(SCAL_W, dtype=I64, **z)
        st.dvec = torch.zeros(1, **z)
        st.dmat = torch.zeros((32, 32), **z)
        st.bout = torch.zeros(7, dtype=I64, **z)
        st.dout = torch.zeros(1, **z)
        st.record = torch.zeros(REC_W, dtype=I64, **z)
        for key in ("mf_fmap", "mf_net", "mf_inp"):
            setattr(st, key, torch.zeros((h, w, 128), **z))
        st.image = torch.zeros((v.ht, v.wd, 3), dtype=torch.uint8, **z)
        st.intr8 = torch.zeros(4, **z)
        st.segm = torch.zeros((h, w), dtype=torch.long, **z)
        # the video's frame buffers: adopted as they are, and from then
        # on written in place
        st.video = {name: getattr(v, name)
                    for name in (*v.FRAME_FIELDS, "damping")}
        if dev.type == "cuda":
            pin = dict(pin_memory=True)
            st.rec_host = torch.zeros((self.REC_SLOTS, REC_W), dtype=I64,
                                      **pin)
            st.rec_events = [torch.cuda.Event() for _ in
                             range(self.REC_SLOTS)]
            st.in_host = [(torch.zeros((v.ht, v.wd, 3), dtype=torch.uint8,
                                       **pin),
                           torch.zeros(4, **pin),
                           torch.zeros((h, w), dtype=torch.long, **pin))
                          for _ in range(2)]
            st.in_events = [None, None]
        return st

    def engage(self):
        """One blocking sync: flush the classic state and upload the
        topology mirrors and the distance matrix into the static
        buffers, so that a re-engagement replays the same graph."""
        sysm = self.sys
        fe, g, v, fx = sysm.frontend, sysm.frontend.graph, sysm.video, \
            sysm.filterx
        assert self.can_engage()
        if self.st is None:
            self.st = self._statics()
            self.program = PlannerProgram(sysm, self.st, self.EBMAX)
        st = self.st
        for name, buf in st.video.items():
            cur = getattr(v, name)
            if cur is not buf:
                buf.copy_(cur)
                setattr(v, name, buf)
        n, ni = g.n_edges, len(g.ii_inac)
        dev = v.device

        def put(dst, src):
            dst.zero_()
            if len(src):
                dst[:len(src)] = torch.as_tensor(np.asarray(src),
                                                 dtype=dst.dtype, device=dev)

        put(st.ii, g.ii)
        put(st.jj, g.jj)
        put(st.age, g.age)
        st.valid.copy_(torch.arange(self.EBMAX, device=dev) < n)
        put(st.inac_ii, g.ii_inac)
        put(st.inac_jj, g.jj_inac)
        st.inac_valid.copy_(torch.arange(g.max_inactive, device=dev) < ni)
        for key, src in (("net", g.net), ("target", g.target),
                         ("weight", g.weight), ("raw", g.raw_mask),
                         ("dy", g.delta_dy), ("flow", g.full_flow)):
            getattr(st, key)[:n] = src
        st.t_inac[:ni] = g.target_inac
        st.w_inac[:ni] = g.weight_inac
        st.topo_n.copy_(torch.tensor([n, ni], device=dev))
        scal = np.zeros(SCAL_W, np.int64)
        scal[S_COUNTER] = v.counter
        scal[S_T1] = fe.t1
        scal[S_PROBE_T1] = fe.t1
        scal[S_D0] = fe._d0
        scal[S_N] = n
        scal[S_INACN] = ni
        st.scal.copy_(torch.as_tensor(scal, device=dev))
        st.dvec.zero_()
        st.dmat.copy_(torch.as_tensor(np.asarray(fe._dmat, np.float32),
                                      device=dev))
        st.mf_fmap.copy_(fx._fmap)
        st.mf_net.copy_(fx._net)
        st.mf_inp.copy_(fx._inp)
        self._host_counter = v.counter
        self._records = []
        self.overflow = 0
        self._last_refusal = None
        self.engaged = v.engaged = True
        log.info("planner engaged at frame %d (n_edges=%d, inactive=%d)",
                 v.counter, n, ni)

    # ---------------- per frame ----------------

    def _upload(self, image, intrinsics, segments):
        """The frame's inputs into the static input buffers: on the card
        through pinned memory (two buffers, each reused once its last
        copy has ended), so the host does not wait for the card."""
        st, v = self.st, self.sys.video
        if segments is not None and v.segm_filter:
            segm = v._remap_segments(segments)
        else:
            segm = np.zeros((v.h, v.w), np.int64)
        image = np.ascontiguousarray(image)
        intr8 = np.asarray(intrinsics, np.float32) / 8.0
        if v.device.type != "cuda":
            st.image.copy_(torch.from_numpy(image))
            st.intr8.copy_(torch.from_numpy(intr8))
            st.segm.copy_(torch.from_numpy(np.asarray(segm, np.int64)))
            return
        slot = self.frames % 2
        if st.in_events[slot] is not None:
            st.in_events[slot].synchronize()
        himg, hintr, hsegm = st.in_host[slot]
        himg.numpy()[...] = image
        hintr.numpy()[...] = intr8
        hsegm.numpy()[...] = segm
        st.image.copy_(himg, non_blocking=True)
        st.intr8.copy_(hintr, non_blocking=True)
        st.segm.copy_(hsegm, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        st.in_events[slot] = ev

    def _run(self):
        """One frame program: eager, the capture, or a replay. Returns
        whether it was a replay."""
        dev = self.sys.video.device
        if dev.type != "cuda":
            self.program(graph_capture.Eager())
            return False
        if not self.use_graph or self.eager_frames < self.WARMUP:
            # eager frames on a side stream warm up the libraries'
            # handles and workspaces before the capture
            side = graph_capture.stream(dev, 0)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.program(graph_capture.Eager())
            torch.cuda.current_stream(dev).wait_stream(side)
            self.eager_frames += 1
            return False
        if self.frame_graph is None:
            fgr = graph_capture.FrameGraph(dev)
            fgr.capture(self.program)
            self.frame_graph = fgr
        self.frame_graph.replay()
        return True

    def track(self, tstamp, image, intrinsics, segments=None):
        st = self.st
        self._upload(image, intrinsics, segments)
        replayed = self._run()
        if st.record.is_cuda:
            slot = self.frames % self.REC_SLOTS
            st.rec_host[slot].copy_(st.record, non_blocking=True)
            st.rec_events[slot].record()
        else:
            slot = st.record.clone()
        self.frames += 1
        self._records.append((slot, float(tstamp), replayed))
        # records resolve two frames behind: their copies ended while
        # the frames in between ran
        while len(self._records) > 2:
            self._resolve_one()
        if self.overflow:
            self.n_overflows += 1
            self.cooldown = self.RETRY_COOLDOWN * min(
                2 ** self.n_overflows, 32)
            log.warning("planner overflow (%s) at frame %d: disengaging "
                        "to the classic path; re-engage after %d frames",
                        flag_names(self.overflow), self._host_counter,
                        self.cooldown)
            self.disengage()

    def _resolve_one(self):
        slot, ts, replayed = self._records.pop(0)
        st = self.st
        if torch.is_tensor(slot):
            rec = slot.numpy()
        else:
            st.rec_events[slot].synchronize()
            rec = st.rec_host[slot].numpy().copy()
        if replayed:
            self.frame_graph.count(self.sections(rec))
        v = self.sys.video
        if rec[R_FLAGS] and not self.overflow:
            self.overflow = int(rec[R_FLAGS])
        # the removal (from the previous frame's probe) lands before this
        # frame's admission, as in the program
        if rec[R_RAN] and rec[R_REMOVED]:
            ix = int(rec[R_RMIX])
            for off in range(ix, self._host_counter - 1):
                v.tstamp[off] = v.tstamp[off + 1]
            self._host_counter -= 1
            self.n_removed += 1
        if rec[R_ADM]:
            v.tstamp[self._host_counter] = ts
            self._host_counter += 1
            self.sys.filterx.count = 0
        else:
            self.sys.filterx.count += 1
        return rec

    @staticmethod
    def sections(rec):
        """The conditional sections a frame with record ``rec`` ran."""
        if not rec[R_RAN]:
            return ()
        regime = "compact" if rec[R_SMALL] else "full"
        out = [("update",), ("update", regime)]
        if rec[R_STEPS2]:
            out.append(("update", regime, "steps2"))
        return tuple(out)

    # ---------------- disengagement ----------------

    def disengage(self):
        """One blocking read: rebuild the classic host mirrors (topology,
        counters, the pending packet, the edge state) so that terminate
        and the backend run the classic code."""
        if not self.engaged:
            return
        sysm = self.sys
        fe, g, v, fx = sysm.frontend, sysm.frontend.graph, sysm.video, \
            sysm.filterx
        st = self.st
        while self._records:
            self._resolve_one()
        scal = st.scal.cpu().numpy()
        n, ni = int(scal[S_N]), int(scal[S_INACN])
        g.ii = st.ii[:n].cpu().numpy().astype(np.int64)
        g.jj = st.jj[:n].cpu().numpy().astype(np.int64)
        g.age = st.age[:n].cpu().numpy().astype(np.int64)
        g.fresh = np.zeros(n, bool)
        g.ii_inac = st.inac_ii[:ni].cpu().numpy().astype(np.int64)
        g.jj_inac = st.inac_jj[:ni].cpu().numpy().astype(np.int64)
        g.net = st.net[:n].clone()
        g.target = st.target[:n].clone()
        g.weight = st.weight[:n].clone()
        g.raw_mask = st.raw[:n].clone()
        g.delta_dy = st.dy[:n].clone()
        g.full_flow = st.flow[:n].clone()
        g.target_inac = st.t_inac[:ni].clone()
        g.weight_inac = st.w_inac[:ni].clone()
        fx._fmap = st.mf_fmap.clone()
        fx._net = st.mf_net.clone()
        fx._inp = st.mf_inp.clone()
        v.counter = int(scal[S_COUNTER])
        fe.t1 = int(scal[S_T1])
        assert v.counter == self._host_counter, \
            (v.counter, self._host_counter)
        fe._d0 = int(scal[S_D0])
        dmat = st.dmat.cpu().numpy()
        if scal[S_PENDING]:
            # the unconsumed probe goes back to the classic packet, whose
            # resolution applies the removal or the credit as phase A
            # would have
            d = float(st.dvec.cpu()[0])
            fe._packet = (np.concatenate([[d], dmat.reshape(-1)]),
                          int(scal[S_D0]), int(scal[S_PROBE_T1]), fe.iters2)
            fe._dmat = None
        else:
            fe._packet = None
            fe._dmat = dmat
        self.engaged = v.engaged = False
        log.info("planner disengaged at frame %d (flags=%s)", v.counter,
                 flag_names(int(scal[S_FLAGS])))
