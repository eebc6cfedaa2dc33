"""Live tracking: one camera's frames handed to ``VOSystem.track`` back
to back (a closed loop: the next frame is handed over when the call
returns), with the planner engaged, so that each frame is one replay of
the frame program's CUDA graph.

Set-up builds the system from the configuration's weights and tracks
``warm_frames`` frames (initialization, the planner's engage, its eager
frames and its capture). The window then tracks frames until
``--seconds`` have passed on the host clock, with no synchronize: a
CUDA event recorded after each call and read after the window gives the
frame's completion on the clock of an event recorded at the window's
start, and its latency from the call. Every frame is a keyframe, so the
stream is played as a clip that fits the configuration's buffer: where
the next frames would fill it (less ``clip_margin``), the clip restarts
from the state after the warm-up (see ``_Clip``). With ``--trace 1``
the window is followed by ``traced_frames`` frames under the profiler.

The check: ``check_frames`` frames drawn from the seed among the
``check_span`` that follow the warm-up (before the window, so that no
copy or synchronize lands in it) are tracked on the same path, the same
replayed graph, with the program's state copied to the host before and
after each. Once the window has closed, the peak memory is read and the
program is freed, the reference recomputes each of those frames from
the state before it: the encoders of the new image, and the frontend
update's recurrent steps and DBA over the edges the program chose, from
its poses, disparities, stored features and edge states (fresh edges
initialized as the program initializes them). It is compared with what
the program wrote: the encoders' outputs, the edges' flow targets and
confidence weights, and the edges' pixels carried through the poses and
disparities the DBA solved for. A frame is judged only where the
reference itself is well-conditioned: recomputed from its start with the
poses' translations moved by ``conditioning.perturb`` (float32's
rounding), it moves by at most ``conditioning.max_move_px``; with random
weights a few states are not (``pvo_bench/witness.py conditioning``),
and a run in which no checked frame can be judged fails.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pvo_bench import check, program, trace
from pvo_bench.harness import log
from pvo_bench.reference import geometry as ref_geo
from pvo_bench.reference import net as ref_net
from pvo_bench.reference import vo as ref_vo
from pvo_bench.stream import Stream

BIG = 1 << 20
# the motion filter's probe, launched once a frame: the traced frames'
# period on the device's timeline
PROBE = "corr_lookup_f32_kernel"


def run(run):
    cfg, traffic = run.config, run.traffic
    H, W = cfg["image_size"]
    dev = program.open_card(run)
    sd = program.weights(cfg, dev)
    sysm = program.build(cfg, sd, dev)
    buffer = sysm.video.buffer
    stream = Stream(run.seed, H, W)
    records, clock = {}, {"wait": 0.0}
    program.record_decisions(sysm, records, clock)

    t = 0
    for _ in range(traffic["warm_frames"]):
        _track(sysm, stream.frame(t))
        t += 1
    program.sync(dev)
    if not sysm.planner.engaged:
        raise RuntimeError("the planner did not engage in the warm-up")
    # ---- the frames checked: drawn from the seed among the first
    # ``check_span`` after the warm-up, their state copied to the host ----
    rng = np.random.default_rng([int(run.seed), 1])
    span = traffic["check_span"]
    picks = set(int(x) for x in rng.choice(span, traffic["check_frames"],
                                           replace=False))
    saved = []
    for i in range(span):
        frame = stream.frame(t)
        if i in picks:
            saved.append(copied(sysm, frame, dev, buffer))
        else:
            _track(sysm, frame)
        t += 1
    # the clip restarts from here when the next frames would fill the
    # buffer: the state after the warm-up and the checked frames
    clip = _Clip(sysm, t, buffer - traffic["clip_margin"])
    marks = program.Marks(dev, 4096)
    run.setup_s = run.since_start()

    # ---- the window ----
    calls, in_track, positions = [], 0.0, []
    first = t
    clock["wait"] = 0.0
    h0 = marks.start()
    run.data["window_epoch"] = time.time()
    while True:
        clip.room(1)
        frame = stream.frame(clip.pos, ts=t)
        positions.append(clip.pos)
        clip.pos += 1
        a = time.perf_counter()
        _track(sysm, frame)
        b = time.perf_counter()
        marks.mark(t - first)
        calls.append(a - h0)
        in_track += b - a
        t += 1
        if b - h0 >= run.seconds:
            break
    n = t - first
    waited = clock["wait"]
    program.sync(dev)
    done = [marks.ms(i) for i in range(n)]
    window_s = done[-1] / 1e3
    lat = [done[i] - 1e3 * calls[i] for i in range(n)]
    engaged = sysm.planner.engaged and sysm.planner.n_overflows == 0
    run.attempted = n
    run.failed = 0 if engaged else n
    run.data.update(frames=n, window_s=window_s, latency_ms=lat,
                    host_s_in_track=in_track - waited,
                    window_frames=(first, t), clip_positions=positions,
                    done_ms=done,
                    image_size=(H, W), records=records,
                    iters=(sysm.cfg.frontend_iters1, sysm.cfg.frontend_iters2))
    log(f"window: {n} frames in {window_s:.3f} s, planner engaged "
        f"throughout: {engaged}; the clip restarted {clip.restarts} times "
        f"(every {clip.end - clip.start} frames)")
    recs = [records[ts] for ts in range(first, t) if ts in records]
    log(f"records: {len(recs)} frames, ran {sum(r[program.R_RAN] for r in recs)}"
        f", compact {sum(r[program.R_SMALL] for r in recs)}, steps2 "
        f"{sum(r[program.R_STEPS2] for r in recs)}, edges "
        f"{sorted(set(r[program.R_N] for r in recs))}, flags "
        f"{sorted(set(r[program.R_FLAGS] for r in recs))}; host waited "
        f"{waited:.3f} s for records")
    # a replayed frame of the clip decides as the first pass did
    seen, differ = {}, 0
    for ts, pos in zip(range(first, t), positions):
        if ts in records:
            key = [records[ts][k] for k in (program.R_RAN, program.R_N,
                                             program.R_FLAGS, program.R_SMALL,
                                             program.R_STEPS2)]
            differ += seen.setdefault(pos, key) != key
    log(f"replayed frames whose record differs from the clip's first "
        f"pass: {differ}")
    run.data["replays_differ"] = differ
    intervals = np.diff(done)
    if len(intervals) >= 3:
        third = len(intervals) // 3
        log("frame intervals ms, quartiles (first third, last third): "
            f"{np.percentile(intervals[:third], [25, 50, 75]).round(2).tolist()} "
            f"{np.percentile(intervals[-third:], [25, 50, 75]).round(2).tolist()}")

    # ---- the traced frames ----
    if run.trace:
        # frames back to back, as in the window; the whole frames between
        # the first and the last probe (one f32 K3 launch a frame) count
        k, w = traffic["traced_frames"], traffic["traced_warmup"]
        clip.room(k + w + 2)
        run.profile = trace.traced(
            lambda i: _track(sysm, stream.frame(clip.pos + i, ts=t + i)), k,
            dev, warmup=w)
        clip.pos += k + w
        if dev.type == "cuda":
            run.profile.periodic(PROBE)
        run.data["traced_frames"] = list(range(t + w, t + w + k))
        t += k + w
    # two more frames resolve the last frames' decision records
    clip.room(2)
    for _ in range(2):
        _track(sysm, stream.frame(clip.pos, ts=t))
        clip.pos += 1
        t += 1
    run.memory_peak = program.memory_peak(dev)

    program.sync(dev)
    fg = sysm.planner.frame_graph           # None where nothing is captured
    run.data["per_replay"] = {
        ts: fg.per_replay(program.frame_sections(rec))
        for ts, rec in records.items()} if fg is not None else {}
    vo = dict(segm=(cfg["vo"]["max_segments"], cfg["vo"]["thresh"])
              if cfg["vo"]["segm_filter"] else None,
              iters1=sysm.cfg.frontend_iters1,
              iters2=sysm.cfg.frontend_iters2)
    del sysm, fg
    program.free()

    t_check = time.perf_counter()
    saved = [(program.to_device(b, dev), program.to_device(a, dev), image)
             for b, a, image in saved]
    cond = traffic["conditioning"]
    judged, moves = 0, []
    for before, after, image in saved:
        ref = reference_frame(sd, before, after, image, vo, dev)
        move = conditioning(sd, before, after, image, vo, dev, ref,
                            cond["perturb"])
        moves.append(move)
        if move > cond["max_move_px"]:
            # the reference itself moves under a perturbation of its
            # start at the level of float32 rounding: no gap here can
            # say anything of the program
            log(f"a checked frame is ill-conditioned: the reference "
                f"moves {move:.4g} px under {cond['perturb']:g}; not judged")
            continue
        judged += 1
        for k, v in gaps(after, ref).items():
            run.readings[k] = max(run.readings.get(k, 0.0), v)
        if run.control is not None:
            for k, v in replay(sd, before, after, image, vo, dev,
                               control=True).items():
                run.control[k] = max(run.control.get(k, 0.0), v)
    run.data.update(judged=judged, conditioning_moves=moves)
    if not judged:
        log("no checked frame could be judged: the run fails")
        run.failed = max(run.attempted, 1)
    log(f"reference: {time.perf_counter() - t_check:.1f} s, {judged} of "
        f"{len(saved)} frames judged (the reference's own moves "
        f"{[float(f'{m:.3g}') for m in moves]} px); readings: " +
        ", ".join(f"{k}={v:.6g}" for k, v in run.readings.items()))


def copied(sysm, frame, dev, buffer):
    """Track ``frame`` with the program's state copied to the host before
    and after it: (before, after, image)."""
    program.sync(dev)
    c = int(sysm.planner.st.scal[program.S_COUNTER])
    lo, hi = max(0, c - 64), min(buffer, c + 40)
    before = program.frame_state(sysm, lo, hi, "cpu")
    _track(sysm, frame)
    program.sync(dev)
    return before, program.frame_state(sysm, lo, hi, "cpu"), frame[1]


class _Clip:
    """The stream as a clip of ``end - start`` frames played over and
    over: where the next frame would pass ``end`` (the buffer less a
    margin), the records in flight are resolved, the system's state from
    frame ``start`` is restored (``program.Snapshot``: the video's first
    rows and the planner's device state, in place, so the captured graph
    replays on them) and the clip plays again from ``start``, as a camera
    would start a new clip without a new system."""

    def __init__(self, sysm, start, end):
        if end - start < 4:
            raise RuntimeError(f"a clip of {end - start} frames: give the "
                               "configuration a larger buffer")
        self.sysm, self.start, self.end = sysm, start, end
        self.pos, self.restarts = start, 0
        self._drain()
        self.snap = program.Snapshot(sysm, rows=min(sysm.video.buffer,
                                                    start + 64))

    def _drain(self):
        planner = self.sysm.planner
        while planner._records:
            planner._resolve_one()

    def room(self, k):
        """Restart unless ``k`` more frames fit in the clip."""
        if self.pos + k > self.end:
            self._drain()
            self.snap.restore()
            self.pos = self.start
            self.restarts += 1



def _track(sysm, frame):
    t, image, intr, segm = frame
    sysm.track(t, image, intr, segments=segm)


def replay(sd, S0, S1, image, vo, dev, control=False):
    """The reference's frame from the state before it, against the
    program's after it. Returns {number: gap}."""
    ref = reference_frame(sd, S0, S1, image, vo, dev, control)
    return gaps(S1, ref)


def conditioning(sd, S0, S1, image, vo, dev, ref, perturb):
    """How far the reference's frame moves when the translations of the
    poses it starts from move by ``perturb``: the larger 90th percentile
    of the pixel moves of the edges' flow targets and of their
    reprojection through the solved poses and disparities (0 where the
    update did not run)."""
    if "target" not in ref:
        return 0.0
    moved = reference_frame(sd, S0, S1, image, vo, dev, perturb=perturb)
    return max(check.flow_gaps(moved["target"], ref["target"])[1],
               check.flow_gaps(moved["reproj"], ref["reproj"])[1])


def gaps(S1, ref):
    """{number: gap} of the program's frame ``S1`` (or of another
    reference frame in its layout) against the reference's ``ref``."""
    rows, c0 = S1["rows"], ref["c0"]
    out = {"enc": max(check.rel_gap(rows[k][c0 - S1["lo"]], ref[k])
                      for k in ("fmaps", "nets", "inps"))}
    if "target" not in ref:
        return out
    idx, sl = ref["idx"], ref["window"]
    out.update(check.named("flow", check.flow_gaps(
        S1["target"][idx], ref["target"]), ("p50", "p90", "max")))
    # the mask logits, the confidence weights and the dynamic flow: the
    # heads' outputs as the edges keep them
    out.update(check.named("raw", check.abs_gaps(
        S1["raw"][idx], ref["raw"]), ("p50", "p90")))
    out.update(check.named("weight", check.abs_gaps(
        S1["weight"][idx], ref["weight"]), ("p50", "p90")))
    out["dy_max"] = check.abs_gaps(S1["dy"][idx], ref["dy"])[2]
    # the DBA's result where it is determined: the edges' pixels carried
    # through the poses and disparities it solved for
    out.update(check.named("reproj", check.flow_gaps(
        ref_geo.reproject(S1["poses"], S1["disps"], S1["intr"],
                          ref["ii"], ref["jj"])[0], ref["reproj"]),
        ("p50", "p90", "max")))
    out.update(check.named("pose", check.pose_gaps(
        S1["poses"][sl[0]:sl[1]], ref["poses"][sl[0]:sl[1]]),
        ("p50", "max")))
    out.update(check.named("disp", check.disp_gaps(
        S1["disps"][sl[2]:sl[1]], ref["disps"][sl[2]:sl[1]]),
        ("p50", "p90", "max")))
    return out


def reference_frame(sd, S0, S1, image, vo, dev, control=False, perturb=0.0):
    """The reference's frame from the program's state ``S0`` before it,
    over the edges the program chose (read from ``S1``): the encoders'
    outputs, and where the update ran the edges' state, the poses and
    disparities and the edges' reprojection through them. ``perturb`` is
    added to the translations of the poses it starts from (the
    conditioning witness, ``pvo_bench/witness.py``)."""
    op_cast, prec = check.precision(control)
    c0 = int(S0["scal"][program.S_COUNTER])
    t1 = int(S0["scal"][program.S_T1])
    rec = [int(x) for x in S1["record"]]
    lo = S1["lo"]
    with torch.no_grad(), prec:
        img = torch.as_tensor(np.ascontiguousarray(image))[None].to(dev)
        fmap, hid, inp = ref_net.encode(img, sd)
        ref = {"c0": c0, "fmaps": fmap[0], "nets": hid[0], "inps": inp[0]}
        if not rec[program.R_RAN]:
            return ref
        steps = vo["iters1"] + vo["iters2"] * rec[program.R_STEPS2]
        idx = S1["valid"].nonzero()[:, 0]
        ii, jj, age = S1["ii"][idx], S1["jj"][idx], S1["age"][idx]
        poses0 = S0["poses"].clone()
        poses0[:, :3] += perturb
        vid = ref_vo.Frames(
            full={"poses": poses0, "disps": S0["disps"],
                  "damping": S0["damping"]},
            rows=S1["rows"], lo=lo, intr=S1["intr"])
        fresh = age == vo["iters1"]
        net_f, tgt_f, raw_f, dy_f = ref_vo.fresh_state(
            vid, poses0, S0["disps"], ii, jj)
        v0 = S0["valid"].nonzero()[:, 0]
        keys0 = S0["ii"][v0] * BIG + S0["jj"][v0]
        keys = ii * BIG + jj
        # an edge kept from the last frame takes its state there; the
        # graph may hold an edge twice, added and updated alike
        hit = keys[:, None] == keys0[None]
        src = v0[hit.long().argmax(1)]
        last = v0[hit.shape[1] - 1 - hit.flip(1).long().argmax(1)]
        if bool((~hit.any(1) & ~fresh).any()) or not torch.equal(
                S0["target"][src][~fresh], S0["target"][last][~fresh]):
            raise RuntimeError("an edge kept from the last frame has no "
                               "single state there")
        pick = (lambda f, old: torch.where(
            fresh[:, None, None, None], f, old[src].float()))
        state = (pick(net_f, S0["net"]), pick(tgt_f, S0["target"]),
                 pick(raw_f, S0["raw"]), pick(dy_f, S0["dy"]))
        t0b = max(1, int(ii.min()) + 1)
        t1b = int(torch.maximum(ii, jj).max()) + 1
        sel = (S1["inac_valid"] & (S1["inac_ii"] >= t0b - 3) &
               (S1["inac_jj"] >= t0b - 3))
        extras = (S1["inac_ii"][sel], S1["inac_jj"][sel], S1["t_inac"][sel],
                  S1["w_inac"][sel])
        w0 = min(int(ii.min()), int(extras[0].min()) if sel.any() else BIG)
        poses, disps, state, weight = ref_vo.refine(
            sd, vid, (ii, jj, torch.ones_like(ii, dtype=torch.bool)), state,
            extras, (t0b, t1b, w0, 32), steps, (0.2, 1e-7),
            dict(iters=2, ep=0.1, lm=1e-4), vo["segm"], op_cast)
        t1c = t1 + 1
        poses[t1c] = poses[t1c - 1]
        disps[t1c] = disps[t1c - 1].mean()
        ref.update(idx=idx, ii=ii, jj=jj, target=state[1], raw=state[2],
                   dy=state[3], weight=weight, poses=poses, disps=disps,
                   window=(t0b, t1c + 1, w0),
                   reproj=ref_geo.reproject(poses, disps, S1["intr"],
                                            ii, jj)[0])
    return ref
