"""The end of a clip: ``VOSystem.terminate(image_stream)`` after a clip
was tracked: the last frontend update, the backend's two global passes
(``backend_steps``) over the whole history and the trajectory filler's
motion-only refinement of every frame, ending in the pose readback.

Set-up tracks ``clip_frames`` frames of the clip of ``clip_seed`` (every
one a keyframe, buffer ``buffer``) with the planner engaged, disengages it (as terminate
would), copies the system's state (``program.Snapshot``) and makes one
terminate call to warm every shape. The window repeats: restore the
state, then one ``terminate`` call timed whole on the host clock (it
ends in the readback of the poses), until ``--seconds`` have passed.
The clip is the same for every seed, since the backend's edges follow
the tracked trajectory; the seed orders the frames handed to
``terminate``, whose filler refines them in batches in that order.
The backend's edges of each call are printed.

With ``--trace 1`` the window's calls also time the backend and the
filler (synchronized around each) and count the work, and one more call
runs under the profiler.

The check: one more call after the window with the state copied where
each backend pass starts and after its first ``check_steps`` steps, and
where the filler starts. With the program freed, the reference
recomputes those steps of each pass from the state at its start and the
edges the program chose (the updates over all edges and the DBA; the
later steps are the same operations on later states), and the filler
from the state after the backend (its encoder on every frame, the
interpolated starts and the motion-only updates), against the call's
trajectory. The call's trajectory is also held to the window's last one
(the restore).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from pvo_bench import bounds, check, program, trace
from pvo_bench.harness import log
from pvo_bench.reference import geometry as ref_geo
from pvo_bench.reference import net as ref_net
from pvo_bench.reference import vo as ref_vo


def run(run):
    from pvo_tpu_torch.vo.factor_graph import FactorGraph
    cfg, traffic = run.config, run.traffic
    H, W = cfg["image_size"]
    h, w = H // 8, W // 8
    dev = program.open_card(run)
    sd = program.weights(cfg, dev)
    sysm = program.build(cfg, sd, dev, buffer=traffic["buffer"])
    from pvo_bench.stream import Stream
    clip = Stream(traffic["clip_seed"], H, W).frames(traffic["clip_frames"])
    for f in clip:
        sysm.track(f[0], f[1], f[2], segments=f[3])
    # the frames handed to terminate: the clip in the seed's order
    order = np.random.default_rng(int(run.seed)).permutation(len(clip))
    frames = [clip[i] for i in order]
    sysm.planner.disengage()
    n_kf = int(sysm.video.counter)
    if n_kf < 0.9 * len(clip):
        raise RuntimeError(f"{n_kf} keyframes of {len(clip)} frames")
    snap = program.Snapshot(sysm)
    steps = tuple(traffic["backend_steps"])
    check_steps = traffic["check_steps"]

    def call():
        return sysm.terminate(iter(frames), backend_steps=steps)

    edges = []

    def counting(lowmem):
        def call(g, *a, **kw):
            edges.append(g.n_edges)
            return lowmem(g, *a, **kw)
        return call

    with program.patched(FactorGraph, "update_lowmem", counting):
        warm = call()
        run.setup_s = run.since_start()
        times, trajs, bad = [], None, 0
        with (_instrumented(sysm, h, w) if run.trace
              else contextlib.nullcontext({})) as counted:
            h0 = time.perf_counter()
            while True:
                snap.restore()
                edges.clear()
                program.sync(dev)
                a = time.perf_counter()
                trajs = call()
                b = time.perf_counter()
                times.append(b - a)
                bad += not np.isfinite(trajs).all()
                log(f"call {len(times)}: {b - a:.4f} s, backend edges "
                    f"{edges}")
                if b - h0 >= run.seconds:
                    break
        run.attempted, run.failed = len(times), bad
        run.data.update(call_s=times, image_size=(H, W), **counted)
        if run.trace:
            shapes = []
            with _dba_shapes(shapes):
                snap.restore()
                run.profile = trace.traced(lambda i: call(), 1, dev)
            run.data["dba_shapes"] = shapes
    run.memory_peak = program.memory_peak(dev)

    # ---- the call checked ----
    snap.restore()
    program.sync(dev)
    v = sysm.video
    feats = {k: getattr(v, k)[:n_kf].clone()
             for k in ("fmaps", "nets", "inps", "segms")}
    intr = v.intrinsics[0].clone()
    with _copies(v, check_steps) as (passes, filler):
        traj = call()
    restore = float(np.abs(traj - trajs).max())
    log(f"the checked call against the window's last: {restore}")
    if restore > 1e-3:
        raise RuntimeError("the restored state does not give the window's "
                           f"trajectory again ({restore})")
    log(f"warm call against the window's last: "
        f"{float(np.abs(warm - trajs).max())}")
    segm = (cfg["vo"]["max_segments"], cfg["vo"]["thresh"]) \
        if cfg["vo"]["segm_filter"] else None
    del sysm, snap
    program.free()
    images = torch.as_tensor(np.stack([f[1] for f in frames]))
    tstamps = np.array([f[0] for f in frames], np.float64)
    t_check = time.perf_counter()
    checked = tuple(min(check_steps, n) for n in steps)
    got = replay(sd, passes, filler, feats, intr, images, tstamps, traj,
                 checked, segm, dev)
    run.readings.update(got)
    if run.control is not None:
        run.control.update(replay(sd, passes, filler, feats, intr, images,
                                  tstamps, traj, checked, segm, dev,
                                  control=True))
    log(f"reference: {time.perf_counter() - t_check:.1f} s; readings: " +
        ", ".join(f"{k}={v:.6g}" for k, v in run.readings.items()))


def replay(sd, passes, filler, feats, intr, images, tstamps, traj, steps,
           segm, dev, control=False):
    """The reference's backend passes and filler from the program's state
    at their starts, against what the program made. {number: gap}."""
    op_cast, prec = check.precision(control)
    out = {}
    with torch.no_grad(), prec:
        for k, (before, p_after, d_after) in enumerate(passes):
            ii, jj, poses, disps, damping, n = before
            vid = ref_vo.Frames({"poses": poses, "disps": disps,
                                 "damping": damping}, feats, 0, intr)
            ii = torch.as_tensor(ii, device=dev)
            jj = torch.as_tensor(jj, device=dev)
            w0 = int(ii.min())
            window = (max(1, w0 + 1), n, w0, int(ii.max()) - w0 + 1)
            P, D, _, _ = ref_vo.refine(
                sd, vid, (ii, jj, torch.ones_like(ii, dtype=torch.bool)),
                ref_vo.fresh_state(vid, poses, disps, ii, jj),
                _no_extras(disps), window, steps[k], (1.0, 1e-7),
                dict(iters=2, ep=1e-2, lm=1e-5), segm, op_cast)
            got = check.named("backend_pose", check.pose_gaps(
                p_after[:n], P[:n]), ("p50", "max"))
            got.update(check.named("backend_disp", check.disp_gaps(
                d_after[w0:n], D[w0:n]), ("p50", "p90", "max")))
            for key, v in got.items():
                out[key] = max(out.get(key, 0.0), v)
        ref = _filler(sd, filler, feats, intr, images.to(dev), tstamps, segm,
                      op_cast)
        out.update(check.named("traj_pose", check.pose_gaps(
            torch.as_tensor(traj, device=dev), ref_geo.se3_inv(ref)),
            ("p50", "max")))
    return out


def _no_extras(disps):
    """No earlier edges: empty (ii, jj, target, weight)."""
    dev = disps.device
    none = torch.zeros(0, dtype=torch.long, device=dev)
    z = torch.zeros((0,) + disps.shape[1:] + (2,), device=dev)
    return none, none, z, z.clone()


def _filler(sd, st, feats, intr, images, tstamps, segm, op_cast):
    """The filler's poses (T, 7, w2c) of every frame, from the state
    after the backend: per batch of ``batch`` frames (the last batch
    padded with its last frame), the interpolated start between the
    bracketing keyframes, the frames' features by the reference's
    encoder, and six motion-only updates over the edges from both
    bracketing keyframes (one where they coincide)."""
    dev = images.device
    N, B = st["counter"], min(st["batch"], st["buffer"] - st["counter"])
    ts = st["tstamp"][:N]
    out = []
    for o in range(0, len(tstamps), st["batch"]):
        tt = tstamps[o:o + st["batch"]]
        M = len(tt)
        idx = list(range(o, o + M)) + [o + M - 1] * (B - M)
        tt = tstamps[idx]
        t0 = np.array([np.sum(ts <= t) - 1 for t in tt])
        t1 = np.where(t0 < N - 1, t0 + 1, t0)
        wfac = torch.as_tensor((tt - ts[t0]) / (ts[t1] - ts[t0] + 1e-3),
                               dtype=torch.float32, device=dev)
        poses = st["poses"].clone()
        disps = st["disps"].clone()
        rows = torch.arange(N, N + B, device=dev)
        poses[rows] = ref_vo.interpolate(
            poses, torch.as_tensor(t0, device=dev),
            torch.as_tensor(t1, device=dev), wfac)
        disps[rows] = 1.0
        fmap = ref_net.encoder(ref_net.normalize(images[idx]), sd, "fnet",
                               True).permute(0, 2, 3, 1)
        pad = (lambda t, x: torch.cat([t[:N].float(), x]))
        zeros = torch.zeros_like(fmap)
        vid = ref_vo.Frames(
            {"poses": poses, "disps": disps, "damping": st["damping"]},
            {"fmaps": pad(feats["fmaps"], fmap),
             "nets": pad(feats["nets"], zeros),
             "inps": pad(feats["inps"], zeros),
             "segms": torch.cat([feats["segms"][:N], torch.zeros(
                 (B,) + feats["segms"].shape[1:], dtype=feats["segms"].dtype,
                 device=dev)])}, 0, intr)
        kk = np.arange(N, N + B)
        second = t1 != t0
        ii = torch.as_tensor(np.concatenate([t0, t1[second]]), device=dev)
        jj = torch.as_tensor(np.concatenate([kk, kk[second]]), device=dev)
        w0 = int(ii.min())
        P, _, _, _ = ref_vo.refine(
            sd, vid, (ii, jj, torch.ones_like(ii, dtype=torch.bool)),
            ref_vo.fresh_state(vid, poses, disps, ii, jj),
            _no_extras(disps), (N, N + B, w0, int(ii.max()) - w0 + 1), 6,
            (0.2, 1e-7), dict(iters=2, ep=0.1, lm=1e-4), segm, op_cast,
            motion_only=True)
        out.append(P[N:N + M])
    return torch.cat(out)


@contextlib.contextmanager
def _copies(v, check_steps):
    """Inside the block, copy the state where each backend pass starts
    and after its first ``check_steps`` steps (where the next step
    starts), and where the filler starts. Yields (passes, filler)."""
    from pvo_tpu_torch.vo.factor_graph import FactorGraph
    from pvo_tpu_torch.vo.trajectory_filler import TrajectoryFiller
    passes, filler, seen = [], {}, {}

    def stepped(core):
        def call(g, *a, **kw):
            if "n" in seen:
                seen["n"] += 1
                if seen["n"] == check_steps + 1:
                    seen["after"] = (v.poses.clone(), v.disps.clone())
            return core(g, *a, **kw)
        return call

    def saving(lowmem):
        def call(g, *a, **kw):
            before = (g.ii.copy(), g.jj.copy(), v.poses.clone(),
                      v.disps.clone(), v.damping.clone(), int(v.counter))
            seen.clear()
            seen["n"] = 0
            out = lowmem(g, *a, **kw)
            passes.append((before,) + seen.get(
                "after", (v.poses.clone(), v.disps.clone())))
            seen.clear()
            return out
        return call

    def filling(fill):
        def call(tf, stream):
            filler.update(poses=v.poses.clone(), disps=v.disps.clone(),
                          damping=v.damping.clone(), tstamp=v.tstamp.copy(),
                          counter=int(v.counter), buffer=v.buffer,
                          batch=tf.batch)
            return fill(tf, stream)
        return call

    with program.patched(FactorGraph, "update_lowmem", saving), \
            program.patched(FactorGraph, "_update_core", stepped), \
            program.patched(FactorGraph, "_update_core_chunked", stepped), \
            program.patched(TrajectoryFiller, "__call__", filling):
        yield passes, filler


@contextlib.contextmanager
def _instrumented(sysm, h, w):
    """Inside the block, synchronized host timers around the backend's
    and the filler's calls, and the algorithm's operations of each update
    call and of the filler's encoder. Yields {"backend_s", "filler_s",
    "flops"}: lists filled as the calls run."""
    from pvo_tpu_torch.vo.factor_graph import FactorGraph
    from pvo_tpu_torch.vo.trajectory_filler import TrajectoryFiller
    dev = sysm.video.device
    out = {"backend_s": [], "filler_s": [], "flops": []}

    def timed(name):
        def wrap(fn):
            def call(*a, **kw):
                program.sync(dev)
                t = time.perf_counter()
                res = fn(*a, **kw)
                program.sync(dev)
                out[name].append(time.perf_counter() - t)
                return res
            return call
        return wrap

    def counted(upd):
        def call(g, t0, t1, itrs, use_inactive, EP, motion_only, *a,
                 steps=1, steps2=0, **kw):
            res = upd(g, t0, t1, itrs, use_inactive, EP, motion_only, *a,
                      steps=steps, steps2=steps2, **kw)
            # steps2 runs where the removal probe keeps the keyframe:
            # always at a keyframe threshold of 0
            out["flops"].append(bounds.update_flops(
                g.n_edges, steps + steps2, h, w, motion_only=motion_only))
            return res
        return call

    def encoded(fill):
        def call(tf, tstamps, *a):
            out["flops"].append(len(tstamps) * bounds.encoder_flops(
                8 * h, 8 * w, 128))
            return fill(tf, tstamps, *a)
        return call

    with program.patched(sysm, "backend", timed("backend_s")), \
            program.patched(sysm, "traj_filler", timed("filler_s")), \
            program.patched(FactorGraph, "_update", counted), \
            program.patched(TrajectoryFiller, "_fill", encoded):
        yield out


@contextlib.contextmanager
def _dba_shapes(shapes):
    """Inside the block, append each DBA kernel call's (name, shapes) to
    ``shapes``, as ``bounds.dba_bound`` takes them."""
    from pvo_tpu_torch.vo.net import cuda_dba

    def linearize(lin):
        def call(poses, disps, intr, target, weight, ii, jj, valid,
                 motion_only=False):
            shapes.append(("dba_linearize", dict(
                E=int(ii.shape[0]), HW=disps[0].numel(),
                motion_only=motion_only)))
            return lin(poses, disps, intr, target, weight, ii, jj, valid,
                       motion_only)
        return call

    def schur(sch):
        def call(Ei_m, Ej, C, eta, w_m, m_c, pa, pb, pv, *a, **kw):
            shapes.append(("dba_schur", dict(
                E=int(Ej.shape[0]), K=int(Ei_m.shape[0]),
                HW=int(C.shape[1]), NP=int(pa.shape[0]))))
            return sch(Ei_m, Ej, C, eta, w_m, m_c, pa, pb, pv, *a, **kw)
        return call

    def solve(sol):
        def call(H, S_sum, v, corr_v, P, *a, **kw):
            shapes.append(("dba_solve", dict(P=int(P),
                                             motion_only=S_sum is None)))
            return sol(H, S_sum, v, corr_v, P, *a, **kw)
        return call

    def backsub(bak):
        def call(poses, dx, frame_row, disps, Ej=None, *a, **kw):
            shapes.append(("dba_backsub", dict(
                F=int(poses.shape[0]), P=int(dx.shape[0]),
                E=0 if Ej is None else int(Ej.shape[0]),
                K=int(a[2].shape[0]) if Ej is not None else 0,
                HW=disps[0].numel(), motion_only=Ej is None)))
            return bak(poses, dx, frame_row, disps, Ej, *a, **kw)
        return call

    with program.patched(cuda_dba, "linearize", linearize), \
            program.patched(cuda_dba, "schur", schur), \
            program.patched(cuda_dba, "solve", solve), \
            program.patched(cuda_dba, "backsub", backsub):
        yield
