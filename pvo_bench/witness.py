"""Measurements behind the benchmark's choices, kept so that they can be
made again; the benchmark's own runs never run them.

    python3 -m pvo_bench.witness conditioning --workload <cell> --seed <n>
        --frames 45 700 [--perturb 1e-7]
    python3 -m pvo_bench.witness thresholds --workload <cell> --seed <n>
        [--frames 60]
    python3 -m pvo_bench.witness window --workload <cell> --seed <n>
        --seconds <s> [--mask-bias <b>] [--out <file>]

``conditioning``: the tracking check's frames against the state they
start from. At each listed frame the program's state is copied before
and after the frame, and the reference recomputes the frame twice: from
the program's state, and from it with ``--perturb`` added to every
pose's translation. Where the reference moves more under the
perturbation than the program departs from it, the state is
ill-conditioned and a gap there says nothing of the program.

``thresholds``: the cell's system at the source's motion-filter and
keyframe thresholds (the configuration's ``source_values``): the
motion filter's mean flow of each frame and the keyframes taken.

``window``: one run of the cell's runner (the configuration's mask bias
replaced by ``--mask-bias`` if given); prints the frames per second and
writes each frame's completion time (ms from the window's start) and the
window's start on the host's epoch clock to ``--out``.

One JSON line per measurement on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cell(name):
    from pvo_bench import harness
    bench = harness.load_json(harness.REPO / "BENCHMARK.json")
    return harness.cell_files(bench, name)


def conditioning(args):
    from pvo_bench import check, program
    from pvo_bench.kinds import track
    from pvo_bench.stream import Stream
    _, cfg, _, _, _, _ = _cell(args.workload)
    H, W = cfg["image_size"]
    dev = program.open_card(argparse.Namespace(data={}))
    sd = program.weights(cfg, dev)
    top = max(args.frames) + 8
    buffer = max(cfg["buffer"], 1 << (top + 64).bit_length())
    sysm = program.build(cfg, sd, dev, buffer=buffer)
    stream = Stream(args.seed, H, W)
    saved = []
    for t in range(top):
        frame = stream.frame(t)
        if t in args.frames:
            saved.append((t,) + track.copied(sysm, frame, dev, buffer))
        else:
            track._track(sysm, frame)
    vo = dict(segm=(cfg["vo"]["max_segments"], cfg["vo"]["thresh"]),
              iters1=sysm.cfg.frontend_iters1,
              iters2=sysm.cfg.frontend_iters2)
    del sysm
    program.free()
    for t, before, after, image in saved:
        before = program.to_device(before, dev)
        after = program.to_device(after, dev)
        ref = track.reference_frame(sd, before, after, image, vo, dev)
        moved = track.reference_frame(sd, before, after, image, vo, dev,
                                      perturb=args.perturb)
        program_gap = track.gaps(after, ref)
        own = {}
        if "target" in ref:
            own.update(check.named("flow", check.flow_gaps(
                moved["target"], ref["target"]), ("p50", "p90", "max")))
            own.update(check.named("reproj", check.flow_gaps(
                moved["reproj"], ref["reproj"]), ("p50", "p90", "max")))
            own.update(check.named("raw", check.abs_gaps(
                moved["raw"], ref["raw"]), ("p50", "p90")))
            own.update(check.named("weight", check.abs_gaps(
                moved["weight"], ref["weight"]), ("p50", "p90")))
        disp = after["disps"][:int(after["scal"][0])].float()
        print(json.dumps({
            "frame": t, "seed": args.seed, "perturb": args.perturb,
            "mean_disparity": float(disp.flatten(1).mean(1).abs().max()),
            "translation": float(after["poses"][:, :3].abs().max()),
            "program_gap": program_gap, "reference_moved": own}),
            flush=True)
        del before, after, ref, moved
    return 0


def thresholds(args):
    from pvo_bench import program
    from pvo_bench.kinds import track
    from pvo_bench.stream import Stream
    from pvo_tpu_torch.vo import motion_filter
    _, cfg, _, _, _, _ = _cell(args.workload)
    cfg = dict(cfg, vo=dict(cfg["vo"], **{
        k: v for k, v in cfg["source_values"].items() if k in cfg["vo"]}))
    H, W = cfg["image_size"]
    dev = program.open_card(argparse.Namespace(data={}))
    sd = program.weights(cfg, dev)
    sysm = program.build(cfg, sd, dev)
    stream = Stream(args.seed, H, W)
    flows = []
    probe = motion_filter._probe

    def kept(*a, **kw):
        out = probe(*a, **kw)
        flows.append(float(out))
        return out

    motion_filter._probe = kept
    try:
        for t in range(args.frames):
            track._track(sysm, stream.frame(t))
        program.sync(dev)
    finally:
        motion_filter._probe = probe
    print(json.dumps({
        "seed": args.seed, "frames": args.frames,
        "settings": {k: cfg["vo"][k] for k in cfg["source_values"]
                     if k in cfg["vo"]},
        "keyframes": int(sysm.video.counter),
        "planner_engaged": bool(sysm.planner.engaged),
        "mean_flow_px": {"min": min(flows), "max": max(flows),
                         "median": sorted(flows)[len(flows) // 2]}
        if flows else None}), flush=True)
    return 0


def window(args):
    from pvo_bench import harness
    from pvo_bench.kinds import track
    cell, cfg, traffic, limits, _, _ = _cell(args.workload)
    if args.mask_bias is not None:
        cfg = dict(cfg, weights=dict(cfg["weights"],
                                     mask_bias=args.mask_bias))
    a = argparse.Namespace(seed=args.seed, seconds=args.seconds, trace=0)
    run = harness.Run(a, time.perf_counter(), cell, cfg, traffic, limits)
    epoch = time.time()
    track.run(run)
    d = run.data
    out = {"workload": args.workload, "seed": args.seed,
           "mask_bias": cfg["weights"]["mask_bias"], "frames": d["frames"],
           "fps": d["frames"] / d["window_s"],
           "host_ms_per_frame": 1e3 * d["host_s_in_track"] / d["frames"],
           "setup_s": run.setup_s, "readings": run.readings,
           "correct": run.correct()}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(out, done_ms=d["done_ms"],
                           window_epoch=d["window_epoch"],
                           process_epoch=epoch), f)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=("conditioning", "thresholds", "window"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--frames", type=int, nargs="+", default=[60])
    p.add_argument("--perturb", type=float, default=1e-7)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--mask-bias", type=float, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.what == "thresholds":
        args.frames = args.frames[0]
    return {"conditioning": conditioning, "thresholds": thresholds,
            "window": window}[args.what](args)


if __name__ == "__main__":
    sys.exit(main())
