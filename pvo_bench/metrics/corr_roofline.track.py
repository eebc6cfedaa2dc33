"""The correlation kernels' share of their roofline over the traced
frames: the frozen bounds (``bounds.corr_bound``) of every K1
(``build_volumes``), K2 (``corr_extract``) and K3 (``corr_lookup``: bf16
steps and the f32 probe) launch, at the shapes the frame graph launches
them, over their profiled time. The profile's whole frames (probe to
probe) must hold the frame graph's own launch counts (``per_replay``)
times their number, and the traced frames must all have run the same
sections; otherwise the profile named the kernels wrongly or the frames
differ, and nothing is read."""

from pvo_bench import bounds, program
from pvo_bench.harness import log

NAMES = {"build_volumes": ("build_volumes_tc_kernel",),
         "corr_extract": ("corr_extract_kernel",),
         "corr_lookup": ("corr_lookup_tc_kernel", "corr_lookup_f32_kernel")}
EB = {True: 24, False: 48}   # the planner's edge widths: compact, full


def read(run):
    p = run.profile
    frames = run.data.get("traced_frames")
    if p is None or not frames:
        return None
    recs = [run.data["records"].get(ts) for ts in frames]
    pers = [run.data["per_replay"].get(ts) for ts in frames]
    if any(r is None for r in recs) or any(q != pers[0] for q in pers) or \
            len({r[program.R_SMALL] for r in recs}) != 1:
        log("corr_roofline.track: the traced frames differ or lack records")
        return None
    H, W = run.data["image_size"]
    h, w = H // 8, W // 8
    E = EB[bool(recs[0][program.R_SMALL])]
    per = pers[0]
    # one f32 probe a frame; the other K3 launches are bf16 steps
    n3 = per.get("corr_lookup", 0)
    frame_ms = (
        per.get("build_volumes", 0) *
        bounds.corr_bound("build_volumes", E, h, w)["ms"] +
        per.get("corr_extract", 0) *
        bounds.corr_bound("corr_extract", E, h, w)["ms"] +
        (bounds.corr_bound("corr_lookup", 1, h, w, "f32")["ms"] +
         (n3 - 1) * bounds.corr_bound("corr_lookup", E, h, w)["ms"]
         if n3 else 0.0))
    expect = {k: per.get(k, 0) * p.units for k in NAMES}
    got = {k: len(p.kernels(*v)) for k, v in NAMES.items()}
    if got != expect:
        log(f"corr_roofline.track: profiled launches {got} differ from the "
            f"frame graph's {expect}")
        return None
    ms = sum(t for v in NAMES.values() for _, t in p.kernels(*v))
    return 100.0 * frame_ms * p.units / ms if ms > 0 else None
