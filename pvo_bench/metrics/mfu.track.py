"""The algorithm's operations of the window's frames (both encoders, the
motion filter's probe, and each update's real edges and steps at the
published widths: ``bounds.track_frame_flops``) over the window's
seconds, as a share of the card's 989 TFLOP/s bf16 dense peak."""

from pvo_bench import bounds, program


def read(run):
    if "window_frames" not in run.data:
        return None
    H, W = run.data["image_size"]
    i1, i2 = run.data["iters"]
    lo, hi = run.data["window_frames"]
    flops = 0
    for ts in range(lo, hi):
        rec = run.data["records"].get(ts)
        if rec is None:
            return None
        flops += bounds.track_frame_flops(
            H, W, rec[program.R_N], i1 + i2 * rec[program.R_STEPS2],
            rec[program.R_RAN])
    return 100.0 * flops / run.data["window_s"] / bounds.PEAK_FLOP_S["bf16"]
