"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device   - requires CUDA; prints the card's name and power limit;
  2. build    - compiles pvo_tpu_torch/csrc/corr.cu and corr_exp.cu
                (nvcc, sm_90a), both at once;
  3. kernels  - each CUDA kernel against its plain PyTorch version on the
                same inputs: 30x101, C=128, E in {1, 24, 48} (K3 also
                wide 47x156, tall 128x40 and the backend's E=256 chunk);
                K3 <= 1e-4, K1 and K2 <= 2e-2 (bf16 volume). K1 and K3
                on bf16 features use the bf16-rounded pyramid. P1 (X1)
                and P2 (X2-X5) in every variant at their harness shapes
                and in border-straddling bands, |d| <= 2e-2 + 8e-3 |ref|
                (bf16 outputs) with >= 99.9% of outputs bit-equal, and
                every two variants' outputs differing in >= 1%;
  4. reference- the port's loop with the kernels against the same loop
                with their plain versions, on the card: 64x96, 8 frames
                + terminate(image_stream), same weights, all 8 poses
                within 1e-3;
  5. main     - VOSystem at 240x808 (the bench.py configuration, weights
                of tame_net(0)), 40 frames tracked, then
                terminate(image_stream, backend_steps=(7, 12)), with
                every kernel launch counted; fps and ms/frame over the
                steady state after initialization (t=13..39);
                terminate_s (last update + backend) apart from filler_s;
  6. harness  - the corr experiment harnesses
                (python -m pvo_tpu_torch.scripts.corr_exp*), each
                program once (corr_exp5 runs corr_exp4's) with its
                kernel's launches counted: P1's and P2's times beside
                their plain versions.
Then one JSON line of kernel results, the card's name and power limit,
and the contract line {"ok": true, "device": {...}}.
"""

import contextlib
import importlib
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pvo_tpu_torch.scripts.kbench import device_time_ms, gpu_line
from pvo_tpu_torch.vo.net import cuda_corr
from pvo_tpu_torch.vo.net import cuda_corr_exp
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.vo.system import VOConfig, VOSystem

C = 128
TOL = {"build_volumes": 2e-2, "corr_extract": 2e-2, "corr_lookup": 1e-4}
# packed bf16 outputs: |d| <= 2e-2 + 8e-3 |ref|, one bf16 ulp above K1/K2,
# and at least PACKED_EQUAL of them bit-equal: the tolerance alone
# cannot tell one rounding variant from another, which differ by one
# bf16 ulp in PACKED_DISTINCT or more of the outputs (17-30% at 30x101)
PACKED_TOL = (2e-2, 8e-3)
PACKED_EQUAL = 0.999
PACKED_DISTINCT = 0.01
REPLACES = {
    "build_volumes": "pvo_tpu/vo/net/pallas_corr.py:412",
    "corr_extract": "pvo_tpu/vo/net/pallas_corr.py:544",
    "corr_lookup": "pvo_tpu/vo/net/pallas_corr.py:611",
}
# the main path's shape for each kernel's headline time: the frontend's
# steady state (48 edges) for K1/K2, the motion-filter probe for K3
HEADLINE = {"build_volumes": (48, 30, 101), "corr_extract": (48, 30, 101),
            "corr_lookup": (1, 30, 101)}
# the corr experiment harnesses: TPU kernel -> (harness module, kernel,
# pallas_call site); the JSON line reports each harness's first case
HARNESS = {
    "X1": ("corr_exp", "corr_lookup_packed", "scripts/corr_exp.py:172"),
    "X2": ("corr_exp2", "corr_extract_packed", "scripts/corr_exp2.py:116"),
    "X3": ("corr_exp3", "corr_extract_packed", "scripts/corr_exp3.py:118"),
    "X4": ("corr_exp4", "corr_extract_packed", "scripts/corr_exp4.py:112"),
    "X5": ("corr_exp5", "corr_extract_packed", "scripts/corr_exp5.py:125"),
}
# P2's output-defining variants (X2's rounding, X3's modes) and the X
# kernels each one stands for
P2_VARIANTS = (
    (dict(), ("X2", "X3", "X4", "X5")),
    (dict(weights="bf16"), ("X2",)),
    (dict(weights="round", round_mid=True), ("X2",)),
    (dict(weights="bf16", round_mid=True), ("X2",)),
    (dict(mode="nostore"), ("X3",)),
    (dict(mode="novab"), ("X3",)),
    (dict(mode="dma"), ("X3",)),
)


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def kernel_inputs(E, H, W, dtype, seed, band=None):
    """Seeded features and coords; ``band`` = (axis, lo, hi) sends half
    the pixels' coords into a band straddling a border."""
    rng = np.random.RandomState(seed)
    f1 = torch.tensor(rng.randn(E, H, W, C), dtype=torch.float32)
    f2 = torch.tensor(rng.randn(E, H, W, C), dtype=torch.float32)
    cx = rng.uniform(-2.0, W + 1.0, (E, H, W))
    cy = rng.uniform(-2.0, H + 1.0, (E, H, W))
    if band is not None:
        axis, lo, hi = band
        c = cx if axis == "x" else cy
        c[:, H // 2:] = rng.uniform(lo, hi, c[:, H // 2:].shape)
    coords = torch.tensor(np.stack([cx, cy], -1), dtype=torch.float32)
    dev = torch.device("cuda")
    return f1.to(dev, dtype), f2.to(dev, dtype), coords.to(dev)


def check_kernels():
    """Phase 3, K1-K3: returns {kernel: {"err": worst error, "ms",
    "plain_ms"}}."""
    res = {k: {"err": 0.0} for k in cuda_corr.KERNELS}

    def record(name, shape, err, fn, plain_fn, plain_reps=10):
        ms = device_time_ms(fn)
        plain_ms = device_time_ms(plain_fn, reps=plain_reps)
        log("kernel", name=name, shape="x".join(map(str, shape)),
            max_abs_err=f"{err:.3g}", tol=TOL[name], ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}")
        if not err <= TOL[name]:
            raise AssertionError(f"{name} at {shape}: error {err} > "
                                 f"{TOL[name]}")
        r = res[name]
        r["err"] = max(r["err"], err)
        if shape == HEADLINE[name]:
            r["ms"], r["plain_ms"] = ms, plain_ms

    # bf16 features pool to a bf16-rounded pyramid, level by level
    f1, f2, _ = kernel_inputs(2, 30, 101, torch.bfloat16, seed=0)
    pyr = cuda_corr.pool_pyramid(f2)
    if not torch.equal(pyr, pyr.bfloat16().float()):
        raise AssertionError("bf16 pyramid levels are not bf16 values")
    log("kernel", name="pool_pyramid", shape="2x30x101",
        bf16_levels_rounded=True)

    for E in (1, 24, 48):
        shape = (E, 30, 101)
        f1, f2, coords = kernel_inputs(*shape, torch.bfloat16, seed=E)
        vol = cuda_corr.build_volumes(f1, f2)
        ref = cuda_corr.build_volumes_plain(f1, f2)
        record("build_volumes", shape,
               (vol.float() - ref.float()).abs().max().item(),
               lambda: cuda_corr.build_volumes(f1, f2),
               lambda: cuda_corr.build_volumes_plain(f1, f2))
        out = cuda_corr.corr_extract(ref, coords)
        err = (out - cuda_corr.corr_extract_plain(ref, coords)).abs().max()
        record("corr_extract", shape, err.item(),
               lambda: cuda_corr.corr_extract(ref, coords),
               lambda: cuda_corr.corr_extract_plain(ref, coords))
        del vol, ref, out
        torch.cuda.empty_cache()

    for shape, band, dtype in (
            ((1, 30, 101), None, torch.float32),
            ((24, 30, 101), None, torch.bfloat16),
            ((48, 30, 101), None, torch.bfloat16),
            ((256, 30, 101), None, torch.bfloat16),
            ((1, 47, 156), ("x", 150.0, 160.0), torch.float32),
            ((1, 128, 40), ("y", 122.0, 131.0), torch.float32)):
        f1, f2, coords = kernel_inputs(*shape, dtype, seed=sum(shape),
                                       band=band)
        out = cuda_corr.corr_lookup(f1, f2, coords)
        err = (out - cuda_corr.corr_lookup_plain(f1, f2, coords)).abs().max()
        record("corr_lookup", shape, err.item(),
               lambda: cuda_corr.corr_lookup(f1, f2, coords),
               lambda: cuda_corr.corr_lookup_plain(f1, f2, coords),
               plain_reps=3)
        del out
        torch.cuda.empty_cache()
    return res


def packed_err(name, shape, variant, out, ref):
    """Max |out - ref| of two packed bf16 outputs; raises beyond
    PACKED_TOL or below PACKED_EQUAL bit-equal."""
    a, b = out.float(), ref.float()
    d = (a - b).abs()
    bad = int((d > PACKED_TOL[0] + PACKED_TOL[1] * b.abs()).sum())
    equal = (a == b).float().mean().item()
    err = d.max().item()
    log("kernel", name=name, shape="x".join(map(str, shape)),
        variant=repr(variant), max_abs_err=f"{err:.3g}", bad=bad,
        bit_equal=f"{equal:.6f}")
    if bad or equal < PACKED_EQUAL or not np.isfinite(err):
        raise AssertionError(f"{name} {variant} at {shape}: {bad} outputs "
                             f"beyond tolerance, {equal:.6f} bit-equal, "
                             f"max error {err}")
    return err


def check_distinct(name, shape, variants, outs):
    """Every two variants' kernel outputs differ in at least
    PACKED_DISTINCT of the outputs, so that no variant flag is dead."""
    low = min(((outs[i] != outs[j]).float().mean().item(), i, j)
              for i in range(len(outs)) for j in range(i))
    log("kernel", name=name, shape="x".join(map(str, shape)),
        variants=len(outs), min_share_differing=f"{low[0]:.4f}")
    if low[0] < PACKED_DISTINCT:
        raise AssertionError(f"{name} at {shape}: {variants[low[1]]} and "
                             f"{variants[low[2]]} differ in only "
                             f"{low[0]:.4f} of the outputs")


def check_packed():
    """Phase 3, P1 and P2 in every output-defining variant against their
    plain versions, at the harness shapes and with half the pixels in a
    band over the right or the bottom border. Returns the worst error of
    each X kernel."""
    err = dict.fromkeys(HARNESS, 0.0)
    shapes = [((64, 30, 101), None), ((2, 30, 101), ("x", 95.0, 106.0)),
              ((2, 30, 101), ("y", 25.0, 33.0))]
    p1_variants = [dict(order=o, seldt=s) for o in cuda_corr_exp.ORDERS
                   for s in cuda_corr_exp.SELDT]
    for shape, band in shapes:
        f1, f2, coords = kernel_inputs(*shape, torch.bfloat16, seed=7,
                                       band=band)
        outs = []
        for kw in p1_variants:
            outs.append(cuda_corr_exp.corr_lookup_packed(f1, f2, coords,
                                                         **kw))
            e = packed_err(
                "corr_lookup_packed", shape, kw, outs[-1],
                cuda_corr_exp.corr_lookup_packed_plain(f1, f2, coords, **kw))
            err["X1"] = max(err["X1"], e)
        check_distinct("corr_lookup_packed", shape, p1_variants, outs)
        del f1, f2, coords, outs
        torch.cuda.empty_cache()

    shapes[0] = ((32, 30, 101), None)
    for shape, band in shapes:
        f1, f2, coords = kernel_inputs(*shape, torch.bfloat16, seed=8,
                                       band=band)
        vol = cuda_corr.build_volumes(f1, f2)
        outs = []
        for kw, owners in P2_VARIANTS:
            outs.append(cuda_corr_exp.corr_extract_packed(vol, coords, **kw))
            e = packed_err(
                "corr_extract_packed", shape, kw, outs[-1],
                cuda_corr_exp.corr_extract_packed_plain(vol, coords, **kw))
            for x in owners:
                err[x] = max(err[x], e)
        check_distinct("corr_extract_packed", shape,
                       [kw for kw, _ in P2_VARIANTS], outs)
        del f1, f2, coords, vol, outs
        torch.cuda.empty_cache()
    return err


def synth_stream(n, H, W, seed=0):
    """bench.py's stream: a moving random texture and a panoptic map of
    ~90 distinct ids per frame (4x4 cells at 1/8 res) moving with it."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (H + 64, W + 64, 3), np.uint8)
    h, w = H // 8, W // 8
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    intr = np.array([725.0087 * W / 1242, 725.0087 * W / 1242,
                     W / 2.0, H / 2.0], np.float32)
    for t in range(n):
        dy, dx = (2 * t) % 64, (3 * t) % 64
        segm = ((((yy + t) // 4) * (w // 4 + 1) + (xx + 2 * t) // 4)
                % 90 + 1).astype(np.int32) * 10000 + 3
        yield t, base[dy:dy + H, dx:dx + W], intr, segm


def tame_net(seed=0, scale=0.01):
    """Random weights (seed) with the flow/mask heads' last convs scaled
    by ``scale``. With unscaled random weights the tracker is chaotic: a
    1e-6 change grows to O(1) in three updates, and at 240x808 the
    disparities reach 1e10 and the bf16 update overflows to NaN by frame
    18, with only 16-24 edges left after initialization. Scaled, the
    run is stable and holds the reference's 48-edge steady state. The
    work per update is the same."""
    net = DroidNet.from_seed(seed)
    with torch.no_grad():
        for head in ("delta", "delta_dy", "delta_mask"):
            getattr(net.update, head)[2].weight.mul_(scale)
            getattr(net.update, head)[2].bias.mul_(scale)
    return net


@contextlib.contextmanager
def plain_kernels():
    """Swap each kernel wrapper for its plain PyTorch version."""
    saved = {k: getattr(cuda_corr, k) for k in cuda_corr.KERNELS}
    for k in cuda_corr.KERNELS:
        setattr(cuda_corr, k, getattr(cuda_corr, k + "_plain"))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(cuda_corr, k, fn)


def check_reference():
    """Phase 4: the port's loop on the card with the kernels against the
    same loop with each kernel's plain version (the same bf16 volume),
    64x96, 8 frames + terminate(image_stream), f32 compute (bf16 compute
    amplifies rounding through the dynamic-mask vote). The poses of all
    8 frames, from the trajectory filler, must agree within 1e-3 abs."""
    cfg = VOConfig(image_size=(64, 96), warmup=5, filter_thresh=-1.0,
                   keyframe_thresh=0.0, segm_filter=True, max_edges=48,
                   frontend_window=8, dtype_features="float32")

    frames = list(synth_stream(8, 64, 96))

    def run():
        s = VOSystem(cfg, net=tame_net(), device="cuda",
                     net_dtype=torch.float32)
        for t, img, intr, segm in frames:
            s.track(t, img, intr, segments=segm)
        return (s.terminate(iter(frames), backend_steps=(2,)),
                s.video.disps[:s.video.counter].cpu().numpy())

    traj, disps = run()
    with plain_kernels():
        traj_ref, disps_ref = run()
    pose_err = float(np.abs(traj - traj_ref).max())
    rel = np.abs(disps - disps_ref) / np.abs(disps_ref)
    log("reference", frames=8, pose_max_abs_err=f"{pose_err:.3g}",
        disp_median_rel_err=f"{np.median(rel):.3g}",
        disp_max_rel_err=f"{rel.max():.3g}")
    if not (traj.shape == traj_ref.shape == (8, 7) and pose_err <= 1e-3
            and np.isfinite(disps).all()):
        raise AssertionError("kernel loop disagrees with the plain loop")


def run_main_path():
    """Phase 5: returns the kernel launch counts of the run."""
    H, W, n_frames = 240, 808, 40
    cfg = VOConfig(image_size=(H, W), buffer=128, filter_thresh=0.01,
                   keyframe_thresh=0.0, warmup=12, segm_filter=True)
    frames = list(synth_stream(n_frames, H, W))
    sysm = VOSystem(cfg, net=tame_net(0), device="cuda")
    filler, filler_s = sysm.traj_filler, []

    def timed_filler(stream):
        f0 = time.perf_counter()
        poses = filler(stream)
        torch.cuda.synchronize()
        filler_s.append(time.perf_counter() - f0)
        return poses

    sysm.traj_filler = timed_filler
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_corr.reset_launches()

    times = []
    for t, img, intr, segm in frames:
        f0 = time.perf_counter()
        sysm.track(t, img, intr, segments=segm)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - f0)
    t0 = time.perf_counter()
    traj = sysm.terminate(iter(frames), backend_steps=(7, 12))
    torch.cuda.synchronize()
    # terminate_s: the last frontend update and the backend, as measured
    # before terminate filled every frame; filler_s: the filler
    term_s = time.perf_counter() - t0 - filler_s[0]
    launches = dict(cuda_corr.LAUNCHES)

    # the frontend initializes at t=12 (warmup 12, admission committed
    # one frame late); steady state is t=13..39
    meas = times[13:]
    log("main", image=f"{H}x{W}", frames=n_frames,
        keyframes=sysm.video.counter,
        fps=f"{len(meas) / sum(meas):.3f}",
        ms_per_frame=f"{1e3 * sum(meas) / len(meas):.2f}",
        init_frame_s=f"{times[12]:.3f}", terminate_s=f"{term_s:.3f}",
        filler_s=f"{filler_s[0]:.3f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        **{f"launches_{k}": v for k, v in launches.items()})
    if traj.shape != (n_frames, 7) or not np.isfinite(traj).all():
        raise AssertionError(f"bad trajectory {traj.shape}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return launches


def run_harnesses():
    """Phase 6: each corr experiment harness's main() at its default
    shapes, with its kernel's launches counted from 0; a harness that
    runs another's program (corr_exp5 runs corr_exp4's) takes that
    run's results. Returns {X: (launches, ms and plain_ms of the
    harness's first case, worst max |d|)}."""
    res, ran = {}, {}
    for x, (mod, kernel, _) in HARNESS.items():
        main = importlib.import_module(f"pvo_tpu_torch.scripts.{mod}").main
        if main in ran:
            res[x] = res[ran[main]]
            log("harness", kernel=x, module=mod, same_program_as=ran[main])
            continue
        ran[main] = x
        cuda_corr_exp.reset_launches()
        cases = main([])
        n = cuda_corr_exp.LAUNCHES[kernel]
        ms, plain_ms, _ = next(iter(cases.values()))
        err = max(e for _, _, e in cases.values())
        log("harness", kernel=x, module=mod, launches=n,
            first_case=repr(next(iter(cases))), ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", max_abs_err=f"{err:.3g}")
        if n == 0 or not np.isfinite(err):
            raise AssertionError(f"{x}: {n} launches, error {err}")
        res[x] = (n, ms, plain_ms, err)
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log("device", gpu=repr(card), torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    sources = (cuda_corr.SOURCE, cuda_corr_exp.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(cuda_corr.build, sources))
    log("build", sources=",".join(src.name for src in sources),
        seconds=f"{time.perf_counter() - t0:.2f}")

    res = check_kernels()
    packed = check_packed()
    check_reference()
    launches = run_main_path()
    harness = run_harnesses()

    kernels = [{
        "name": k, "route": "cuda", "source": "pvo_tpu_torch/csrc/corr.cu",
        "replaces": REPLACES[k], "launches": launches[k],
        "max_abs_err": res[k]["err"], "ms": res[k]["ms"],
        "plain_ms": res[k]["plain_ms"]} for k in cuda_corr.KERNELS]
    for x, (_, kernel, site) in HARNESS.items():
        n, ms, plain_ms, err = harness[x]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": "pvo_tpu_torch/csrc/corr_exp.cu", "replaces": site,
            "launches": n, "max_abs_err": max(err, packed[x]), "ms": ms,
            "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
