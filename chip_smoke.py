"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            the whole run
    python3 chip_smoke.py main       only the named phases (kernels,
                                     packed, reference, main, harness,
                                     export), without the result lines

Phases, one line each (any failure exits non-zero):
  1. device   - requires CUDA; prints the card's name and power limit;
  2. build    - compiles pvo_tpu_torch/csrc/corr.cu and corr_exp.cu
                (nvcc, sm_90a), both at once;
  3. kernels  - each CUDA kernel against its plain PyTorch version on the
                same inputs, C=128. K1 and K2 at 30x101, E in {1, 24, 48}:
                <= 2e-2 (bf16 volume); K1 (the bf16 kernel, also at a
                ragged E=3 17x45, and the f32 kernel's three TF32 passes
                at E=2 30x101 and E=3 17x45) must also give >= 99.9% of
                entries bit-equal, every entry within one bf16 ulp and
                pad columns exactly 0; K2 must also reproduce, bit for
                bit, the output of the kernel it replaced on a saved
                case. K3 <= 1e-4 at 30x101 with E in {1, 48, 256}, wide
                47x156 and tall 128x40, for bf16 features (bf16
                products) and f32 ones (three TF32 passes), through both
                entries (gathered features, and frames + pyramid + edge
                indices in the kernel), on smooth, scattered, mixed,
                NaN/huge and border-band coordinates; the mixed case
                must take both routes of either kernel and the smooth
                one only the tensor cores; the indexed entry on f32
                features must launch once and allocate only its output;
                the f32 kernel also at C=24 (f32 and bf16 features), 1
                to 4 levels, and where the last level is pooled away to
                nothing. For K1-K3 the time stands beside its bound
                (kbench.kernel_bound) and, for K1, beside torch.bmm on
                the same operands (a yardstick the port never calls).
                P1 (X1) and P2 (X2-X5)
                in every variant at their harness shapes and in
                border-straddling bands, |d| <= 2e-2 + 8e-3 |ref| (bf16
                outputs) with >= 99.9% of outputs bit-equal (P2: all of
                them, and the sha256 of the kernel it replaced on a
                saved case), and every two variants' outputs differing
                in >= 1%; P1 (bf16 wgmma products) also on smooth
                coordinates at 64x30x101 and 2x47x156, on mixed and
                NaN/huge ones, at a ragged 3x17x45 and where the last
                level is pooled away to nothing, its (block, level)
                pairs within and above the bounding-box cap equal to
                the numpy model's (smooth: none above);
  4. reference- the port's loop with the kernels against the same loop
                with their plain versions, on the card: 64x96, 8 frames
                + terminate(image_stream), same weights (mask logits
                biased away from the threshold), all 8 poses within
                1e-3;
  5. main     - VOSystem at 240x808 (the bench.py configuration, weights
                of tame_net(0)), 40 frames tracked, then
                terminate(image_stream, backend_steps=(7, 12)), with
                every kernel launch counted, and whether the frontend
                caches K1's volume (narrow stream); fps and ms/frame
                over the steady state after initialization (t=13..39);
                terminate_s (last update + backend) apart from filler_s;
                the backend's wall time apart from the rest of
                terminate_s, K3's time inside it (wrapper and kernel
                alone, CUDA events) and the share of K3's (block, level)
                pairs that ran on the tensor cores; at the end,
                get_depth() and get_flow() give finite (counter, 240,
                808) and (counter, 240, 808, 2) arrays;
  6. harness  - the corr experiment harnesses
                (python -m pvo_tpu_torch.scripts.corr_exp*), each
                program once (corr_exp5 runs corr_exp4's) with its
                kernel's launches counted: P1's and P2's times beside
                their plain versions; P1 through the wrapper and as the
                kernel alone on the harness's uniform coordinates and on
                smooth ones, with bound, share and route counts;
  7. export   - the flow/depth export (scripts.test_vo2.export_pair on
                DroidNet.forward, f32, weights of tame_net(0,
                mask_bias=-2)). K1-K3 at the export's shapes (E=2, f32
                features) against plain, with time and bound. The
                forward with the kernels against the
                same forward with their plain versions, 2 frames, 3
                iterations, at 64x96 (narrow: K1 once, K2 per step) and
                64x1000 (wide: K3 per step): 1/8-res flows and upsampled
                disparities within EXPORT_TOL. Then the path at full
                width, 376x1248 (47x156 features), 15 iterations: one
                warm-up pair, the launch counts set to 0, 5 timed pairs
                (synchronized, readbacks included), the counts read:
                vo2_export_s_per_pair, peak memory, launches of K1/K2/K3
                per pair (must be 0/0/15), K3's time per step (wrapper
                and kernel alone, CUDA events), and one pair under
                torch.profiler (device ms, kernels and aten ops per
                pair). Then the narrow route, 240x808: 1/15/0.
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

from pvo_tpu_torch.scripts import bench_vo2_export, kbench
from pvo_tpu_torch.scripts.harness import harness_inputs
from pvo_tpu_torch.scripts.kbench import (device_time_ms, gpu_line,
                                          kernel_bound)
from pvo_tpu_torch.scripts.test_vo2 import export_pair
from pvo_tpu_torch.utils.config import VOConfig
from pvo_tpu_torch.vo.factor_graph import FactorGraph
from pvo_tpu_torch.vo.net import cuda_corr
from pvo_tpu_torch.vo.net import cuda_corr_exp
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.vo.system import VOSystem

C = 128
TOL = {"build_volumes": 2e-2, "corr_extract": 2e-2, "corr_lookup": 1e-4}
# K1 forms the plain version's products in another f32 summation order
K1_EQUAL = 0.999
# the forward with the kernels against the forward with their plain
# versions, max |d| of the 1/8-res flow (pixels) and of the upsampled
# disparity after 3 iterations. On the wide route K3 differs from plain
# by f32 summation order (1e-4 on the correlation); on the narrow route
# both sides read a bf16 volume and K1 differs from plain by one bf16 ulp
# in under 0.01% of its entries
EXPORT_TOL = 1e-3
EXPORT_SIZE, EXPORT_NARROW, EXPORT_ITERS, EXPORT_PAIRS = \
    (376, 1248), (240, 808), 15, 5
EXPORT_NARROW_PAIRS = 3
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
# steady state (48 edges) for K1/K2, the backend's chunk for K3 (bf16
# features, smooth coordinates, the indexed entry)
HEADLINE = {"build_volumes": (48, 30, 101), "corr_extract": (48, 30, 101),
            "corr_lookup": (256, 30, 101),
            # the f32 kernels: the export's narrow route and its step
            "build_volumes_f32": (2, 30, 101), "corr_lookup_f32": (2, 47, 156)}
# the result rows of K1's and K3's f32 kernels (three TF32 passes)
F32_ROWS = {"build_volumes": "build_volumes_f32",
            "corr_lookup": "corr_lookup_f32"}
# K3's checks: (E, H, W) and the coordinates of kbench.lookup_coords
K3_SHAPES = ((1, 30, 101), (48, 30, 101), (256, 30, 101), (2, 47, 156),
             (2, 128, 40))
# the harness shapes of P1 (X1) and P2 (X2-X5), for their bounds
HARNESS_E = {"corr_lookup_packed": 64, "corr_extract_packed": 32}
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


def kernel_inputs(E, H, W, dtype, seed, band=None, width=C):
    """Seeded features and coords; ``band`` = (axis, lo, hi) sends half
    the pixels' coords into a band straddling a border."""
    rng = np.random.RandomState(seed)
    f1 = torch.tensor(rng.randn(E, H, W, width), dtype=torch.float32)
    f2 = torch.tensor(rng.randn(E, H, W, width), dtype=torch.float32)
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
    """Phase 3, K1-K3: returns {row: {"err": worst error, "ms",
    "plain_ms", "bound_ms", "bound_by", "library_ms"}}, the times at the
    row's HEADLINE shape; a row is a kernel, or its f32 kernel
    (F32_ROWS)."""
    res = {k: {"err": 0.0, "library_ms": None}
           for k in (*cuda_corr.KERNELS, *F32_ROWS.values())}

    def record(name, shape, err, fn, plain_fn, plain_reps=10, headline=None,
               library_fn=None, sector_coords=None, **note):
        row = F32_ROWS[name] if note.get("features") == "f32" else name
        ms = device_time_ms(fn)
        plain_ms = device_time_ms(plain_fn, reps=plain_reps)
        bound = kernel_bound(name, *shape, C, features=note.get("features",
                                                                "bf16"),
                             coords=sector_coords)
        times = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound["ms"],
                 "bound_by": bound["bound_by"]}
        if "sector_ms" in bound:
            # the same bound with the taps counted in whole 32-byte sectors
            note = {**note, "sectors_per_pixel":
                    f"{bound['sectors'] / np.prod(shape):.2f}",
                    "sector_bound_ms": f"{bound['sector_ms']:.4f}",
                    "share_of_sector_bound": f"{bound['sector_ms'] / ms:.4f}"}
        if library_fn is not None:
            times["library_ms"] = device_time_ms(library_fn)
        log("kernel", name=name, shape="x".join(map(str, shape)), **note,
            max_abs_err=f"{err:.3g}", tol=TOL[name],
            share_of_bound=f"{bound['ms'] / ms:.4f}",
            **{k: v if isinstance(v, str) else f"{v:.4f}"
               for k, v in times.items()})
        if not err <= TOL[name]:
            raise AssertionError(f"{name} at {shape}: error {err} > "
                                 f"{TOL[name]}")
        r = res[row]
        r["err"] = max(r["err"], err)
        if shape == HEADLINE[row] if headline is None else headline:
            r.update(times)

    # bf16 features pool to a bf16-rounded pyramid, level by level
    f1, f2, _ = kernel_inputs(2, 30, 101, torch.bfloat16, seed=0)
    pyr = cuda_corr.pool_pyramid(f2)
    if not torch.equal(pyr, pyr.bfloat16().float()):
        raise AssertionError("bf16 pyramid levels are not bf16 values")
    log("kernel", name="pool_pyramid", shape="2x30x101",
        bf16_levels_rounded=True)

    shape = (3, 17, 45)
    f1, f2, _ = kernel_inputs(*shape, torch.bfloat16, seed=sum(shape))
    res["build_volumes"]["err"] = max(
        res["build_volumes"]["err"],
        check_volume(shape, torch.bfloat16, cuda_corr.build_volumes(f1, f2),
                     cuda_corr.build_volumes_plain(f1, f2)))

    # K1 on f32 features (three TF32 passes), beside one library product
    # of the same f32 operands
    for shape in ((2, 30, 101), (3, 17, 45)):
        f1, f2, _ = kernel_inputs(*shape, torch.float32, seed=sum(shape))
        vol = cuda_corr.build_volumes(f1, f2)
        pyr = cuda_corr.pool_pyramid(f2)
        a = f1.reshape(shape[0], -1, C) * cuda_corr.SCALE
        b = torch.nn.functional.pad(
            pyr, (0, 0, 0, vol.shape[-1] - pyr.shape[1])).transpose(1, 2)
        record("build_volumes", shape,
               check_volume(shape, torch.float32, vol,
                            cuda_corr.build_volumes_plain(f1, f2)),
               lambda: cuda_corr.build_volumes_pooled(f1, pyr),
               lambda: cuda_corr.build_volumes_plain(f1, f2),
               library_fn=lambda: torch.bmm(a, b), features="f32",
               entry="pooled")
        del vol, pyr, a, b

    # K2 must give the bits of the one-warp, 2-byte-load kernel it replaced
    vol, coords = (t.cuda() for t in kbench.saved_extract_case())
    same = kbench.fingerprint(cuda_corr.corr_extract(vol, coords)) == \
        kbench.SAVED_EXTRACT_SHA256
    log("kernel", name="corr_extract", shape="x".join(map(str, coords.shape)),
        equal_to_replaced_kernel=same)
    if not same:
        raise AssertionError("corr_extract: output differs from the "
                             "replaced kernel's on the saved case")

    for E in (1, 24, 48):
        shape = (E, 30, 101)
        f1, f2, coords = kernel_inputs(*shape, torch.bfloat16, seed=E)
        vol = cuda_corr.build_volumes(f1, f2)
        ref = cuda_corr.build_volumes_plain(f1, f2)
        # the yardstick: one library product of the same bf16 operands
        pyr = cuda_corr.pool_pyramid(f2, dtype=torch.bfloat16)
        a = (f1.reshape(E, -1, C).float() * cuda_corr.SCALE).bfloat16()
        b = torch.nn.functional.pad(
            pyr, (0, 0, 0, vol.shape[-1] - pyr.shape[1])).transpose(1, 2)
        record("build_volumes", shape,
               check_volume(shape, torch.bfloat16, vol, ref),
               lambda: cuda_corr.build_volumes(f1, f2),
               lambda: cuda_corr.build_volumes_plain(f1, f2),
               library_fn=lambda: torch.bmm(a, b))
        ms = device_time_ms(lambda: cuda_corr.build_volumes_pooled(f1, pyr))
        bound = kernel_bound("build_volumes", *shape, C)["ms"]
        log("kernel", name="build_volumes", shape="x".join(map(str, shape)),
            kernel_only_ms=f"{ms:.4f}", bound_ms=f"{bound:.4f}",
            share_of_bound=f"{bound / ms:.4f}")
        del pyr, a, b
        out = cuda_corr.corr_extract(ref, coords)
        err = (out - cuda_corr.corr_extract_plain(ref, coords)).abs().max()
        record("corr_extract", shape, err.item(),
               lambda: cuda_corr.corr_extract(ref, coords),
               lambda: cuda_corr.corr_extract_plain(ref, coords),
               sector_coords=coords.cpu().numpy())
        del vol, ref, out
        torch.cuda.empty_cache()

    for shape in K3_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            check_lookup(shape, dtype, record)
    check_lookup_f32_corners()

    # K3 through the gathered entry (pooling included) on uniform random
    # coordinates with border bands, for f32 features too: the shapes of
    # the kernel table in PERF.md, on kernel_inputs' seeds
    for shape, band, dtype in (
            ((1, 30, 101), None, torch.float32),
            ((24, 30, 101), None, torch.bfloat16),
            ((48, 30, 101), None, torch.bfloat16),
            ((256, 30, 101), None, torch.bfloat16),
            ((1, 47, 156), ("x", 150.0, 160.0), torch.float32),
            ((1, 128, 40), ("y", 122.0, 131.0), torch.float32)):
        f1, f2, coords = kernel_inputs(*shape, dtype, seed=sum(shape),
                                       band=band)
        err = kbench.lookup_err(cuda_corr.corr_lookup(f1, f2, coords),
                                cuda_corr.corr_lookup_plain(f1, f2, coords))
        record("corr_lookup", shape, err,
               lambda: cuda_corr.corr_lookup(f1, f2, coords),
               lambda: cuda_corr.corr_lookup_plain(f1, f2, coords),
               plain_reps=3, headline=False, coords="uniform",
               features="bf16" if dtype == torch.bfloat16 else "f32",
               entry="gathered")
        torch.cuda.empty_cache()
    return res


def check_lookup(shape, dtype, record):
    """K3 at one shape and feature dtype, on every kind of coordinates,
    through both entries. The frames are the edges' own f1, f2 stacked;
    the indexed entry reads them through shuffled edges."""
    E, H, W = shape
    tensor = dtype == torch.bfloat16
    feats = "bf16" if tensor else "f32"
    f1, f2, _ = kernel_inputs(E, H, W, dtype, seed=sum(shape))
    frames = torch.cat([f1, f2])
    pyr = cuda_corr.lookup_pyramid(frames)
    rng = np.random.RandomState(E)
    ii = torch.as_tensor(rng.permutation(E), device="cuda")
    jj = torch.as_tensor(E + rng.permutation(E), device="cuda")
    for kind in kbench.LOOKUP_COORDS:
        coords = torch.from_numpy(
            kbench.lookup_coords(kind, E, H, W, seed=E + H)).cuda()
        cuda_corr.reset_routes()
        out = cuda_corr.corr_lookup(f1, f2, coords)
        routes = cuda_corr.routes()
        err = kbench.lookup_err(out,
                                cuda_corr.corr_lookup_plain(f1, f2, coords))
        # the indexed entry: against its plain version, or (E=256, where
        # that costs 16 GB of volumes again) against the kernel on the
        # gathered features, which the line above has checked
        idx = cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords)
        if E <= 48:
            idx_ref = cuda_corr.corr_lookup_indexed_plain(frames, pyr, ii,
                                                          jj, coords)
        else:
            idx_ref = cuda_corr.corr_lookup(frames[ii], frames[jj], coords)
        # numpy's max keeps a NaN (a NaN on one side only)
        err = float(np.max([err, kbench.lookup_err(idx, idx_ref)]))
        del out, idx, idx_ref
        if kind == "smooth" and routes[1]:
            raise AssertionError(f"corr_lookup {feats} at {shape}: "
                                 f"{routes[1]} (block, level) pairs off the "
                                 "tensor cores on smooth coordinates")
        if kind == "mixed" and not (routes[0] and routes[1]):
            raise AssertionError(f"corr_lookup {feats} at {shape}: the mixed "
                                 f"case took routes {routes}, not both")
        if kind == "smooth":
            # timed through the indexed entry: the backend's (bf16) and
            # the export step's (f32)
            record("corr_lookup", shape, err,
                   lambda: cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj,
                                                         coords),
                   lambda: cuda_corr.corr_lookup_plain(f1, f2, coords),
                   plain_reps=3, features=feats, coords=kind,
                   entry="indexed", tensor_core_pairs=routes[0],
                   per_pixel_pairs=routes[1])
        else:
            log("kernel", name="corr_lookup",
                shape="x".join(map(str, shape)), features=feats, coords=kind,
                max_abs_err=f"{err:.3g}", tol=TOL["corr_lookup"],
                tensor_core_pairs=routes[0], per_pixel_pairs=routes[1])
            if not err <= TOL["corr_lookup"]:
                raise AssertionError(f"corr_lookup {feats} at {shape} on "
                                     f"{kind} coordinates: error {err}")
        torch.cuda.empty_cache()
    if (tensor and E in (48, 256)) or (not tensor and E <= 2):
        # the gathered entry pools its edges' f2 on every call (the
        # motion filter's probe is the f32 one at E=1)
        coords = torch.from_numpy(
            kbench.lookup_coords("smooth", E, H, W, seed=E + H)).cuda()
        ms = device_time_ms(lambda: cuda_corr.corr_lookup(f1, f2, coords))
        log("kernel", name="corr_lookup", shape="x".join(map(str, shape)),
            features=feats, coords="smooth", entry="gathered",
            ms=f"{ms:.4f}")
    if not tensor:
        check_no_gather(frames, pyr, ii, jj, coords)


def check_no_gather(frames, pyr, ii, jj, coords):
    """The indexed entry on f32 features indexes the edges' frames in
    the kernel: one launch, and no allocation but its output (a gather
    of frames or pyramids would allocate)."""
    ii, jj = ii.int().contiguous(), jj.int().contiguous()
    torch.cuda.synchronize()
    cuda_corr.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords)
    peak = torch.cuda.max_memory_allocated() - before
    size = out.numel() * out.element_size()
    log("kernel", name="corr_lookup", shape="x".join(map(str, coords.shape)),
        features="f32", entry="indexed", launches=cuda_corr.LAUNCHES[
            "corr_lookup"], allocated_bytes=peak, output_bytes=size)
    # the allocator hands out a block up to 1 MiB larger than asked; one
    # frame's features are 1.5 MB at 30x101, its pyramid more
    if cuda_corr.F32_LAUNCHES["corr_lookup"] != 1 or peak >= size + 2 ** 20:
        raise AssertionError(f"corr_lookup_indexed on f32 features: "
                             f"{cuda_corr.F32_LAUNCHES} launches, {peak} "
                             f"bytes allocated for an output of {size}")


def check_lookup_f32_corners():
    """K3's f32 kernel off the main path's shape: C=24 for f32 and bf16
    features (bf16 ones whose C is no multiple of 16 take it on an f32
    pyramid), 1 to 4 levels, and features under 8 a side, whose last
    level is pooled away to nothing. Both entries, smooth and mixed
    coordinates, <= 1e-4."""
    cases = [((3, 30, 101), 24, torch.float32, 4),
             ((3, 30, 101), 24, torch.bfloat16, 4),
             ((2, 5, 7), C, torch.float32, 4), ((3, 9, 3), 24,
                                                torch.float32, 4)]
    cases += [((2, 30, 101), C, torch.float32, n) for n in (1, 2, 3)]
    for shape, width, dtype, levels in cases:
        E, H, W = shape
        f1, f2, _ = kernel_inputs(E, H, W, dtype, seed=width + levels,
                                  width=width)
        frames = torch.cat([f1, f2])
        pyr = cuda_corr.lookup_pyramid(frames, levels)
        if pyr.dtype != torch.float32:
            raise AssertionError("not the f32 kernel's pyramid")
        ii = torch.arange(E - 1, -1, -1, device="cuda")
        jj = E + torch.arange(E, device="cuda")
        for kind in ("smooth", "mixed"):
            coords = torch.from_numpy(
                kbench.lookup_coords(kind, E, H, W, seed=levels)).cuda()
            cuda_corr.reset_launches()
            err = max(
                kbench.lookup_err(
                    cuda_corr.corr_lookup(f1, f2, coords, levels),
                    cuda_corr.corr_lookup_plain(f1, f2, coords, levels)),
                kbench.lookup_err(
                    cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj,
                                                  coords, levels),
                    cuda_corr.corr_lookup_indexed_plain(frames, pyr, ii, jj,
                                                        coords, levels)))
            log("kernel", name="corr_lookup", shape="x".join(map(str, shape)),
                features=str(dtype).split(".")[-1], C=width, levels=levels,
                coords=kind, max_abs_err=f"{err:.3g}",
                tol=TOL["corr_lookup"])
            if not err <= TOL["corr_lookup"] or \
                    cuda_corr.F32_LAUNCHES["corr_lookup"] != 2:
                raise AssertionError(f"corr_lookup f32 kernel at {shape}, "
                                     f"C={width}, {levels} levels, {kind}: "
                                     f"error {err}")


def check_volume(shape, dtype, vol, ref):
    """K1's volume against its plain version's: returns max |d|; raises
    beyond TOL, below K1_EQUAL bit-equal, beyond one bf16 ulp anywhere,
    or on a nonzero pad column."""
    E, H, W = shape
    n2 = sum(h * w for h, w in cuda_corr.level_shapes(H, W))
    err, equal, ulp_ok, pad = cuda_corr.volume_agreement(vol, ref, n2)
    log("kernel", name="build_volumes", shape="x".join(map(str, shape)),
        features=str(dtype).split(".")[-1], stride=vol.shape[-1],
        max_abs_err=f"{err:.3g}", bit_equal=f"{equal:.6f}",
        within_one_ulp=ulp_ok, pad_max=pad)
    if not (vol.shape == ref.shape == (E, H * W, cuda_corr.padded_n2(n2))
            and err <= TOL["build_volumes"] and equal >= K1_EQUAL
            and ulp_ok and pad == 0.0):
        raise AssertionError(f"build_volumes {dtype} at {shape}: shape "
                             f"{tuple(vol.shape)}, error {err}, {equal:.6f} "
                             f"bit-equal, within one ulp {ulp_ok}, pad {pad}")
    return err


def packed_err(name, shape, variant, out, ref, equal_share=PACKED_EQUAL,
               **note):
    """Max |out - ref| of two packed bf16 outputs (NaN in both counts as
    equal, in one as a failure); raises beyond PACKED_TOL or below
    ``equal_share`` bit-equal."""
    a, b = out.float(), ref.float()
    both_nan = a.isnan() & b.isnan()
    d = (a - b).abs().masked_fill(both_nan, 0.0)
    bad = int((d > PACKED_TOL[0] + PACKED_TOL[1] * b.abs()).sum())
    equal = ((a == b) | both_nan).float().mean().item()
    err = d.max().item()
    log("kernel", name=name, shape="x".join(map(str, shape)),
        variant=repr(variant), **note, max_abs_err=f"{err:.3g}", bad=bad,
        bit_equal=f"{equal:.6f}")
    if bad or equal < equal_share or not np.isfinite(err):
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


def check_lookup_packed(shape, coords_kind, f1, f2, coords, variants):
    """P1 in ``variants`` against plain on one set of inputs, its route
    counts against the numpy model's; returns (worst max |d|, outputs)."""
    E, H, W = shape
    want = cuda_corr_exp.expected_routes(coords.cpu().numpy(), H, W)
    worst, outs = 0.0, []
    for kw in variants:
        cuda_corr_exp.reset_routes()
        outs.append(cuda_corr_exp.corr_lookup_packed(f1, f2, coords, **kw))
        routes = cuda_corr_exp.routes()
        worst = max(worst, packed_err(
            "corr_lookup_packed", shape, kw, outs[-1],
            cuda_corr_exp.corr_lookup_packed_plain(f1, f2, coords, **kw),
            coords=coords_kind, pairs_within_cap=routes[0],
            pairs_above_cap=routes[1]))
        # smooth: every box within the cap; uniform and mixed: both kinds
        if routes != want or (coords_kind == "smooth" and routes[1]) or (
                coords_kind in ("uniform", "mixed") and not all(routes)):
            raise AssertionError(f"corr_lookup_packed at {shape} on "
                                 f"{coords_kind} coordinates took routes "
                                 f"{routes}, the model says {want}")
    return worst, outs


def check_packed():
    """Phase 3, P1 and P2 in every output-defining variant against their
    plain versions, at the harness shapes and with half the pixels in a
    band over the right or the bottom border; P1 also on the coordinates
    of kbench.lookup_coords and off the harness's shape. Returns the
    worst error of each X kernel."""
    err = dict.fromkeys(HARNESS, 0.0)
    shapes = [((64, 30, 101), None), ((2, 30, 101), ("x", 95.0, 106.0)),
              ((2, 30, 101), ("y", 25.0, 33.0))]
    p1_variants = [dict(order=o, seldt=s) for o in cuda_corr_exp.ORDERS
                   for s in cuda_corr_exp.SELDT]
    for shape, band in shapes:
        f1, f2, coords = kernel_inputs(*shape, torch.bfloat16, seed=7,
                                       band=band)
        e, outs = check_lookup_packed(shape, "uniform" if band is None
                                      else f"band_{band[0]}", f1, f2, coords,
                                      p1_variants)
        err["X1"] = max(err["X1"], e)
        check_distinct("corr_lookup_packed", shape, p1_variants, outs)
        del f1, f2, coords, outs
        torch.cuda.empty_cache()
    # smooth coordinates (every box within the cap), mixed and NaN/huge
    # ones, a ragged shape, and features under 8 a side (level 3 empty)
    for shape, kind in (((64, 30, 101), "smooth"), ((2, 47, 156), "smooth"),
                        ((2, 30, 101), "mixed"), ((2, 30, 101), "wild"),
                        ((3, 17, 45), "smooth"), ((3, 17, 45), "scattered"),
                        ((2, 5, 7), "smooth"), ((2, 5, 7), "scattered")):
        f1, f2, _ = kernel_inputs(*shape, torch.bfloat16, seed=sum(shape))
        coords = torch.from_numpy(
            kbench.lookup_coords(kind, *shape, seed=shape[1])).cuda()
        e, outs = check_lookup_packed(shape, kind, f1, f2, coords,
                                      p1_variants)
        err["X1"] = max(err["X1"], e)
        del f1, f2, coords, outs
        torch.cuda.empty_cache()

    # P2 must give the bits of the 2-byte-load kernel it replaced
    vol, coords = (t.cuda() for t in kbench.saved_extract_case())
    same = kbench.fingerprint(cuda_corr_exp.corr_extract_packed(
        vol, coords)) == kbench.SAVED_EXTRACT_PACKED_SHA256
    log("kernel", name="corr_extract_packed",
        shape="x".join(map(str, coords.shape)), equal_to_replaced_kernel=same)
    if not same:
        raise AssertionError("corr_extract_packed: output differs from the "
                             "replaced kernel's on the saved case")

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
                cuda_corr_exp.corr_extract_packed_plain(vol, coords, **kw),
                equal_share=1.0)
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


def tame_net(seed=0, scale=0.01, mask_bias=0.0):
    """Random weights (seed) with the flow/mask heads' last convs scaled
    by ``scale``. With unscaled random weights the tracker is chaotic: a
    1e-6 change grows to O(1) in three updates, and at 240x808 the
    disparities reach 1e10 and the bf16 update overflows to NaN by frame
    18, with only 16-24 edges left after initialization. Scaled, the
    run is stable and holds the reference's 48-edge steady state. The
    work per update is the same. ``mask_bias`` is added to the mask
    head's output bias: scaled, the head leaves the mask logits near 0,
    the static/dynamic threshold."""
    net = DroidNet.from_seed(seed)
    with torch.no_grad():
        for head in ("delta", "delta_dy", "delta_mask"):
            getattr(net.update, head)[2].weight.mul_(scale)
            getattr(net.update, head)[2].bias.mul_(scale)
        net.update.delta_mask[2].bias.add_(mask_bias)
    return net


class EventTimer:
    """CUDA-event pairs around every call of the functions it wraps."""

    def __init__(self):
        self.calls = []

    def wrap(self, fn, key=lambda *a, **kw: None):
        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.calls.append((key(*a, **kw), start, end))
            return out
        return timed

    def ms(self):
        """[(key, device ms)] of the calls so far, in call order."""
        torch.cuda.synchronize()
        return [(k, s.elapsed_time(e)) for k, s, e in self.calls]


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def plain_kernels():
    """Swap each kernel wrapper (K3's indexed entry too) for its plain
    PyTorch version."""
    names = cuda_corr.KERNELS + ("corr_lookup_indexed",)
    saved = {k: getattr(cuda_corr, k) for k in names}
    for k in names:
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
    8 frames, from the trajectory filler, must agree within 1e-3 abs.
    The mask head is biased by -2 (every mask logit far below the
    static/dynamic threshold): unbiased, 7% of the logits lie within
    0.05 of it, where a pixel's decision follows rounding, and two runs
    of the same kernel loop already differ by 9e-4."""
    cfg = VOConfig(image_size=(64, 96), warmup=5, filter_thresh=-1.0,
                   keyframe_thresh=0.0, segm_filter=True, max_edges=48,
                   frontend_window=8, dtype_features="float32")

    frames = list(synth_stream(8, 64, 96))

    def run():
        s = VOSystem(cfg, net=tame_net(mask_bias=-2.0), device="cuda",
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
    """Phase 5: returns the kernel launch counts of the run, K1's and
    K3's split by feature type (F32_ROWS: the motion filter's probe is
    the run's f32 K3; the video's features are bf16, so no f32 K1)."""
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

    # the backend apart from the rest of terminate: its wall time, the
    # edges of each global update, and K3 inside it through the wrapper
    # and as the kernel alone (CUDA events around the library call)
    backend, backend_s, graphs = sysm.backend, [], []
    k3_wrapper, k3_kernel = EventTimer(), EventTimer()

    def timed_backend(steps):
        torch.cuda.synchronize()
        b0 = time.perf_counter()
        backend(steps)
        torch.cuda.synchronize()
        backend_s.append(time.perf_counter() - b0)

    def counted_update(graph, *a, steps=8, **kw):
        graphs.append((graph.n_edges, steps))
        return update_lowmem(graph, *a, steps=steps, **kw)

    sysm.backend = timed_backend
    update_lowmem = FactorGraph.update_lowmem
    lib = cuda_corr._library()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_corr.reset_launches()

    times = []
    for t, img, intr, segm in frames:
        f0 = time.perf_counter()
        sysm.track(t, img, intr, segments=segm)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - f0)
    tracked = dict(cuda_corr.LAUNCHES)
    cuda_corr.reset_routes()
    with contextlib.ExitStack() as stack:
        for entry in ("corr_lookup", "corr_lookup_indexed"):
            stack.enter_context(patched(
                cuda_corr, entry, k3_wrapper.wrap(
                    getattr(cuda_corr, entry),
                    key=lambda *a: a[-1].shape[0])))
        stack.enter_context(patched(lib, "pvo_corr_lookup",
                                    k3_kernel.wrap(lib.pvo_corr_lookup)))
        stack.enter_context(patched(FactorGraph, "update_lowmem",
                                    counted_update))
        t0 = time.perf_counter()
        traj = sysm.terminate(iter(frames), backend_steps=(7, 12))
        torch.cuda.synchronize()
    # terminate_s: the last frontend update and the backend, as measured
    # before terminate filled every frame; filler_s: the filler
    term_s = time.perf_counter() - t0 - filler_s[0]
    launches = dict(cuda_corr.LAUNCHES)
    f32_launches = dict(cuda_corr.F32_LAUNCHES)

    # the frontend initializes at t=12 (warmup 12, admission committed
    # one frame late); steady state is t=13..39
    meas = times[13:]
    log("main", image=f"{H}x{W}", frames=n_frames,
        keyframes=sysm.video.counter,
        volume_cached=cuda_corr.volume_cache_ok(sysm.video.h, sysm.video.w),
        fps=f"{len(meas) / sum(meas):.3f}",
        ms_per_frame=f"{1e3 * sum(meas) / len(meas):.2f}",
        init_frame_s=f"{times[12]:.3f}", terminate_s=f"{term_s:.3f}",
        filler_s=f"{filler_s[0]:.3f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        **{f"launches_{k}": v for k, v in launches.items()},
        **{f"of_them_f32_{k}": v for k, v in f32_launches.items()})
    # K3 inside terminate: chunks of the backend's global updates
    wrapper = k3_wrapper.ms()
    kernel = [ms for _, ms in k3_kernel.ms()]
    if len(wrapper) != len(kernel):
        raise AssertionError("K3 wrapper and kernel calls do not pair up")
    sizes = sorted({E for E, _ in wrapper})
    per_size = {E: (sum(1 for e, _ in wrapper if e == E),
                    np.mean([w for e, w in wrapper if e == E]),
                    np.mean([k for (e, _), k in zip(wrapper, kernel)
                             if e == E])) for E in sizes}
    updates = sum(steps for _, steps in graphs)
    log("backend", backend_s=f"{sum(backend_s):.3f}",
        rest_of_terminate_s=f"{term_s - sum(backend_s):.3f}",
        calls=len(backend_s), global_updates=updates,
        edges_per_call="/".join(str(n) for n, _ in graphs),
        **{f"{k}_launches_in_terminate": launches[k] - tracked[k]
           for k in launches},
        k3_chunks_per_update=f"{len(wrapper) / max(updates, 1):.2f}",
        k3_wrapper_ms_total=f"{sum(w for _, w in wrapper):.3f}",
        k3_kernel_ms_total=f"{sum(kernel):.3f}",
        **{f"k3_E{E}": f"{n}x(wrapper {w:.4f} ms, kernel {k:.4f} ms)"
           for E, (n, w, k) in per_size.items()})
    tc, simt = cuda_corr.routes()
    log("backend", k3_block_levels_tensor_core=tc,
        k3_block_levels_per_pixel=simt,
        tensor_core_share=f"{tc / max(tc + simt, 1):.4f}")
    if tc == 0:
        raise AssertionError("terminate never took K3's tensor-core route")
    if traj.shape != (n_frames, 7) or not np.isfinite(traj).all():
        raise AssertionError(f"bad trajectory {traj.shape}")
    depth, flow = sysm.get_depth(), sysm.get_flow()
    n = sysm.video.counter
    log("main", get_depth="x".join(map(str, depth.shape)),
        get_flow="x".join(map(str, flow.shape)))
    if not (depth.shape == (n, H, W) and flow.shape == (n, H, W, 2)
            and np.isfinite(depth).all() and np.isfinite(flow).all()):
        raise AssertionError(f"bad accessors {depth.shape} {flow.shape}")
    # the tracking path's bf16 kernels, and K3's f32 kernel (the probe)
    launches.update({F32_ROWS[k]: v for k, v in f32_launches.items()})
    for k in cuda_corr.F32_KERNELS:
        launches[k] -= f32_launches[k]
    missing = [k for k, v in launches.items()
               if v == 0 and k != "build_volumes_f32"]
    if missing or launches["build_volumes_f32"]:
        raise AssertionError(f"launches on the main path: {launches}; never "
                             f"launched: {missing}")
    return launches


def run_harnesses():
    """Phase 6: each corr experiment harness's main() at its default
    shapes, with its kernel's launches counted from 0; a harness that
    runs another's program (corr_exp5 runs corr_exp4's) takes that
    run's results. Returns {X: (launches, ms and plain_ms of the
    harness's first case, worst max |d|)} and, under "X1 routes",
    corr_exp.time_routes()'s result."""
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
    # P1 on the harness's coordinates and on smooth ones, wrapper and
    # kernel alone, with the (block, level) pairs of one launch by route
    routes = importlib.import_module(
        "pvo_tpu_torch.scripts.corr_exp").time_routes()
    for kind, r in routes.items():
        log("harness", kernel="X1", coords=kind, ms=f"{r['ms']:.4f}",
            kernel_only_ms=f"{r['kernel_ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}",
            share_of_bound=f"{r['bound_ms'] / r['kernel_ms']:.4f}",
            pairs_within_cap=r["routes"][0], pairs_above_cap=r["routes"][1])
        if r["routes"] != r["expected_routes"]:
            raise AssertionError(f"X1 on {kind} coordinates took routes "
                                 f"{r['routes']}, the model says "
                                 f"{r['expected_routes']}")
    if routes["smooth"]["routes"][1] or not all(routes["uniform"]["routes"]):
        raise AssertionError(f"X1's routes: {routes}")
    res["X1 routes"] = routes
    # P2's second bound: the sectors its loads touch on the harness's coords
    E = HARNESS_E["corr_extract_packed"]
    sectors = kernel_bound(
        "corr_extract_packed", E, 30, 101, C,
        coords=harness_inputs(E, 30, 101)[2].cpu().numpy())
    ms = res["X2"][1]
    log("harness", kernel="X2-X5", shape=f"{E}x30x101", ms=f"{ms:.4f}",
        bound_ms=f"{sectors['ms']:.4f}",
        share_of_bound=f"{sectors['ms'] / ms:.4f}",
        sectors_per_pixel=f"{sectors['sectors'] / (E * 3030):.2f}",
        sector_bound_ms=f"{sectors['sector_ms']:.4f}",
        share_of_sector_bound=f"{sectors['sector_ms'] / ms:.4f}")
    return res


def forward_outputs(net, size, iters=3):
    """DroidNet.forward on bench_vo2_export's window at ``size``: (1/8-res
    flows, upsampled disparities) of the last step, and the launches."""
    images, poses, intr8 = bench_vo2_export.bench_inputs(size)
    dev = torch.device("cuda")
    args = (torch.from_numpy(poses)[None].to(dev),
            torch.from_numpy(images)[None].to(dev),
            torch.ones((1, 2, size[0] // 8, size[1] // 8), device=dev),
            torch.from_numpy(intr8).to(dev).expand(1, 2, 4))
    cuda_corr.reset_launches()
    with torch.no_grad():
        out = net(*args, [0, 1], [1, 0], num_steps=iters, ret_flow=True,
                  downsample=True, final_only=True)
    torch.cuda.synchronize()
    return out["flows"][-1], out["disps_up"][-1], dict(cuda_corr.LAUNCHES)


def time_export_kernels():
    """K1-K3 as the export calls them (E=2, f32 features, smooth
    coordinates): error against plain, time, plain time and bound. K1
    (three TF32 passes, beside torch.bmm on the same f32 operands) and K2
    at the narrow 30x101, K3 through the indexed entry at 47x156 (three
    TF32 passes, the edges' frames indexed in the kernel)."""
    def line(name, shape, out, ref, fn, plain_fn, library_fn=None):
        err = (out.float() - ref.float()).abs().max().item()
        ms, plain_ms = device_time_ms(fn), device_time_ms(plain_fn, reps=3)
        bound = kernel_bound(name, *shape, C, features="f32")
        extra = {} if library_fn is None else {
            "library_ms": f"{device_time_ms(library_fn):.4f}"}
        log("export", kernel=name, shape="x".join(map(str, shape)),
            features="f32", max_abs_err=f"{err:.3g}", tol=TOL[name],
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound['ms']:.4f}", bound_by=bound["bound_by"],
            share_of_bound=f"{bound['ms'] / ms:.4f}", **extra)
        if not err <= TOL[name]:
            raise AssertionError(f"{name} at {shape}: error {err}")

    shape = (2, 30, 101)
    f1, f2, _ = kernel_inputs(*shape, torch.float32, seed=5)
    coords = torch.from_numpy(kbench.lookup_coords("smooth", *shape)).cuda()
    vol, ref = cuda_corr.build_volumes(f1, f2), \
        cuda_corr.build_volumes_plain(f1, f2)
    check_volume(shape, torch.float32, vol, ref)
    pyr = cuda_corr.pool_pyramid(f2)
    a = f1.reshape(2, -1, C) * cuda_corr.SCALE
    b = torch.nn.functional.pad(
        pyr, (0, 0, 0, vol.shape[-1] - pyr.shape[1])).transpose(1, 2)
    line("build_volumes", shape, vol, ref,
         lambda: cuda_corr.build_volumes(f1, f2),
         lambda: cuda_corr.build_volumes_plain(f1, f2),
         library_fn=lambda: torch.bmm(a, b))
    line("corr_extract", shape, cuda_corr.corr_extract(vol, coords),
         cuda_corr.corr_extract_plain(vol, coords),
         lambda: cuda_corr.corr_extract(vol, coords),
         lambda: cuda_corr.corr_extract_plain(vol, coords))

    shape = (2, 47, 156)
    frames, _, _ = kernel_inputs(*shape, torch.float32, seed=6)
    coords = torch.from_numpy(kbench.lookup_coords("smooth", *shape)).cuda()
    pyr = cuda_corr.lookup_pyramid(frames)
    ii = torch.tensor([0, 1], device="cuda")
    jj = torch.tensor([1, 0], device="cuda")
    line("corr_lookup", shape,
         cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords),
         cuda_corr.corr_lookup_indexed_plain(frames, pyr, ii, jj, coords),
         lambda: cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords),
         lambda: cuda_corr.corr_lookup_indexed_plain(frames, pyr, ii, jj,
                                                     coords))


def run_export():
    """Phase 7: returns {"376x1248": launches per pair, "240x808": ...}."""
    net = tame_net(0, mask_bias=-2.0).cuda().eval()
    time_export_kernels()

    # the kernels against their plain versions, through the forward
    for size, want in (((64, 96), (1, 3, 0)), ((64, 1000), (0, 0, 3))):
        flow, disp, launches = forward_outputs(net, size)
        with plain_kernels():
            flow_ref, disp_ref, plain_launches = forward_outputs(net, size)
        flow_err = (flow - flow_ref).abs().max().item()
        disp_err = (disp - disp_ref).abs().max().item()
        log("export", check="kernels_vs_plain", image="x".join(map(str, size)),
            iters=3, flow_max_abs_err=f"{flow_err:.3g}",
            disp_up_max_abs_err=f"{disp_err:.3g}", tol=EXPORT_TOL,
            flow_max=f"{flow_ref.abs().max().item():.3g}",
            disp_up_max=f"{disp_ref.abs().max().item():.3g}",
            **{f"launches_{k}": v for k, v in launches.items()})
        if tuple(launches.values()) != want or any(plain_launches.values()):
            raise AssertionError(f"export at {size}: launches {launches}, "
                                 f"under plain_kernels {plain_launches}")
        if not (flow_err <= EXPORT_TOL and disp_err <= EXPORT_TOL):
            raise AssertionError(f"export at {size}: the forward with the "
                                 f"kernels disagrees with the plain one")

    per_pair = {}
    for size, pairs, want in ((EXPORT_SIZE, EXPORT_PAIRS, (0, 0, EXPORT_ITERS)),
                              (EXPORT_NARROW, EXPORT_NARROW_PAIRS,
                               (1, EXPORT_ITERS, 0))):
        H, W = size
        tag = f"{H}x{W}"
        # one warm-up pair, then the counts from 0 over the timed pairs
        bench_vo2_export.time_pairs(net, size, EXPORT_ITERS, pairs=1)
        torch.cuda.reset_peak_memory_stats()
        cuda_corr.reset_launches()
        s_per_pair, (flow8, disp) = bench_vo2_export.time_pairs(
            net, size, EXPORT_ITERS, pairs=pairs)
        launches = dict(cuda_corr.LAUNCHES)
        per_pair[tag] = {k: v // pairs for k, v in launches.items()}
        f32 = dict(cuda_corr.F32_LAUNCHES)
        if any(f32[k] != launches[k] for k in f32):
            raise AssertionError(f"export at {tag}: f32 features launched "
                                 f"{f32} of {launches} on the f32 kernels")
        log("export", image=tag, iters=EXPORT_ITERS, pairs=pairs,
            features="f32", vo2_export_s_per_pair=f"{s_per_pair:.4f}",
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            **{f"launches_per_pair_{k}": v for k, v in per_pair[tag].items()},
            gpu=repr(gpu_line()))
        if tuple(launches.values()) != tuple(pairs * n for n in want):
            raise AssertionError(f"export at {tag}: launches {launches} "
                                 f"over {pairs} pairs, expected {want} each")
        h, w = H // 8, W // 8
        if not (flow8.shape == (h, w, 2) and disp.shape == (h, w)
                and flow8.dtype == disp.dtype == np.float32
                and np.isfinite(flow8).all() and np.isfinite(disp).all()):
            raise AssertionError(f"export at {tag}: bad arrays "
                                 f"{flow8.shape} {disp.shape}")

    # where a pair's time goes at full width: K3 per step through the
    # wrapper and as the kernel alone, then one pair under the profiler
    inputs = bench_vo2_export.bench_inputs(EXPORT_SIZE)
    k3_wrapper, k3_kernel = EventTimer(), EventTimer()
    lib = cuda_corr._library()
    with patched(cuda_corr, "corr_lookup_indexed",
                 k3_wrapper.wrap(cuda_corr.corr_lookup_indexed)), \
            patched(lib, "pvo_corr_lookup",
                    k3_kernel.wrap(lib.pvo_corr_lookup)):
        export_pair(net, *inputs, iters=EXPORT_ITERS)
    wrapper = [ms for _, ms in k3_wrapper.ms()]
    kernel = [ms for _, ms in k3_kernel.ms()]
    bound = kernel_bound("corr_lookup", 2, EXPORT_SIZE[0] // 8,
                         EXPORT_SIZE[1] // 8, C, features="f32")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        export_pair(net, *inputs, iters=EXPORT_ITERS)
        torch.cuda.synchronize()
    # kernel rows only: an op's row repeats its kernels' device time;
    # aten rows count nested ops too (conv2d -> convolution -> cudnn)
    rows = prof.key_averages()
    on_card = [r for r in rows
               if r.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(r.self_device_time_total for r in on_card) / 1e3
    kernels = sum(r.count for r in on_card)
    aten_ops = sum(r.count for r in rows if r.key.startswith("aten::"))
    log("export", image=f"{EXPORT_SIZE[0]}x{EXPORT_SIZE[1]}",
        k3_calls=len(wrapper),
        k3_wrapper_ms_per_step=f"{np.mean(wrapper):.4f}",
        k3_kernel_ms_per_step=f"{np.mean(kernel):.4f}",
        k3_bound_ms=f"{bound['ms']:.4f}", k3_bound_by=bound["bound_by"],
        k3_wrapper_ms_per_pair=f"{sum(wrapper):.3f}",
        profiled_device_ms_per_pair=f"{device_ms:.2f}",
        profiled_kernels_per_pair=kernels, aten_ops_per_pair=aten_ops)
    top = sorted(on_card, key=lambda r: -r.self_device_time_total)[:6]
    log("export", top_kernels=repr("; ".join(
        f"{r.key[:56]} {r.self_device_time_total / 1e3:.2f} ms x{r.count}"
        for r in top)))
    if len(wrapper) != EXPORT_ITERS or len(kernel) != EXPORT_ITERS:
        raise AssertionError("K3 did not run once per iteration")
    return per_pair


PHASES = {"kernels": check_kernels, "packed": check_packed,
          "reference": check_reference, "main": run_main_path,
          "harness": run_harnesses, "export": run_export}


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

    only = sys.argv[1:]
    if only:
        # a partial run, for work on one phase: no result lines
        for name in only:
            PHASES[name]()
        print(card)
        return 0

    res = check_kernels()
    packed = check_packed()
    check_reference()
    launches = run_main_path()
    harness = run_harnesses()
    export = run_export()

    # K1 and K3 have a row for each feature type. A bf16 row's launches
    # are phase 5's (the video's features); an f32 row's are the timed
    # pairs of the export route that runs it (K1: 240x808, K3: 376x1248),
    # each counted from 0; the f32 K3 also runs as phase 5's probe. K2 is
    # one kernel on both paths
    pairs = {"build_volumes_f32": (EXPORT_NARROW, EXPORT_NARROW_PAIRS),
             "corr_lookup_f32": (EXPORT_SIZE, EXPORT_PAIRS)}
    f32_of = {v: k for k, v in F32_ROWS.items()}
    kernels = []
    for row in (*cuda_corr.KERNELS, *F32_ROWS.values()):
        k = f32_of.get(row, row)
        n, extra = launches[row], {}
        if row in pairs:
            (H, W), timed = pairs[row]
            tag = f"{H}x{W}"
            extra = {"launches_tracking": n,
                     f"launches_per_pair_{tag}": export[tag][k]}
            n = export[tag][k] * timed
        elif k not in F32_ROWS:
            extra = {f"launches_export_{tag}": per[k]
                     for tag, per in export.items()}
        kernels.append({
            "name": row, "route": "cuda",
            "source": "pvo_tpu_torch/csrc/corr.cu", "replaces": REPLACES[k],
            "launches": n, "max_abs_err": res[row]["err"],
            "ms": res[row]["ms"], "plain_ms": res[row]["plain_ms"],
            "bound_ms": res[row]["bound_ms"],
            "bound_by": res[row]["bound_by"],
            "library_ms": res[row]["library_ms"], **extra})
        if n == 0:
            raise AssertionError(f"{row} was never launched on its path")
    for x, (_, kernel, site) in HARNESS.items():
        n, ms, plain_ms, err = harness[x]
        bound = kernel_bound(kernel, HARNESS_E[kernel], 30, 101, C)
        extra = {}
        if x == "X1":
            # ms is on the harness's uniform coordinates, through the wrapper
            uniform, smooth = (harness["X1 routes"][k]
                               for k in ("uniform", "smooth"))
            extra = {"kernel_only_ms": uniform["kernel_ms"],
                     "ms_smooth": smooth["ms"],
                     "kernel_only_ms_smooth": smooth["kernel_ms"],
                     "pairs_within_above_cap": uniform["routes"],
                     "pairs_within_above_cap_smooth": smooth["routes"]}
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": "pvo_tpu_torch/csrc/corr_exp.cu", "replaces": site,
            "launches": n, "max_abs_err": max(err, packed[x]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound["ms"],
            "bound_by": bound["bound_by"], "library_ms": None, **extra})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
