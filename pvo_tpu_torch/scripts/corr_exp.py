"""P1, the fused packed correlation lookup, at the shapes of X1
(``scripts/corr_exp.py``): E=64, 30x101, C=128, bf16 features.

    python -m pvo_tpu_torch.scripts.corr_exp [E [H W]]

Each case is one of X1's store layouts with its intermediate dtype:
``perlevel`` and ``matpack`` write the level-major layout (the same call
here, timed once), ``dymajor`` the dy-major one. X1's ``main()`` runs
the first two; the rest cover P1's other variants. X1's ``merge`` and
``blk`` knobs are TPU selector and tiling choices with no counterpart
here. Prints P1's ms beside its plain version's and the largest
difference between them, on X1's coordinates (uniform over the image),
then (:func:`time_routes`) P1 through the wrapper and as the kernel
alone on those coordinates and on smooth ones, beside its bound and the
count of (block, level) pairs whose bounding box lay within and above
the kernel's cap.
"""

import functools

import torch

from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.scripts.harness import (harness_inputs, run_cases,
                                           shape_args)
from pvo_tpu_torch.scripts.kbench import gpu_line, require_cuda
from pvo_tpu_torch.vo.net import cuda_corr
from pvo_tpu_torch.vo.net import cuda_corr_exp as cx

SHAPE = (64, 30, 101)
CASES = {f"{store} {s}": dict(order=o, seldt=s)
         for store, o, s in (("perlevel", "level", "f32"),
                             ("matpack", "level", "f32"),
                             ("dymajor", "dy", "f32"),
                             ("perlevel", "level", "bf16"),
                             ("dymajor", "dy", "bf16"))}


def main(argv=None):
    require_cuda()
    E, H, W = shape_args(argv, SHAPE)
    f1, f2, coords = harness_inputs(E, H, W)
    print(f"E={E} {H}x{W} C=128 bf16; {gpu_line()}", flush=True)
    return run_cases(
        CASES, functools.partial(cx.corr_lookup_packed, f1, f2, coords),
        functools.partial(cx.corr_lookup_packed_plain, f1, f2, coords))


def time_routes(E=SHAPE[0], H=SHAPE[1], W=SHAPE[2]):
    """P1 (level-major, f32 intermediates) on the harness's uniform
    coordinates and on smooth ones: {kind: {"ms" (through the wrapper,
    which pools f2), "kernel_ms" (on a pyramid pooled beforehand),
    "bound_ms", "routes" (pairs within, above the cap in one launch),
    "expected_routes" (the numpy model's)}}."""
    require_cuda()
    f1, f2, uniform = harness_inputs(E, H, W)
    pyr = cuda_corr.pool_pyramid(f2, dtype=torch.bfloat16)
    bound = kbench.kernel_bound("corr_lookup_packed", E, H, W,
                                f1.shape[-1])["ms"]
    res = {}
    for kind, coords in (("uniform", uniform), ("smooth", torch.from_numpy(
            kbench.lookup_coords("smooth", E, H, W)).cuda())):
        cx.reset_routes()
        cx.corr_lookup_packed_pooled(f1, pyr, coords)
        r = {"routes": cx.routes(),
             "expected_routes": cx.expected_routes(coords.cpu().numpy(),
                                                   H, W),
             "ms": kbench.device_time_ms(
                 lambda: cx.corr_lookup_packed(f1, f2, coords)),
             "kernel_ms": kbench.device_time_ms(
                 lambda: cx.corr_lookup_packed_pooled(f1, pyr, coords)),
             "bound_ms": bound}
        print(f"{kind} coords: wrapper {r['ms']:.4f} ms, kernel alone "
              f"{r['kernel_ms']:.4f} ms, bound {bound:.4f} ms (share "
              f"{bound / r['kernel_ms']:.4f}); (block, level) pairs within "
              f"/ above the cap {r['routes']}, expected "
              f"{r['expected_routes']}", flush=True)
        res[kind] = r
    return res


if __name__ == "__main__":
    main()
    time_routes(*shape_args(None, SHAPE))
