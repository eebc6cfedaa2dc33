"""P1, the fused packed correlation lookup, at the shapes of X1
(``scripts/corr_exp.py``): E=64, 30x101, C=128, bf16 features.

    python -m pvo_tpu_torch.scripts.corr_exp [E [H W]]

Each case is one of X1's store layouts with its intermediate dtype:
``perlevel`` and ``matpack`` write the level-major layout (the same call
here, timed once), ``dymajor`` the dy-major one. X1's ``main()`` runs
the first two; the rest cover P1's other variants. X1's ``merge`` and
``blk`` knobs are TPU selector and tiling choices with no counterpart
here. Prints P1's ms beside its plain version's and the largest
difference between them.
"""

import functools

from pvo_tpu_torch.scripts.harness import (harness_inputs, run_cases,
                                           shape_args)
from pvo_tpu_torch.scripts.kbench import gpu_line, require_cuda
from pvo_tpu_torch.vo.net import cuda_corr_exp as cx

CASES = {f"{store} {s}": dict(order=o, seldt=s)
         for store, o, s in (("perlevel", "level", "f32"),
                             ("matpack", "level", "f32"),
                             ("dymajor", "dy", "f32"),
                             ("perlevel", "level", "bf16"),
                             ("dymajor", "dy", "bf16"))}


def main(argv=None):
    require_cuda()
    E, H, W = shape_args(argv, (64, 30, 101))
    f1, f2, coords = harness_inputs(E, H, W)
    print(f"E={E} {H}x{W} C=128 bf16; {gpu_line()}", flush=True)
    return run_cases(
        CASES, functools.partial(cx.corr_lookup_packed, f1, f2, coords),
        functools.partial(cx.corr_lookup_packed_plain, f1, f2, coords))


if __name__ == "__main__":
    main()
