"""P2 with X2's rounding variants (``scripts/corr_exp2.py``), on K1's
volume of the harness inputs: E=32, 30x101, C=128, bf16 features.

    python -m pvo_tpu_torch.scripts.corr_exp2 [E [H W]]

X2's ``cast_vol=False`` rounds the bilinear weights and the row blend
to bf16, ``sel_dtype=bf16`` rounds the weights (see
``cuda_corr_exp.X2_VARIANTS``); its ``blk`` knob is a TPU tiling choice
with no counterpart here. The first line times K2 on the same volume,
as X2 times the production extraction.
"""

from pvo_tpu_torch.scripts.harness import extract_cases
from pvo_tpu_torch.scripts.kbench import require_cuda
from pvo_tpu_torch.vo.net.cuda_corr_exp import X2_VARIANTS

CASES = {f"cast={int(cast)} sel={sel}": dict(weights=w, round_mid=mid)
         for (cast, sel), (w, mid) in X2_VARIANTS.items()}


def main(argv=None):
    require_cuda()
    return extract_cases(argv, CASES, baseline="current extract")


if __name__ == "__main__":
    main()
