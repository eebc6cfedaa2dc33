"""P2, the packed extraction of X4 (``scripts/corr_exp4.py``), on K1's
volume of the harness inputs: E=32, 30x101, C=128, bf16 features.

    python -m pvo_tpu_torch.scripts.corr_exp4 [E [H W]]

X4 differs from the production extraction only in how the TPU builds
its selectors and stores the 256 channels; its ``blk`` knob has no
counterpart here. The first line times K2 on the same volume, as X4
times the production extraction.
"""

from pvo_tpu_torch.scripts.harness import extract_cases
from pvo_tpu_torch.scripts.kbench import require_cuda

CASES = {"extract v2": {}}


def main(argv=None):
    require_cuda()
    return extract_cases(argv, CASES, baseline="extract v1")


if __name__ == "__main__":
    main()
