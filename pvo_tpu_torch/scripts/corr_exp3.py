"""P2 in X3's diagnostic modes (``scripts/corr_exp3.py``), on K1's volume
of the harness inputs: E=32, 30x101, C=128, bf16 features.

    python -m pvo_tpu_torch.scripts.corr_exp3 [E [H W]]

``full`` is the packed extraction; ``nostore`` keeps only the dy = 0
row of each level; ``novab`` and ``dma`` write channels 0-127 from the
last level (selector row + correlation row, per-column sums). The
channels a TPU mode leaves unwritten are written as 0.
"""

from pvo_tpu_torch.scripts.harness import extract_cases
from pvo_tpu_torch.scripts.kbench import require_cuda

CASES = {m: dict(mode=m) for m in ("full", "nostore", "novab", "dma")}


def main(argv=None):
    require_cuda()
    return extract_cases(argv, CASES)


if __name__ == "__main__":
    main()
