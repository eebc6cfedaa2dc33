"""P2, the packed extraction of X5 (``scripts/corr_exp5.py``), on K1's
volume of the harness inputs: E=32, 30x101, C=128, bf16 features.

    python -m pvo_tpu_torch.scripts.corr_exp5 [E [H W]]

X5 is X4 with the TPU's manual inner pipeline (``emit_pipeline``), which
needed the volume padded to 16 rows. K1's volume here is read as it is,
and the card's blocks overlap their loads without a pipeline written by
hand, so X5 computes what X4 does with the same kernel call: this
harness runs X4's program (:mod:`corr_exp4`).
"""

from pvo_tpu_torch.scripts.corr_exp4 import main

if __name__ == "__main__":
    main()
