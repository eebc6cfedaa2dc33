"""Kernel harnesses of the port, run on one NVIDIA GPU
(``python -m pvo_tpu_torch.scripts.<name>``)."""
