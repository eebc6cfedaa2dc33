"""The benchmark of ``pvo_tpu_torch`` on one NVIDIA H100: cells of live
tracking and of the end-of-clip wait, driven by the data files beside
this package's code (``python3 -m pvo_bench.run --help``)."""
