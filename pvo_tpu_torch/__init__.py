"""pvo_tpu_torch: the PyTorch/CUDA port of :mod:`pvo_tpu`.

The JAX package stays the reference; this package mirrors its layout
(``lie``, ``geom``, ``vo``, ``vo/net``, ``vps``, ``pipeline``,
``utils``) and imports no JAX.
The correlation kernels are hand-written CUDA for Hopper (``csrc/``).
"""
