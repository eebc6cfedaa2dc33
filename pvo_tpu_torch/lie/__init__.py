"""SO3 / SE3 / Sim3 on raw tensors (port of :mod:`pvo_tpu.lie`)."""

from . import se3, sim3, so3

__all__ = ["so3", "se3", "sim3"]
