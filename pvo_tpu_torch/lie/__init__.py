"""SO3 / SE3 on raw tensors (port of :mod:`pvo_tpu.lie`; Sim3 is not
ported yet)."""

from . import se3, so3

__all__ = ["so3", "se3"]
