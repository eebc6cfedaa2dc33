"""VO network stack: encoders, ConvGRU, update operator, correlation."""

from . import corr  # noqa: F401
from .droidnet import DroidNet, normalize_images  # noqa: F401
from .extractor import BasicEncoder  # noqa: F401
from .gru import ConvGRU  # noqa: F401
from .update import (DynamicUpdateModule, GraphAgg,  # noqa: F401
                     UpdateModule)
