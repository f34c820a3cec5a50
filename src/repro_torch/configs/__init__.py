"""Architecture configs (copies of the reference's) + shape specs."""
from .base import SHAPES, ArchConfig, ShapeSpec
from .registry import (ARCH_NAMES, PORTED_FAMILIES, cells, check_family,
                       get_arch, get_shape)

__all__ = ["SHAPES", "ArchConfig", "ShapeSpec", "ARCH_NAMES",
           "PORTED_FAMILIES", "cells", "check_family", "get_arch",
           "get_shape"]
