"""Architecture configs for the assigned pool (one module per arch)."""

from .base import (ARCH_IDS, SHAPES, ArchConfig, ShapeSpec,  # noqa: F401
                   applicable_shapes, get_config)
