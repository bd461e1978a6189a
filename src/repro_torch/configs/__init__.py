from .base import (ARCH_IDS, ARCHS, LATER, SHAPES, ShapeSpec, applicable,
                   get_config, input_specs, skip_reason, smoke_config)

__all__ = ["ARCH_IDS", "ARCHS", "LATER", "SHAPES", "ShapeSpec", "applicable",
           "get_config", "input_specs", "skip_reason", "smoke_config"]
