from .base import ARCH_IDS, ARCHS, LATER, get_config, smoke_config

__all__ = ["ARCH_IDS", "ARCHS", "LATER", "get_config", "smoke_config"]
