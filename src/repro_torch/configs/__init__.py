"""Architecture configurations of the torch port."""
from .base import ArchConfig, param_count
from .registry import ARCHS, get_arch

__all__ = ["ARCHS", "ArchConfig", "get_arch", "param_count"]
