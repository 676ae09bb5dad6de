"""Data pipeline of the torch port."""
from .pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
