"""The LM stack's decoder: torch counterpart of `repro.models` for the
serving slice (attention, RG-LRU and dense-MLP blocks)."""
from .config import ModelConfig  # noqa: F401
