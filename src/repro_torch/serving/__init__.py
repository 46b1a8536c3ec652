"""Tensor-parallel continuous-batching serving on PyTorch (port of the FMI
path of :mod:`repro.serving`)."""

from .engine import ContinuousBatchingEngine
from .kv_cache import KVPageManifest, OutOfPages, PagedKVCache
from .tp_lm import TPServeConfig

__all__ = [
    "ContinuousBatchingEngine",
    "PagedKVCache",
    "KVPageManifest",
    "OutOfPages",
    "TPServeConfig",
]
