from .base import GatherAttendMixin, window_ladder
from .dense import DenseKVCache, QuantizedDenseKVCache
from .paged import PageAllocator, PagedKVCache, QuantizedPagedKVCache

__all__ = [
    "DenseKVCache",
    "GatherAttendMixin",
    "PageAllocator",
    "PagedKVCache",
    "QuantizedDenseKVCache",
    "QuantizedPagedKVCache",
    "window_ladder",
]
