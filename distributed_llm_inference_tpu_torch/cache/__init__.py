from .base import GatherAttendMixin, window_ladder
from .dense import DenseKVCache, QuantizedDenseKVCache
from .paged import PageAllocator, PagedKVCache, QuantizedPagedKVCache
from .sink import QuantizedSinkKVCache, SinkKVCache

__all__ = [
    "DenseKVCache",
    "GatherAttendMixin",
    "PageAllocator",
    "PagedKVCache",
    "QuantizedDenseKVCache",
    "QuantizedPagedKVCache",
    "QuantizedSinkKVCache",
    "SinkKVCache",
    "window_ladder",
]
