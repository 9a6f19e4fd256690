from .base import GatherAttendMixin, window_ladder
from .paged import PageAllocator, PagedKVCache, QuantizedPagedKVCache

__all__ = [
    "GatherAttendMixin",
    "PageAllocator",
    "PagedKVCache",
    "QuantizedPagedKVCache",
    "window_ladder",
]
