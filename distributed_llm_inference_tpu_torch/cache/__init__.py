from .base import GatherAttendMixin, window_ladder
from .dense import DenseKVCache, QuantizedDenseKVCache
from .latent import LatentPagedKVCache, QuantizedLatentPagedKVCache
from .paged import PageAllocator, PagedKVCache, QuantizedPagedKVCache
from .sink import QuantizedSinkKVCache, SinkKVCache

__all__ = [
    "DenseKVCache",
    "GatherAttendMixin",
    "LatentPagedKVCache",
    "PageAllocator",
    "PagedKVCache",
    "QuantizedDenseKVCache",
    "QuantizedLatentPagedKVCache",
    "QuantizedPagedKVCache",
    "QuantizedSinkKVCache",
    "SinkKVCache",
    "window_ladder",
]
