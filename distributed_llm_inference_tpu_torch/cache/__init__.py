from .base import GatherAttendMixin, window_ladder
from .paged import PageAllocator, PagedKVCache

__all__ = ["GatherAttendMixin", "PageAllocator", "PagedKVCache", "window_ladder"]
