"""Bounded host-memory spill arena for evicted prefix pages (counterpart of
the JAX package's ``prefixstore/spill.py``).

When the page pool evicts a registered prefix page (refcount-aware LRU
under allocation pressure), the engine snapshots the page's tiles in
STORED form (``PagedKVCache.read_page``: host tensors, int8 values and f32
scales for the quantized pools, the pool's own dtype otherwise) into this
arena through the allocator's ``on_evict`` hook. A later admission whose
prefix chain reaches the key reloads the tiles through
``PagedKVCache.write_page`` (one host-to-device copy a plane) instead of
recomputing the prefill. Contents round-trip verbatim, so reloaded pages
are bit-exact with the originals.

A plain LRU dict under the engine's scheduler lock, bounded by bytes,
evicting oldest-first until a new entry fits. ``take`` REMOVES the entry:
the page is device-resident (and registry-addressable) again, so a second
copy here would only double-count the byte budget.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Optional

__all__ = ["HostSpillArena"]


class HostSpillArena:
    """LRU byte-bounded store of ``{chain key -> page tiles}``; a tile is a
    host torch tensor or a numpy array (anything with ``nbytes``)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._entries: "collections.OrderedDict[bytes, Dict[str, Any]]" = (
            collections.OrderedDict()
        )
        self._sizes: Dict[bytes, int] = {}
        self.bytes_used = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    @staticmethod
    def _nbytes(tiles: Dict[str, Any]) -> int:
        return sum(int(t.nbytes) for t in tiles.values())

    def put(self, key: bytes, tiles: Dict[str, Any]) -> bool:
        """Store one evicted page's tiles; evicts oldest entries until the
        new one fits. Returns ``False`` (arena unchanged) when the entry
        alone exceeds the whole budget or the key is already present."""
        size = self._nbytes(tiles)
        if size > self.max_bytes or key in self._entries:
            return False
        while self.bytes_used + size > self.max_bytes and self._entries:
            old, _ = self._entries.popitem(last=False)
            self.bytes_used -= self._sizes.pop(old)
        self._entries[key] = tiles
        self._sizes[key] = size
        self.bytes_used += size
        return True

    def take(self, key: bytes) -> Optional[Dict[str, Any]]:
        """Remove and return the tiles for ``key`` (``None`` on miss)."""
        tiles = self._entries.pop(key, None)
        if tiles is not None:
            self.bytes_used -= self._sizes.pop(key)
        return tiles

    def peek(self, key: bytes) -> Optional[Dict[str, Any]]:
        """The tiles for ``key`` WITHOUT removing them (``None`` on miss),
        for read-only exports; refreshes the entry's LRU recency."""
        tiles = self._entries.get(key)
        if tiles is not None:
            self._entries.move_to_end(key)
        return tiles

    def keys(self):
        return list(self._entries)
