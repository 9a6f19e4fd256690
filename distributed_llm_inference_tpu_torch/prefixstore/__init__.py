"""Prefix/KV reuse (counterpart of the JAX package's ``prefixstore/``):
PagedAttention's copy-on-write page sharing and a host spill tier.

* **Engine-level CoW sharing** lives in ``engine/engine.py`` and
  ``cache/paged.py``: sessions register their full prompt pages at
  admission, concurrent sessions attach to the same device pages
  read-only, and a session whose write offset lands inside a shared page
  splits it copy-on-write first.
* **Host spill tier**, :class:`.spill.HostSpillArena`: evicted prefix
  pages spill to a bounded host arena in stored form and reload through
  the page pool on a later hit (a host-to-device copy instead of a
  recompute).
* **Hash-chain helpers**, :mod:`.index`: the engine's content addresses as
  hex strings, for advertising and matching prefixes across nodes (the
  fleet's routing itself is not ported).
"""

from .index import chain_keys_hex, match_tokens
from .spill import HostSpillArena

__all__ = ["HostSpillArena", "chain_keys_hex", "match_tokens"]
