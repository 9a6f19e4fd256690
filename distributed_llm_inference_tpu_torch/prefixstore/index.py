"""Prefix hash-chain helpers (counterpart of the JAX package's
``prefixstore/index.py``).

``PageAllocator.chain_keys`` (``cache/paged.py``) defines the content
address of a prompt's page-sized chunks: a running sha1 over each chunk's
int64 token bytes. :func:`chain_keys_hex` reproduces that byte stream with
``struct`` alone, so a control plane can compute the same keys without
torch or numpy; keys travel as hex strings.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Iterable, List, Sequence, Set

__all__ = ["chain_keys_hex", "match_tokens"]


def chain_keys_hex(tokens: Sequence[int], page_size: int) -> List[str]:
    """Hex hash-chain keys of every FULL ``page_size`` chunk of ``tokens``:
    byte-identical to ``PageAllocator.chain_keys(...)[i].hex()``
    (``np.asarray(chunk, np.int64).tobytes()`` is native-order int64, which
    ``struct.pack("=%dq")`` reproduces)."""
    if page_size <= 0:
        raise ValueError(f"page_size must be positive, got {page_size}")
    keys, h = [], hashlib.sha1()
    for i in range(len(tokens) // page_size):
        chunk = tokens[i * page_size : (i + 1) * page_size]
        h.update(struct.pack("=%dq" % len(chunk), *(int(t) for t in chunk)))
        keys.append(h.hexdigest())
    return keys


def match_tokens(
    prompt: Sequence[int], page_size: int, heads: Iterable[str]
) -> int:
    """Longest prefix of ``prompt`` (in TOKENS, page-granular) whose chain
    keys are all present in ``heads`` (a node's advertised hex key set).
    Walks from the root and stops at the first miss: a deeper key without
    its ancestors is unreachable on the advertising node too."""
    head_set: Set[str] = set(heads)
    if not head_set:
        return 0
    matched = 0
    for key in chain_keys_hex(prompt, page_size):
        if key not in head_set:
            break
        matched += page_size
    return matched
