"""The int8 KV quantizer shared by the quantized caches (counterpart of
``_quantize_kv`` in the JAX package's ``cache/dense.py``).

This module holds only that function for now: the dense caches themselves
(``DenseKVCache``, ``QuantizedDenseKVCache``) wait for ``ROADMAP.md`` queue
1, items 5 and 7.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: ``x`` ``[B, S, H, D]`` →
    ``(q int8 [B, S, H, D], scale f32 [B, S, H])``. Computed in f32,
    rounded half to even, clipped to ±127: the bytes equal the JAX
    package's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(
        torch.int8
    )
    return q, scale
