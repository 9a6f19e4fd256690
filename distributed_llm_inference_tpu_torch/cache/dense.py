"""The int8 KV quantizer shared by the quantized caches and the fused
decode window's segment masks (counterparts of ``_quantize_kv`` and
``segment_valids`` in the JAX package's ``cache/dense.py``).

This module holds only those two functions for now: the dense caches
themselves (``DenseKVCache``, ``QuantizedDenseKVCache``) wait for
``ROADMAP.md`` queue 1, items 5 and 7.
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
    # A tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can land one ulp off the true
    # quotient that the JAX package and the fused kernels compute.
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(
        torch.int8
    )
    return q, scale


def segment_valids(base_len, tail_len, num_new, t, kk, sliding_window):
    """Validity masks ``([B, T], [B, K])`` of the (big, tail) segments of
    the fused decode window (counterpart of the JAX package's
    ``segment_valids``): big slots below ``base_len``, tail slots below
    ``tail_len + num_new``, both inside the sliding window of the query at
    ``base_len + tail_len``."""
    dev = base_len.device
    q_pos = base_len + tail_len
    big_pos = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    big_valid = big_pos < base_len[:, None]
    slots = torch.arange(kk, dtype=torch.int32, device=dev)[None, :]
    tail_pos = base_len[:, None] + slots
    tail_valid = slots < (tail_len + num_new)[:, None]
    if sliding_window is not None:
        big_valid &= big_pos > (q_pos[:, None] - sliding_window)
        tail_valid &= tail_pos > (q_pos[:, None] - sliding_window)
    return big_valid, tail_valid
