"""Rotary position embeddings (counterpart of the JAX package's
``ops/rotary.py``).

Conventions match HF ``transformers`` (non-interleaved halves,
``rotate_half``), including Llama-3 "llama3" frequency scaling.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..config import RopeScaling


class RopeAngles(NamedTuple):
    """Rotary state for one forward step: ``cos``/``sin`` are the tables for
    the query positions (``[B, S, D]``), computed once and shared by every
    layer; ``inv_freq`` rides along for cache policies that re-derive
    per-slot key angles."""

    inv_freq: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor


def rope_inv_freq(
    head_dim: int,
    theta: float,
    scaling: Optional[RopeScaling] = None,
    device: Union[str, torch.device] = "cpu",
) -> torch.Tensor:
    """Per-frequency inverse wavelengths ``[head_dim // 2]`` (fp32)."""
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    )
    inv_freq = 1.0 / (theta**exponent)
    if scaling is None or scaling.rope_type == "default":
        return inv_freq
    if scaling.rope_type == "linear":
        return inv_freq / scaling.factor
    if scaling.rope_type == "llama3":
        orig = scaling.original_max_position_embeddings
        low_wavelen = orig / scaling.low_freq_factor
        high_wavelen = orig / scaling.high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        scaled = inv_freq / scaling.factor
        smooth = (orig / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor
        )
        smoothed = (1.0 - smooth) * scaled + smooth * inv_freq
        out = torch.where(wavelen > low_wavelen, scaled, inv_freq)
        is_medium = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        return torch.where(is_medium, smoothed, out)
    raise ValueError(f"unsupported rope_type: {scaling.rope_type}")


def rope_cos_sin(
    positions: torch.Tensor,
    inv_freq: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer ``positions`` ``[...]`` → ``[..., head_dim]``
    (half-dim frequencies duplicated across both halves, HF's layout)."""
    freqs = positions.float()[..., None] * inv_freq  # [..., hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> torch.Tensor:
    """Rotate ``x[..., seq, heads, head_dim]`` by ``cos/sin[..., seq, head_dim]``
    in fp32, cast back to ``x``'s dtype."""
    dtype = x.dtype
    xf = x.float()
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return (xf * c + rotate_half(xf) * s).to(dtype)
