"""Token sampling (counterpart of the JAX package's ``engine/sampling.py``).

Samplers are batch-vectorized with *per-row* parameters, so one decode step
serves heterogeneous sessions (a greedy row and a top-p row share the batch).
Randomness is a counter-based draw, a pure function of (key, step, row,
token): the engine draws one key per dispatch, and the steps of a fused
K-step decode window fold in their index, the counterpart of
``jax.random.fold_in(key, i)``. It needs no generator state and no host
step, so a CUDA graph of a window's step replays it. Sampled streams are
deterministic for a seed but cannot equal the JAX package's (another random
number generator); greedy streams and the top-k/top-p filter do.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ..utils.device import to_device


@dataclasses.dataclass
class SamplingParams:
    """Per-row sampling knobs, shape ``[B]`` each.

    ``temperature == 0`` selects greedy for that row. ``top_k <= 0`` disables
    top-k; ``top_p >= 1`` disables nucleus filtering. ``all_greedy`` is a
    host-side flag: the all-greedy batch — the common serving case — skips
    the full-vocab sort altogether.
    """

    temperature: torch.Tensor
    top_k: torch.Tensor
    top_p: torch.Tensor
    all_greedy: bool = False

    @staticmethod
    def create(
        batch: int, temperature=0.0, top_k=0, top_p=1.0,
        device: Union[str, torch.device] = "cpu",
    ) -> "SamplingParams":
        return SamplingParams.stack(
            [SamplingOptions(temperature, top_k, top_p)] * batch, device
        )

    @staticmethod
    def stack(rows, device: Union[str, torch.device] = "cpu") -> "SamplingParams":
        def col(name, dt):
            return to_device([getattr(r, name) for r in rows], dt, device)

        return SamplingParams(
            temperature=col("temperature", torch.float32),
            top_k=col("top_k", torch.int32),
            top_p=col("top_p", torch.float32),
            all_greedy=all(r.temperature <= 0.0 for r in rows),
        )


@dataclasses.dataclass(frozen=True)
class SamplingOptions:
    """Host-side per-session options (the scheduler stacks them per step)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    max_new_tokens: int = 128
    eos_token_id: int = -1  # -1 = never stop on EOS
    # Opt in to draft-model speculative decoding (greedy rows of an engine
    # built with a draft; elsewhere the flag has no effect).
    speculative: bool = False


_NEG = -1e30


def _filter_top_k_top_p(
    logits: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor
) -> torch.Tensor:
    """Joint top-k + nucleus filter sharing ONE descending sort.

    Top-k keeps ranks ``< k``; top-p keeps the smallest prefix of the sorted
    distribution with cumulative probability ≥ top_p (rank 0 always survives).
    """
    b, vocab = logits.shape
    sorted_logits, sort_idx = torch.sort(
        logits, dim=-1, descending=True, stable=True
    )
    ranks = torch.arange(vocab, device=logits.device)[None, :]

    keep_k = (ranks < top_k.clamp(1, vocab)[:, None]) | (top_k[:, None] <= 0)

    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = ((cum - probs) < top_p[:, None]) | (top_p[:, None] >= 1.0)

    keep = torch.zeros((b, vocab), dtype=torch.bool, device=logits.device)
    keep.scatter_(1, sort_idx, keep_k & keep_p)
    return torch.where(keep, logits, _NEG)


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (two multiply-xorshift rounds) on int64
    tensors holding values in [0, 2^32): products stay below 2^59, so
    nothing overflows."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def uniforms(key: torch.Tensor, step: torch.Tensor, batch: int,
             vocab: int) -> torch.Tensor:
    """Uniforms in (0, 1), ``[batch, vocab]`` f32, a pure function of
    ``(key, step, row, vocab index)``: ``key`` one int64 (the dispatch's
    key), ``step`` one int32 (the step index), both on the device."""
    dev = key.device
    k = key.reshape(1).long()
    lo, hi = k & _M32, (k >> 32) & _M32
    seed = _mix32(lo ^ _mix32(hi ^ _mix32(step.reshape(1).long() & _M32)))
    rows = torch.arange(batch, dtype=torch.int64, device=dev)
    row_seed = _mix32(seed ^ _mix32(rows + 0x3C6EF372))          # [B]
    cols = torch.arange(vocab, dtype=torch.int64, device=dev)
    h = _mix32(_mix32(row_seed[:, None] ^ ((cols * 0x9E3779B1) & _M32)))
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample(
    logits: torch.Tensor,
    key: Union[int, torch.Tensor, None],
    params: SamplingParams,
    step: Union[int, torch.Tensor] = 0,
) -> torch.Tensor:
    """Draw one token per row from ``logits [B, V]`` → ``[B]`` int32.

    Greedy rows (temperature 0) and stochastic rows coexist in one call.
    ``key`` is the dispatch's sampling key and ``step`` the step within a
    fused decode window (0 elsewhere): integers, or one-element int64 and
    int32 tensors on the logits' device (a captured step reads them there).
    Stochastic rows take a Gumbel-max over :func:`uniforms` of ``(key,
    step)`` of the temperature-scaled, top-k/top-p filtered logits: the same
    inputs give the same tokens, eager or replayed from a CUDA graph. An
    all-greedy batch never touches ``key`` and contains no full-vocab
    sort."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if params.all_greedy:
        return greedy
    dev = logits.device
    if not torch.is_tensor(key):
        key = torch.full((1,), int(key), dtype=torch.int64, device=dev)
    if not torch.is_tensor(step):
        step = torch.full((1,), int(step), dtype=torch.int32, device=dev)
    temp = params.temperature.clamp_min(1e-6)[:, None]
    scaled = logits.float() / temp
    scaled = _filter_top_k_top_p(scaled, params.top_k, params.top_p)
    u = uniforms(key, step, logits.shape[0], logits.shape[1])
    drawn = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1).to(
        torch.int32)
    return torch.where(params.temperature > 0.0, drawn, greedy)
