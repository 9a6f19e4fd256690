"""Token sampling (counterpart of the JAX package's ``engine/sampling.py``).

Samplers are batch-vectorized with *per-row* parameters, so one decode step
serves heterogeneous sessions (a greedy row and a top-p row share the batch).
Randomness comes from an explicit ``torch.Generator``. Sampled streams are
deterministic for a seed but cannot equal the JAX package's (another random
number generator); greedy streams and the top-k/top-p filter do.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch


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
            return torch.tensor(
                [getattr(r, name) for r in rows], dtype=dt, device=device
            )

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
    # Opt in to draft-model speculative decoding (not ported yet: the engine
    # refuses a draft model, so the flag has no effect).
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


def sample(
    logits: torch.Tensor,
    key: Union[int, torch.Generator, None],
    params: SamplingParams,
) -> torch.Tensor:
    """Draw one token per row from ``logits [B, V]`` → ``[B]`` int32.

    Greedy rows (temperature 0) and stochastic rows coexist in one call.
    ``key`` is the dispatch's source of randomness: a ``torch.Generator`` on
    the logits' device, or an integer seed for a fresh one (the engine draws
    one such key per dispatch, and can park it). An all-greedy batch never
    touches ``key`` and contains no full-vocab sort.
    """
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if params.all_greedy:
        return greedy

    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=logits.device).manual_seed(int(key))
    temp = params.temperature.clamp_min(1e-6)[:, None]
    scaled = logits.float() / temp
    scaled = _filter_top_k_top_p(scaled, params.top_k, params.top_p)
    drawn = torch.multinomial(
        torch.softmax(scaled, dim=-1), 1, generator=gen
    )[:, 0].to(torch.int32)
    return torch.where(params.temperature > 0.0, drawn, greedy)
