"""Speculative decoding: draft-model proposals verified by the target model
(counterpart of the JAX package's ``engine/speculative.py``).

Greedy speculation: the draft model proposes ``k`` tokens one at a time;
the target verifies all of them in ONE forward over ``k + 1`` positions.
The accepted run is the longest prefix where the target's argmax agrees
with the proposal; the target's own argmax at the first disagreement is
appended, so the output is IDENTICAL to target-only greedy decoding:
speculation changes latency, never content.

Rollback is a ``lengths`` decrement: the caches write in place and validity
derives from ``lengths`` alone, so rejected positions are never read. This
decoder serves one sequence over two dense caches in plain PyTorch (the
target's verify takes the cache's gather path, as the JAX one takes XLA);
the engine's batched form is ``engine/engine.py``'s draft branch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..cache.dense import DenseKVCache
from ..config import ModelConfig
from ..models import llama
from ..utils.device import resolve_device

__all__ = ["SpeculativeDecoder"]


class SpeculativeDecoder:
    """Greedy speculative decoding for one sequence (bs = 1).

    ``draft_cfg`` / ``draft_params`` is the small proposal model (same
    vocabulary as the target). ``device`` defaults to ``"cuda"`` and the
    constructor raises when there is no such device."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        draft_cfg: ModelConfig,
        draft_params,
        k: int = 4,
        max_seq_len: int = 512,
        dtype=torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
    ):
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.cfg, self.dcfg = cfg, draft_cfg
        self.params, self.dparams = params, draft_params
        self.k = k
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.device = resolve_device(device)
        self.stats = {"proposed": 0, "accepted": 0, "steps": 0}

    def _mk_cache(self, cfg: ModelConfig) -> DenseKVCache:
        return DenseKVCache.create(
            cfg.num_layers, 1, self.max_seq_len, cfg.num_kv_heads,
            cfg.head_dim, self.dtype, device=self.device,
        )

    def _ones(self) -> torch.Tensor:
        return torch.ones((1,), dtype=torch.int32, device=self.device)

    def draft_propose(self, token: torch.Tensor,
                      cache: DenseKVCache) -> torch.Tensor:
        """``k`` greedy draft tokens from ``token`` ``[1, 1]``; the cache
        advances ``k``. Returns ``[k]`` int32."""
        toks = []
        for _ in range(self.k):
            logits, _ = llama.model_apply(
                self.dcfg, self.dparams, token, cache, self._ones())
            token = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            toks.append(token[0, 0])
        return torch.stack(toks)

    def target_verify(self, last_token: torch.Tensor, proposal: torch.Tensor,
                      cache: DenseKVCache) -> torch.Tensor:
        """One target forward over ``[last, p1..pk]``; returns the argmax at
        every position (``[k + 1]``). The cache advances ``k + 1``: the
        caller rolls ``lengths`` back to the accepted count."""
        seq = torch.cat([last_token[0], proposal])[None, :]
        logits, _ = llama.model_apply(
            self.cfg, self.params, seq, cache,
            torch.full((1,), self.k + 1, dtype=torch.int32,
                       device=self.device))
        return torch.argmax(logits[0], -1).to(torch.int32)

    def generate(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 64,
        eos_token_id: Optional[int] = None,
    ) -> List[int]:
        """Greedy decode; output identical to target-only greedy decoding."""
        n = len(prompt)
        if n == 0:
            raise ValueError("empty prompt")
        if n + max_new_tokens + self.k + 1 > self.max_seq_len:
            raise ValueError("max_seq_len too small for prompt + generation")
        cache_t = self._mk_cache(self.cfg)
        cache_d = self._mk_cache(self.dcfg)
        tokens = torch.tensor([list(prompt)], dtype=torch.int32,
                              device=self.device)
        nn = torch.full((1,), n, dtype=torch.int32, device=self.device)
        logits_t, _ = llama.model_apply(
            self.cfg, self.params, tokens, cache_t, nn)
        llama.model_apply(self.dcfg, self.dparams, tokens, cache_d, nn,
                          head="none")
        last = int(torch.argmax(logits_t[0, n - 1]))
        out = [last]

        k = self.k
        while len(out) < max_new_tokens and last != eos_token_id:
            last_tok = torch.tensor([[last]], dtype=torch.int32,
                                    device=self.device)
            proposal = self.draft_propose(last_tok, cache_d)
            preds = self.target_verify(last_tok, proposal, cache_t)
            prop = proposal.tolist()
            pred = preds.tolist()

            # Longest agreeing prefix; the target's token at the first
            # mismatch is always emitted (pred[i] is conditioned on
            # prop[:i], which all matched).
            accepted = 0
            while accepted < k and prop[accepted] == pred[accepted]:
                accepted += 1
            emitted = prop[:accepted] + [pred[accepted]]

            self.stats["proposed"] += k
            self.stats["accepted"] += accepted
            self.stats["steps"] += 1

            # Roll both caches back to the true sequence. The verify wrote
            # k + 1 positions, of which [last, d1..d_accepted] are real; the
            # target's own token is in no cache yet (it is fed next round).
            cache_t.lengths -= k - accepted
            if accepted == k:
                # Full acceptance: the draft consumed [last, d1..d_{k-1}]
                # but never its own final proposal; one step catches it up.
                llama.model_apply(
                    self.dcfg, self.dparams, proposal[-1:][None, :], cache_d,
                    self._ones(), head="none")
            else:
                cache_d.lengths -= k - accepted - 1

            for t in emitted:
                out.append(t)
                if len(out) >= max_new_tokens or t == eos_token_id:
                    break
            last = out[-1]

        return out[:max_new_tokens]

    @property
    def acceptance_rate(self) -> float:
        return self.stats["accepted"] / max(self.stats["proposed"], 1)
