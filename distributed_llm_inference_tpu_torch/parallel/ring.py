"""Ring attention: sequence parallelism over the ``sp`` axis for long
prefills (counterpart of the JAX package's ``parallel/ring.py``).

For a prompt past the engine's ring threshold the sequence is cut into
``sp`` chunks, one a rank, and attention runs as a ring:

* each rank holds one query chunk and one KV chunk;
* the KV chunks (with their positions and validity) rotate around the ring
  by send/recv between neighbouring ranks of the ``sp`` group (the JAX
  package's ``lax.ppermute``), ``sp`` visits in all, the last rotation
  skipped;
* each rank folds every visiting chunk into its queries' attention with the
  online-softmax recurrence (running max, normaliser, unnormalised
  accumulator, all f32), which equals one softmax over the whole row.

The layer stack runs unchanged through :class:`RingChunkCache`, a cache
that captures each layer's rotated chunk K/V and hands attention to the
ring. The ring's attention is plain PyTorch, as the JAX one is XLA: the
JAX package has no Pallas kernel for it.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..config import ModelConfig
from ..models import llama
from ..ops.attention import _NEG_INF, causal_mask
from ..ops.rotary import apply_rope
from . import comm

__all__ = ["RingChunkCache", "ring_gqa_attention", "ring_prefill",
           "dense_cache_from_ring"]


def ring_gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    kv_valid: torch.Tensor,
    scale: float,
    axis,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """GQA ring attention over the ranks of ``axis`` (an ``sp`` axis of
    ``parallel/mesh.py``). ``q``: ``[B, Sl, Hq, D]`` the local query chunk
    (rotated); ``k``/``v``: ``[B, Tl, Hkv, D]`` the local KV chunk;
    ``q_pos``/``kv_pos``: ``[B, Sl|Tl]`` global positions; ``kv_valid``:
    ``[B, Tl]``. Returns ``[B, Sl, Hq, D]`` in q's type."""
    sp, me = axis.size, axis.index
    b, sl, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sl, hkv, g, d).float()
    k_c, v_c = k.contiguous(), v.contiguous()
    meta = torch.stack([kv_pos.to(torch.int32), kv_valid.to(torch.int32)])
    m = torch.full((b, hkv, g, sl), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sl, d), dtype=torch.float32,
                      device=q.device)
    for t in range(sp):
        pos_c, valid_c = meta[0], meta[1].bool()
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k_c.float()) * scale
        mask = causal_mask(q_pos, pos_c, valid_c, sliding_window)
        mask = mask[:, None, None]                      # [B, 1, 1, Sl, Tl]
        scores = torch.where(mask, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v_c.dtype).float(),
                          v_c.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
        if t < sp - 1:
            # The last visit's rotation would be discarded: skipped.
            nk, nv, nmeta = (torch.empty_like(k_c), torch.empty_like(v_c),
                             torch.empty_like(meta))
            comm.exchange(
                [(k_c, (me + 1) % sp), (v_c, (me + 1) % sp),
                 (meta, (me + 1) % sp)],
                [(nk, (me - 1) % sp), (nv, (me - 1) % sp),
                 (nmeta, (me - 1) % sp)],
                axis,
            )
            k_c, v_c, meta = nk, nv, nmeta
    out = acc / l.clamp_min(1e-20)[..., None]
    # [B, Hkv, G, Sl, D] -> [B, Sl, Hq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sl, hq, d).to(q.dtype)


class RingChunkCache:
    """Cache-protocol adapter for a sequence-sharded fresh prefill: the
    rank owns global positions ``[offset, offset + Sl)``, and a layer's
    "update" captures its chunk's rotated K and V into ``k`` / ``v``
    ``[L, B, Sl, Hkv, D]`` (the layer stack's per-layer planes). Attention
    is the ``attention_fn`` the caller gives (the ring's), which builds its
    own per-visit masks."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, offset: int):
        self.k = k
        self.v = v
        self.offset = offset

    @property
    def device(self) -> torch.device:
        return self.k.device

    @property
    def layer_stacks(self):
        return (self.k, self.v)

    def q_positions(self, seq_len: int) -> torch.Tensor:
        pos = self.offset + torch.arange(seq_len, dtype=torch.int32,
                                         device=self.device)
        return pos[None, :].expand(self.k.shape[1], seq_len)

    def rope_positions(self, seq_len: int, num_new) -> torch.Tensor:
        return self.q_positions(seq_len)

    def attend(self, layer_state, q, k_new, v_new, rope, q_pos, num_new,
               sliding_window, attention_fn, scale=None):
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        layer_state[0].copy_(k_rot)
        layer_state[1].copy_(v_new)
        out = attention_fn(q_rot, k_rot, v_new, None, scale=scale)
        return out, layer_state

    def advance(self, num_new) -> "RingChunkCache":
        return self


def ring_prefill(
    cfg: ModelConfig,
    params: Any,
    tokens: torch.Tensor,
    num_new: torch.Tensor,
    mesh,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequence-parallel prefill of (long) prompts from an empty cache.

    ``tokens``: ``[B, S]`` with ``S`` divisible by the ``sp`` degree (pad
    to a bucket); ``num_new``: ``[B]`` valid prompt lengths; ``cfg`` and
    ``params`` this rank's tensor-parallel shard. Returns ``(logits [B, 1,
    V] at each row's last valid position, ks, vs)``, ``ks``/``vs`` the
    rotated keys and values ``[L, B, S, Hkv, D]`` gathered over ``sp``
    (every ``sp`` rank decodes the row, so each takes the whole KV): feed
    them to a cache's ``ingest_row`` (:func:`dense_cache_from_ring`)."""
    sp = mesh.axis("sp")
    b, s = tokens.shape
    if s % sp.size != 0:
        raise ValueError(f"padded seq len {s} not divisible by sp={sp.size}")
    sl = s // sp.size
    offset = sp.index * sl
    x = llama.embed(params, tokens[:, offset:offset + sl], mesh)
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    nl = params["layers"]["attn_norm"].shape[0]
    cache = RingChunkCache(
        torch.zeros((nl, b, sl, hkv, d), dtype=x.dtype, device=x.device),
        torch.zeros((nl, b, sl, hkv, d), dtype=x.dtype, device=x.device),
        offset,
    )
    kv_pos = cache.q_positions(sl)
    kv_valid = kv_pos < num_new[:, None]

    def attention_fn(q, k, v, mask, scale=None):
        return ring_gqa_attention(q, k, v, kv_pos, kv_pos, kv_valid, scale,
                                  sp, sliding_window=cfg.sliding_window)

    x, cache = llama.block_apply(cfg, params["layers"], x, cache, num_new,
                                 attention_fn, mesh)
    x = comm.all_gather(x, sp, dim=1)
    ks = comm.all_gather(cache.k, sp, dim=2)
    vs = comm.all_gather(cache.v, sp, dim=2)
    # The head on each row's last valid position only (materializing [B,
    # S, V] logits would defeat the point of a long-context prefill).
    idx = (num_new - 1).long()[:, None, None].expand(-1, 1, x.shape[-1])
    logits = llama.apply_head(cfg, params, torch.gather(x, 1, idx), mesh)
    return logits, ks, vs


def dense_cache_from_ring(ks: torch.Tensor, vs: torch.Tensor,
                          num_new, max_seq_len: int):
    """A :class:`cache.dense.DenseKVCache` (lengths advanced) holding
    ring-prefill KV, ready for decode; ``max_seq_len`` >= the prefill
    length. A thin wrapper over the cache's ``ingest_row``, the one home of
    the ring-KV-to-cache layout."""
    from ..cache.dense import DenseKVCache

    l, b, s, hkv, d = ks.shape
    if max_seq_len < s:
        raise ValueError(f"max_seq_len {max_seq_len} < prefill length {s}")
    cache = DenseKVCache.create(l, b, max_seq_len, hkv, d, ks.dtype,
                                device=ks.device)
    return cache.ingest_row(ks, vs, num_new)
