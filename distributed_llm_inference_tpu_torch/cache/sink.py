"""The StreamingLLM sink ring in the model dtype and int8 (counterpart of the
JAX package's ``cache/sink.py``).

``num_sinks`` attention sinks plus a window of the most recent tokens:
constant memory over streams of any length. A row's stream position ``p``
lives in a fixed slot (sinks at ``0..s-1``, later tokens mod the ring span
``r = window - s``); nothing moves on eviction, a new token overwrites the
slot of the one it evicts. Eviction is framed by the stream length after
each write, exact for token-by-token decode; the engine keeps prefill
chunks at most ``r`` tokens long.

:class:`SinkKVCache` (model dtype) stores keys UNROTATED ``[L, B, W, Hkv,
D]`` and rotates the whole window to its window-relative positions (sinks
at ``0..s-1``, the oldest live window token at ``s``, the query on top) at
every attention: the gather path, no tail protocol, so the engine decodes
it one token per dispatch.

:class:`QuantizedSinkKVCache` (int8) keeps the position bookkeeping out of
the data: RoPE scores depend only on position differences, so ring keys
are stored rotated at their ABSOLUTE positions (written once) and the
query rotates at its absolute position too; only the sinks have compressed
positions, stored rotated at ``0..s-1`` and scored with a second query
rotated at the window-relative position. Ring planes ``[L, B, Hkv, TR, D]``
int8 (TR = ``r`` padded to 32) with ``[L, B, Hkv, TR]`` f32 scales, sink
planes ``[L, B, Hkv, 32, D]`` likewise, head-major like the int8 dense
cache. It has the write-behind tail of the fused K-step window: the step
on its kernel (``ops/quant_attention.py:sink_fused_decode_attention``, the
slots the in-flight tail has evicted masked in the kernel), the flush on
another (``sink_tail_flush``: tail token ``i`` to ring slot ``(ring_ptr + i
- skip) % r``), the sink-bound head of a stream merged in plain PyTorch.

**In place.** As the port's other caches: the planes and the lengths are
updated in place, methods return the cache or the layer state so call
sites read like the JAX ones.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple, Union

import torch

from ..ops.attention import causal_mask
from ..ops.rotary import RopeAngles, apply_rope, rope_cos_sin
from ..utils.device import resolve_device
from .base import GatherAttendMixin
from .dense import _DenseRowsMixin, _quantize_kv, _row_index


def _floor_div(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.div(a, n, rounding_mode="floor")


def _ring_sources(lengths, num_new, s: int, r: int, width: int):
    """For each of ``width`` ring slots, the chunk token that lands on it
    LAST and whether one does: ``(i, take)``, ``[B, width]`` each. Chunk
    token ``i`` has stream position ``lengths + i``; a position ``p >= s``
    goes to ring slot ``(p - s) % r``; slots at or past ``r`` take
    nothing."""
    t = torch.arange(width, dtype=torch.int32, device=lengths.device)[None, :]
    a = (lengths - s)[:, None]                   # negative in the sink phase
    cand = torch.remainder(t - a, r)
    n = num_new[:, None]
    i = cand + _floor_div(n - 1 - cand, r).clamp_min(0) * r
    take = (t < r) & (i < n) & (a + i >= 0)
    return i, take


def _sink_sources(lengths, num_new, s: int, width: int):
    """``(i, take)`` of the sink slots: slot ``j < s`` takes chunk token
    ``j - lengths`` when that token exists."""
    j = torch.arange(width, dtype=torch.int32, device=lengths.device)[None, :]
    i = j - lengths[:, None]
    return i, (j < s) & (i >= 0) & (i < num_new[:, None])


def _merge(buf, vals, idx, take, axis: int):
    """In place: slot ``w`` of ``buf`` (``[B, ...]``, slots along ``axis``)
    takes ``vals[.., idx[b, w], ..]`` where ``take[b, w]``; a gather and a
    select, no host synchronisation."""
    b, s, w = buf.shape[0], vals.shape[axis], buf.shape[axis]
    got = torch.gather(vals.to(buf.dtype), axis,
                       _row_index(b, axis, vals.shape, idx.clamp(0, s - 1)))
    sel = take.reshape([b] + [w if d == axis else 1 for d in range(1, buf.ndim)])
    buf.copy_(torch.where(sel, got, buf))
    return buf


def _merge_layers(buf, vals, idx, take):
    """:func:`_merge` over ``[L, B, Hkv, slots(, D)]`` planes, every layer
    in one gather and one select: ``idx``/``take`` ``[B, slots]`` are the
    same in each layer."""
    return _merge(buf.movedim(0, 1), vals.movedim(0, 1), idx, take, axis=3)


class SinkKVCache(GatherAttendMixin):
    """``k`` (unrotated) / ``v``: ``[L, B, W, Hkv, D]``; ``seen``: ``[B]``
    int32 stream length per row."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, seen: torch.Tensor,
                 num_sinks: int):
        self.k = k
        self.v = v
        self.seen = seen
        self.num_sinks = num_sinks

    @staticmethod
    def create(
        num_layers: int,
        batch: int,
        window_length: int,
        num_sink_tokens: int,
        num_kv_heads: int,
        head_dim: int,
        dtype=torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
    ) -> "SinkKVCache":
        if not 0 <= num_sink_tokens < window_length:
            raise ValueError("need 0 <= num_sink_tokens < window_length")
        dev = resolve_device(device)
        shape = (num_layers, batch, window_length, num_kv_heads, head_dim)
        return SinkKVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            seen=torch.zeros((batch,), dtype=torch.int32, device=dev),
            num_sinks=num_sink_tokens,
        )

    @property
    def device(self) -> torch.device:
        return self.seen.device

    @property
    def window(self) -> int:
        return self.k.shape[2]

    @property
    def max_len(self) -> int:
        """The ring's width, fixed: nothing grows."""
        return self.window

    @property
    def layer_stacks(self):
        return (self.k, self.v)

    # -- position bookkeeping -------------------------------------------------

    def _slot_positions(self, total: torch.Tensor):
        """Stream position held by each slot after ``total`` tokens (the
        latest write wins a slot) and whether it holds one: ``(pos [B, W],
        valid [B, W])``."""
        s, w = self.num_sinks, self.window
        slot = torch.arange(w, dtype=torch.int32, device=total.device)[None, :]
        n = total[:, None]
        rel = slot - s
        m = _floor_div(n - 1 - s - rel, w - s)
        pos = torch.where(slot < s, slot, s + rel + m.clamp_min(0) * (w - s))
        return pos, pos < n

    def _effective(self, pos: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
        """Window-relative position used for rotation: sinks keep
        ``0..s-1``, the oldest surviving window token sits at ``s``."""
        s, w = self.num_sinks, self.window
        oldest = torch.clamp_min(total - (w - s), s)
        if pos.ndim == 2 and total.ndim == 1:
            oldest = oldest[:, None]
        return torch.where(pos < s, pos, s + pos - oldest)

    # -- cache interface ------------------------------------------------------

    def q_positions(self, seq_len: int) -> torch.Tensor:
        """Absolute stream positions of the incoming tokens (causal
        masking, which stays exact under eviction)."""
        return self.seen[:, None] + torch.arange(
            seq_len, dtype=torch.int32, device=self.device)[None, :]

    def rope_positions(self, seq_len: int, num_new: torch.Tensor) -> torch.Tensor:
        """Window-relative positions at which the queries rotate."""
        return self._effective(self.q_positions(seq_len), self.seen + num_new)

    def fits(self, num_new) -> torch.Tensor:
        """Never overflows; a chunk must fit the ring span (engine
        contract)."""
        ok = torch.as_tensor(num_new, device=self.device) <= (
            self.window - self.num_sinks)
        return ok.expand(self.seen.shape)

    def update_and_gather(
        self,
        layer_state: Tuple[torch.Tensor, ...],
        q: torch.Tensor,
        k_new: torch.Tensor,
        v_new: torch.Tensor,
        rope: RopeAngles,
        q_pos: torch.Tensor,
        num_new: torch.Tensor,
        sliding_window: Optional[int] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """Write the unrotated k/v into their slots (in place), rotate the
        live keys to their window-relative positions, build the causal and
        liveness mask. ``sliding_window`` is ignored: the ring is the
        window policy."""
        layer_k, layer_v = layer_state
        s, w = self.num_sinks, self.window
        total = self.seen + num_new
        q_rot = apply_rope(q, rope.cos, rope.sin)
        si, stake = _sink_sources(self.seen, num_new, s, s)
        ri, rtake = _ring_sources(self.seen, num_new, s, w - s, w - s)
        idx, take = torch.cat([si, ri], 1), torch.cat([stake, rtake], 1)
        _merge(layer_k, k_new, idx, take, axis=1)
        _merge(layer_v, v_new, idx, take, axis=1)
        kv_pos, kv_live = self._slot_positions(total)
        cos_k, sin_k = rope_cos_sin(self._effective(kv_pos, total), rope.inv_freq)
        k_eff = apply_rope(layer_k, cos_k, sin_k)
        mask = causal_mask(q_pos, kv_pos, kv_live)
        return q_rot, k_eff, layer_v, mask, layer_state

    def advance(self, num_new: torch.Tensor):
        self.seen += num_new
        return self

    def reset_rows(self, row_mask: torch.Tensor):
        self.seen.masked_fill_(row_mask, 0)
        return self

    def select_row(self, row: int):
        """Batch-1 view of one row: its buffers are slices of this cache's
        (a prefill through it writes in place); ``seen`` is a copy that
        :meth:`merge_row` writes back."""
        view = copy.copy(self)
        view.k = self.k[:, row:row + 1]
        view.v = self.v[:, row:row + 1]
        view.seen = self.seen[row:row + 1].clone()
        return view

    def merge_row(self, sub, row: int):
        self.seen[row:row + 1] = sub.seen
        return self


class QuantizedSinkKVCache(_DenseRowsMixin):
    """The int8 ring plus sinks with the fused write-behind tail.

    ``k``/``v`` int8 ``[L, B, Hkv, TR, D]`` (keys rotated at absolute
    positions), ``ks``/``vs`` f32 ``[L, B, Hkv, TR]``; ``sk``/``sv``/
    ``sks``/``svs`` the sink planes ``[L, B, Hkv, 32(, D)]``; ``lengths``
    ``[B]`` the stream length per row (``seen`` in the model-dtype
    class). ``use_kernel``: the fused window's step and flush through
    their kernels (#11, #12)."""

    PLANE_FIELDS = ("k", "v", "ks", "vs", "sk", "sv", "sks", "svs")
    TIME_AXIS = 2
    SINK_PAD = 32

    def __init__(self, k, v, ks, vs, sk, sv, sks, svs, lengths,
                 num_sinks: int, ring_slots: int, use_kernel: bool = False):
        self.k, self.v, self.ks, self.vs = k, v, ks, vs
        self.sk, self.sv, self.sks, self.svs = sk, sv, sks, svs
        self.lengths = lengths
        self.num_sinks = num_sinks
        self.ring_slots = ring_slots
        self.use_kernel = use_kernel

    @staticmethod
    def create(
        num_layers: int,
        batch: int,
        window_length: int,
        num_sink_tokens: int,
        num_kv_heads: int,
        head_dim: int,
        dtype=torch.bfloat16,  # interface parity; values are int8
        use_kernel: bool = False,
        device: Union[str, torch.device] = "cuda",
    ) -> "QuantizedSinkKVCache":
        if not 0 <= num_sink_tokens < window_length:
            raise ValueError("need 0 <= num_sink_tokens < window_length")
        dev = resolve_device(device)
        r = window_length - num_sink_tokens
        tr = max(32, -(-r // 32) * 32)
        sp = QuantizedSinkKVCache.SINK_PAD
        shape = (num_layers, batch, num_kv_heads, tr, head_dim)
        sshape = (num_layers, batch, num_kv_heads, sp, head_dim)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=dev)

        return QuantizedSinkKVCache(
            zeros(shape, torch.int8), zeros(shape, torch.int8),
            zeros(shape[:-1], torch.float32), zeros(shape[:-1], torch.float32),
            zeros(sshape, torch.int8), zeros(sshape, torch.int8),
            zeros(sshape[:-1], torch.float32), zeros(sshape[:-1], torch.float32),
            zeros((batch,), torch.int32), num_sink_tokens, r, use_kernel,
        )

    # -- geometry -------------------------------------------------------------

    @property
    def window(self) -> int:
        return self.ring_slots + self.num_sinks

    @property
    def seen(self) -> torch.Tensor:
        """The model-dtype class's name for ``lengths``."""
        return self.lengths

    @property
    def kv_bytes_per_token(self) -> int:
        """Bytes a ring token holds over all layers: int8 K and V and
        their two f32 scales (the sink planes, 32 slots a row, come on
        top)."""
        l, _, h, _, d = self.k.shape
        return l * h * (2 * d + 8)

    def fits(self, num_new) -> torch.Tensor:
        """Never overflows; a chunk must fit the ring span (engine
        contract)."""
        ok = torch.as_tensor(num_new, device=self.device) <= self.ring_slots
        return ok.expand(self.lengths.shape)

    def grow_to(self, new_len: int):
        raise TypeError("the sink ring is fixed-size; nothing to grow")

    # -- position bookkeeping -------------------------------------------------

    def _ring_kv_positions(self, total: torch.Tensor):
        """Stream position held by each ring slot after ``total`` tokens
        (the latest write wins) and its liveness: ``(pos [B, TR], live)``."""
        s, r = self.num_sinks, self.ring_slots
        slot = torch.arange(self.max_len, dtype=torch.int32,
                            device=total.device)[None, :]
        n = total[:, None]
        m = _floor_div(n - 1 - s - slot, r)
        pos = s + slot + m.clamp_min(0) * r
        return pos, (slot < r) & (pos < n)

    def _eff_query(self, q, q_pos, total, inv_freq):
        """``q`` rotated at its window-relative position (for the sink
        scores): ``q_pos - (oldest - s)`` with ``oldest`` framed by
        ``total``."""
        s, r = self.num_sinks, self.ring_slots
        oldest = torch.clamp_min(total - r, s)
        cos, sin = rope_cos_sin(q_pos - (oldest - s)[:, None], inv_freq)
        return apply_rope(q, cos, sin)

    # -- writes ---------------------------------------------------------------

    def _ring_write(self, layer_buf, new_vals, num_new):
        """Incoming ``[B, S, Hkv(, D)]`` rows into the head-major ring
        ``[B, Hkv, TR(, D)]`` at their mod-``r`` slots, in place."""
        i, take = _ring_sources(self.lengths, num_new, self.num_sinks,
                                self.ring_slots, layer_buf.shape[2])
        return _merge(layer_buf, new_vals.movedim(1, 2), i, take, axis=2)

    def _sink_write(self, layer_buf, new_vals, num_new):
        """Sink slot ``j`` takes chunk token ``j - lengths`` when that token
        exists (its key rotated at its absolute position, which IS the sink
        slot)."""
        i, take = _sink_sources(self.lengths, num_new, self.num_sinks,
                                layer_buf.shape[2])
        return _merge(layer_buf, new_vals.movedim(1, 2), i, take, axis=2)

    # -- attention ------------------------------------------------------------

    def attend(self, layer_state, q, k_new, v_new, rope, q_pos, num_new,
               sliding_window, attention_fn, scale=None):
        """Prefill and per-step decode: quantize the chunk (keys rotated at
        absolute positions), write the ring (mod ``r``) and the sink
        (prefix) planes, then one joint softmax over the sink segment
        (window-relative query) and the ring. ``attention_fn`` and
        ``sliding_window`` are ignored, as in the JAX cache."""
        from ..ops.attention import gqa_attention_quantized_multi_q_segments

        lk, lv, lks, lvs, lsk, lsv, lsks, lsvs = layer_state
        s = self.num_sinks
        total = self.lengths + num_new
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        k_q, k_s = _quantize_kv(k_rot)
        v_q, v_s = _quantize_kv(v_new)
        for buf, vals in ((lk, k_q), (lv, v_q), (lks, k_s), (lvs, v_s)):
            self._ring_write(buf, vals, num_new)
        for buf, vals in ((lsk, k_q), (lsv, v_q), (lsks, k_s), (lsvs, v_s)):
            self._sink_write(buf, vals, num_new)
        q_eff = self._eff_query(q, q_pos, total, rope.inv_freq)
        kv_pos, kv_live = self._ring_kv_positions(total)
        ring_mask = causal_mask(q_pos, kv_pos, kv_live)
        sp = lsk.shape[2]
        sink_idx = torch.arange(sp, dtype=torch.int32,
                                device=q.device)[None, :].expand(q.shape[0], sp)
        sink_live = sink_idx < torch.clamp_max(total, s)[:, None]
        sink_mask = causal_mask(q_pos, sink_idx, sink_live)
        out = gqa_attention_quantized_multi_q_segments(
            [(q_eff, lsk, lsks, lsv, lsvs, sink_mask),
             (q_rot, lk, lks, lv, lvs, ring_mask)],
            scale,
        )
        return out, layer_state

    # -- write-behind tail (fused multi-step decode) --------------------------

    @property
    def tail_reads_whole_big(self) -> bool:
        """Kernel form: the planes pass whole, with the layer index."""
        return self.use_kernel

    @property
    def tail_in_kernel(self) -> bool:
        """Kernel form: the tail planes pass whole; the kernel quantizes
        the step's K/V into its layer's slot."""
        return self.use_kernel

    def tail_init(self, k_steps: int):
        """int8 ``[L, B, Hkv, K, D]`` planes and f32 ``[L, B, Hkv, K]``
        scales ``(k, v, ks, vs)``, four distinct tensors."""
        l, b, h, _, d = self.k.shape

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        return (zeros((l, b, h, k_steps, d), torch.int8),
                zeros((l, b, h, k_steps, d), torch.int8),
                zeros((l, b, h, k_steps), torch.float32),
                zeros((l, b, h, k_steps), torch.float32))

    def _tail_scalars(self, base_len, tail_len, num_new):
        """Per row: the live ring prefix, the ring's write pointer (its
        oldest slot), the ring slots evicted so far INCLUDING by this
        step's token (the post-append window is ``[total - r, total)`` with
        ``total = base + tail_len + num_new``; ``evict = tail_len`` would
        leave this step's victim attended), the valid sink slots and the
        valid tail slots."""
        s, r = self.num_sinks, self.ring_slots
        ring_len = (base_len - s).clamp(0, r)
        ring_ptr = torch.remainder((base_len - s).clamp_min(0), r)
        evict = tail_len + num_new
        return ring_len, ring_ptr, evict, base_len.clamp_max(s), evict

    def tail_attend(self, big_state, tail_state, q, k_new, v_new, rope,
                    base_len, tail_len, step_idx, num_new, sliding_window,
                    scale=None):
        """One layer of a fused step: three segments (sinks, ring, tail)
        under one softmax; the planes stay read-only, the step's K/V are
        quantized into tail slot ``step_idx`` in place (in the kernel with
        ``use_kernel``)."""
        q_pos = base_len + tail_len
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        # The sink query is framed at the post-step total (q_pos + 1), as
        # token-by-token decode frames it.
        q_eff = self._eff_query(q, q_pos[:, None], q_pos + 1, rope.inv_freq)
        ring_len, ring_ptr, evict, sink_len, vlen = self._tail_scalars(
            base_len, tail_len, num_new)
        tk, tv, tks, tvs = tail_state
        if self.use_kernel and q.shape[1] == 1:
            from ..ops.quant_attention import sink_fused_decode_attention

            bk, bv, bks, bvs, bsk, bsv, bsks, bsvs, lidx = big_state
            out, tk, tks, tv, tvs = sink_fused_decode_attention(
                q_rot, q_eff, k_rot, v_new, bk, bks, bv, bvs,
                bsk, bsks, bsv, bsvs, tk, tks, tv, tvs,
                layer_idx=lidx, step_idx=step_idx, ring_len=ring_len,
                ring_ptr=ring_ptr, evict_len=evict, sink_len=sink_len,
                tail_valid_len=vlen, ring_slots=self.ring_slots, scale=scale,
            )
            return out, (tk, tv, tks, tvs)
        from ..ops.attention import gqa_attention_quantized_multi_q_segments

        bk, bv, bks, bvs, bsk, bsv, bsks, bsvs = big_state   # [B, Hkv, T(, D)]
        k_q, k_s = _quantize_kv(k_rot)                       # [B, 1, Hkv(, D)]
        v_q, v_s = _quantize_kv(v_new)
        slot = step_idx.reshape(1).long()
        for buf, vals in ((tk, k_q), (tv, v_q), (tks, k_s), (tvs, v_s)):
            buf.index_copy_(2, slot, vals.transpose(1, 2))
        dev = q.device

        def arange(n):
            return torch.arange(n, dtype=torch.int32, device=dev)[None, :]

        ring = arange(bk.shape[2])
        dd = torch.remainder(ring - ring_ptr[:, None], self.ring_slots)
        ring_valid = (ring < ring_len[:, None]) & (dd >= evict[:, None])
        sink_valid = arange(bsk.shape[2]) < sink_len[:, None]
        tail_valid = arange(tk.shape[2]) < vlen[:, None]
        out = gqa_attention_quantized_multi_q_segments(
            [(q_eff, bsk, bsks, bsv, bsvs, sink_valid[:, None]),
             (q_rot, bk, bks, bv, bvs, ring_valid[:, None]),
             (q_rot, tk, tks, tv, tvs, tail_valid[:, None])],
            scale,
        )
        return out, (tk, tv, tks, tvs)

    def tail_flush(self, tail, tail_len):
        """Place the tail, in place: ring-bound tokens through the mod-ring
        flush (#12 with ``use_kernel``, a gather and a select otherwise),
        the sink-bound head of a young stream into the sink planes (a
        gather and a select a plane, all layers at once); then ``lengths``
        advances by ``tail_len``."""
        wk, wv, wks, wvs = tail                  # [L, B, Hkv, KT(, D)]
        s, r = self.num_sinks, self.ring_slots
        skip = (s - self.lengths).clamp(0, wk.shape[3])
        ring_ptr = torch.remainder((self.lengths - s).clamp_min(0), r)
        if self.use_kernel:
            from ..ops.quant_attention import sink_tail_flush

            sink_tail_flush(self.k, self.ks, self.v, self.vs, wk, wks, wv,
                            wvs, ring_ptr, skip, tail_len, r)
        else:
            for big, tl in ((self.k, wk), (self.ks, wks), (self.v, wv),
                            (self.vs, wvs)):
                self._ring_flush_rows(big, tl, tail_len, skip, ring_ptr)
        i, take = _sink_sources(self.lengths, tail_len, s, self.sk.shape[3])
        for big, tl in ((self.sk, wk), (self.sv, wv), (self.sks, wks),
                        (self.svs, wvs)):
            _merge_layers(big, tl, i, take)
        self.lengths += tail_len
        return self

    def _ring_flush_rows(self, big, tl_buf, tail_len, skip, ring_ptr):
        """Ring slot ``t`` takes the LAST live tail token that targets it
        (``i = skip + (t - ring_ptr) mod r``, plus whole turns of the
        ring)."""
        r = self.ring_slots
        t = torch.arange(big.shape[3], dtype=torch.int32,
                         device=big.device)[None, :]
        cand = skip[:, None] + torch.remainder(t - ring_ptr[:, None], r)
        n = tail_len[:, None]
        i = cand + _floor_div(n - 1 - cand, r).clamp_min(0) * r
        take = (t < r) & (i >= skip[:, None]) & (i < n)
        _merge_layers(big, tl_buf, i, take)
