"""Dense (contiguous, preallocated) KV caches in the model dtype and int8
(counterpart of the JAX package's ``cache/dense.py``).

Batch rows are independent sessions with their own write offsets
(``lengths``). The buffers are allocated at a width ``T`` (the engine starts
at the first rung of its window ladder and grows along it, ``grow_to``).

Layout:
    :class:`DenseKVCache`: ``k``/``v`` ``[L, B, T, Hkv, D]`` (keys stored
    rotated), time-major;
    :class:`QuantizedDenseKVCache`: int8 ``k``/``v`` ``[L, B, Hkv, T, D]``
    and f32 ``ks``/``vs`` ``[L, B, Hkv, T]``, HEAD-major, so that one (row,
    head)'s positions are a contiguous ``[T, D]`` tile the kernels read as
    they lie;
    ``lengths``: ``[B]`` int32 tokens cached per row.

**In place.** The JAX caches are immutable pytrees; here the buffers and
``lengths`` are updated IN PLACE, as the port's paged caches are: ``_write``
writes the layer buffer it is given, ``advance`` / ``reset_rows`` /
``merge_row(s)`` / ``grow_to`` / ``tail_flush`` mutate ``self`` (``grow_to``
replaces the buffers with wider ones). Methods still return the cache or
the layer state so call sites read like the JAX ones. ``select_row`` returns
a view whose buffers are slices of this cache's (a single-row prefill writes
straight into them); ``select_rows`` a gathered copy of the rows, which
``merge_rows`` writes back. Row arguments are host integers.

The write rules are the JAX caches': a single-token write (decode) goes to
each row's offset, clamped into the buffer as a dynamic update slice
clamps, and an inactive row (``num_new == 0``) writes its old value back,
i.e. nothing; a multi-token write (prefill, padded to a bucket that may run
past the buffer's end) rebuilds the buffer by a gather and a select, so
that position ``p`` takes incoming token ``p - lengths`` when that lies in
``[0, num_new)`` and nothing past ``T`` is ever written.

**Write-behind tail.** Both kinds carry the fused K-step window's tail
protocol (``tail_init`` / ``tail_attend`` / ``tail_flush``): each step's
K/V land in a small per-layer tail, attention runs over the read-only
buffers plus the tail under one softmax, and the tail is merged into the
buffers once per window. The int8 cache on its kernels (``use_kernel`` and
a width that is a multiple of 32) runs the step in one kernel call over its
own whole buffers (``ops/quant_attention.py:
quantized_fused_decode_attention``) and the merge in another
(``fused_tail_flush``); otherwise plain PyTorch does both.

The module also holds the int8 KV quantizer and the segment masks that the
paged caches share.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.attention import causal_mask
from ..ops.rotary import RopeAngles, apply_rope
from ..utils.device import resolve_device, to_device
from .base import GatherAttendMixin, flash_prefill_fn


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


def _row_index(b: int, axis: int, shape, values: torch.Tensor) -> torch.Tensor:
    """``values`` (``[B]`` or ``[B, W]``) as an int64 index over ``shape``
    (a ``[B, ...]`` buffer's) with its width along ``axis``."""
    shp = [1] * len(shape)
    shp[0] = b
    if values.ndim == 2:
        shp[axis] = values.shape[1]
    full = list(shape)
    full[axis] = shp[axis]
    return values.reshape(shp).long().expand(full)


def _write_rows(buf: torch.Tensor, nv: torch.Tensor, lengths: torch.Tensor,
                num_new: torch.Tensor, axis: int) -> torch.Tensor:
    """Merge incoming ``nv`` into ``buf`` at each row's offset, in place.
    Both are ``[B, ...]`` with their time axis (``S`` / ``T``) at ``axis``.
    The JAX ``_write``'s two regimes: one token at the clamped offset, the
    old value kept for an inactive row; or a gather and a select over the
    whole buffer."""
    b, s, t = buf.shape[0], nv.shape[axis], buf.shape[axis]
    nv = nv.to(buf.dtype)
    if s == 1:
        idx = _row_index(b, axis, buf.shape, lengths.clamp(0, t - 1))
        old = torch.gather(buf, axis, idx)
        keep = (num_new > 0).reshape([b] + [1] * (buf.ndim - 1))
        buf.scatter_(axis, idx, torch.where(keep, nv, old))
        return buf
    src = torch.arange(t, dtype=torch.int32, device=buf.device)[None, :] - (
        lengths[:, None])                              # [B, T]
    take = (src >= 0) & (src < num_new[:, None])
    gathered = torch.gather(
        nv, axis, _row_index(b, axis, nv.shape, src.clamp(0, s - 1))
    )
    sel = take.reshape([b] + [t if d == axis else 1 for d in range(1, buf.ndim)])
    buf.copy_(torch.where(sel, gathered, buf))
    return buf


def _tail_flush_rows(big, tail, lengths, tail_len, axis):
    """Merge a write-behind tail into the big buffer at per-row offsets, in
    place (counterpart of the JAX package's ``_tail_flush_rows``).

    ``big``/``tail``: ``[L, B, …]`` with the time axis (length ``T`` / ``K``)
    at per-row axis ``axis`` (coordinates of one layer's ``[B, …]`` view).
    Position ``p`` of row ``b`` takes tail slot ``p - lengths[b]`` when that
    lies in ``[0, tail_len[b])``; a gather and a select, one layer at a time
    so that the temporaries stay one layer large."""
    kk, t = tail.shape[axis + 1], big.shape[axis + 1]
    b = big.shape[1]
    src = torch.arange(t, dtype=torch.int32, device=big.device)[None, :] - (
        lengths[:, None])                              # [B, T]
    sel = ((src >= 0) & (src < tail_len[:, None])).reshape(
        [b] + [t if d == axis else 1 for d in range(1, big.ndim - 1)])
    idx = _row_index(b, axis, tail.shape[1:], src.clamp(0, kk - 1))
    for i in range(big.shape[0]):
        big[i].copy_(torch.where(sel, torch.gather(tail[i], axis, idx), big[i]))
    return big


class _DenseRowsMixin(GatherAttendMixin):
    """Shared row bookkeeping of the contiguous per-row caches: absolute
    positions from ``lengths``, bucket-safe writes, causal masking, row
    selection and growth. Subclasses name their planes (``PLANE_FIELDS``)
    and the time axis of one layer's ``[B, ...]`` buffer (``TIME_AXIS``)."""

    PLANE_FIELDS: Tuple[str, ...] = ()
    TIME_AXIS = 1

    @property
    def device(self) -> torch.device:
        return self.lengths.device

    @property
    def max_len(self) -> int:
        return getattr(self, self.PLANE_FIELDS[0]).shape[self.TIME_AXIS + 1]

    @property
    def layer_stacks(self):
        """The planes, ``[L, B, ...]`` each, in ``PLANE_FIELDS`` order."""
        return tuple(getattr(self, f) for f in self.PLANE_FIELDS)

    @property
    def window_anchor(self) -> torch.Tensor:
        """The tensor whose identity fixes this cache's shapes: a fused
        window (or a CUDA graph of its step) captured over the cache stays
        valid while it stands. Here the first buffer, which ``grow_to``
        replaces."""
        return getattr(self, self.PLANE_FIELDS[0])

    def q_positions(self, seq_len: int) -> torch.Tensor:
        """Absolute positions of the incoming tokens: ``[B, S]``."""
        return self.lengths[:, None] + torch.arange(
            seq_len, dtype=torch.int32, device=self.device
        )[None, :]

    def rope_positions(self, seq_len: int, num_new: torch.Tensor) -> torch.Tensor:
        return self.q_positions(seq_len)

    def fits(self, num_new) -> torch.Tensor:
        """Per row: can ``num_new`` more tokens be appended? The scheduler
        must check this before admitting tokens: past the buffer, writes
        are dropped."""
        return self.lengths + num_new <= self.max_len

    def advance(self, num_new: torch.Tensor):
        self.lengths += num_new
        return self

    def reset_rows(self, row_mask: torch.Tensor):
        """Zero the lengths of the rows in ``row_mask`` (slot reuse). Stale
        K/V need no clearing: validity derives from ``lengths``."""
        self.lengths.masked_fill_(row_mask, 0)
        return self

    def _view(self, planes, lengths):
        view = copy.copy(self)
        for name, plane in zip(self.PLANE_FIELDS, planes):
            setattr(view, name, plane)
        view.lengths = lengths
        return view

    def narrowed(self, width: int):
        """A view of every row's first ``width`` positions: its buffers are
        slices of this cache's (writes land in place) and its ``lengths``
        IS this cache's, so attention reads ``width`` positions while the
        buffers keep their size."""
        return self._view(
            [p.narrow(self.TIME_AXIS + 1, 0, width)
             for p in self.layer_stacks],
            self.lengths,
        )

    def select_row(self, row: int):
        """Batch-1 view of one row: its buffers are slices of this cache's,
        so a prefill through the view writes in place; ``lengths`` is a
        copy that :meth:`merge_row` writes back."""
        return self._view(
            [p[:, row:row + 1] for p in self.layer_stacks],
            self.lengths[row:row + 1].clone(),
        )

    def merge_row(self, sub, row: int):
        self.lengths[row:row + 1] = sub.lengths
        return self

    def select_rows(self, rows: Sequence[int]):
        """A compact copy of ``rows`` (host ints). Padding entries use an
        OUT-OF-RANGE row index: the gather clamps it (its ``num_new = 0``
        prefill writes nothing) and :meth:`merge_rows` drops it."""
        idx = to_device(
            np.minimum(np.asarray(rows, np.int64), self.lengths.shape[0] - 1),
            torch.int64, self.device,
        )
        return self._view(
            [p.index_select(1, idx) for p in self.layer_stacks],
            self.lengths.index_select(0, idx),
        )

    def merge_rows(self, sub, rows: Sequence[int]):
        """Write a :meth:`select_rows` copy back; out-of-range (padding)
        rows drop."""
        rows = np.asarray(rows, np.int64)
        keep = np.nonzero(rows < self.lengths.shape[0])[0]
        src = to_device(keep, torch.int64, self.device)
        dst = to_device(rows[keep], torch.int64, self.device)
        for mine, theirs in zip(self.layer_stacks, sub.layer_stacks):
            mine.index_copy_(1, dst, theirs.index_select(1, src))
        self.lengths.index_copy_(0, dst, sub.lengths.index_select(0, src))
        return self

    def grow_to(self, new_len: int):
        """Zero-pad every plane's time axis to ``new_len``: new, wider
        buffers replace the old ones (every window over them is void)."""
        if new_len <= self.max_len:
            return self
        for name in self.PLANE_FIELDS:
            old = getattr(self, name)
            shape = list(old.shape)
            shape[self.TIME_AXIS + 1] = new_len
            new = torch.zeros(shape, dtype=old.dtype, device=old.device)
            new.narrow(self.TIME_AXIS + 1, 0, old.shape[self.TIME_AXIS + 1]).copy_(old)
            setattr(self, name, new)
        return self

    def _write(self, layer_buf, new_vals, num_new):
        """Merge incoming ``[B, S, Hkv(, D)]`` rows into one layer's buffer
        at each row's offset (``lengths``), in place."""
        nv = new_vals if self.TIME_AXIS == 1 else new_vals.movedim(1, self.TIME_AXIS)
        return _write_rows(layer_buf, nv, self.lengths, num_new, self.TIME_AXIS)

    def _mask(self, q, q_pos, num_new, sliding_window):
        t = self.max_len
        kv_pos = torch.arange(t, dtype=torch.int32, device=self.device)[
            None, :].expand(q.shape[0], t)
        kv_valid = kv_pos < (self.lengths + num_new)[:, None]
        return causal_mask(q_pos, kv_pos, kv_valid, sliding_window)


class DenseKVCache(_DenseRowsMixin):
    """``k``/``v``: ``[L, B, T, Hkv, D]`` in the model dtype (keys stored
    rotated); ``lengths``: ``[B]``."""

    PLANE_FIELDS = ("k", "v")
    TIME_AXIS = 1

    def __init__(self, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor):
        self.k = k
        self.v = v
        self.lengths = lengths

    @staticmethod
    def create(
        num_layers: int,
        batch: int,
        max_seq_len: int,
        num_kv_heads: int,
        head_dim: int,
        dtype=torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
    ) -> "DenseKVCache":
        dev = resolve_device(device)
        shape = (num_layers, batch, max_seq_len, num_kv_heads, head_dim)
        return DenseKVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
        )

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
        """Rotate q/k, write k/v into this layer's ``[B, T, Hkv, D]``
        buffers, build the mask. Returns ``(q_rot, k_all, v_all, mask,
        layer_state)``; the buffers are the contiguous view."""
        layer_k, layer_v = layer_state
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        self._write(layer_k, k_rot, num_new)
        self._write(layer_v, v_new, num_new)
        mask = self._mask(q, q_pos, num_new, sliding_window)
        return q_rot, layer_k, layer_v, mask, layer_state

    # -- write-behind tail (fused multi-step decode) --------------------------

    def tail_init(self, k_steps: int):
        """Two distinct ``[L, B, K, Hkv, D]`` planes in the buffers' type."""
        l, b, _, h, d = self.k.shape
        return tuple(
            torch.zeros((l, b, k_steps, h, d), dtype=self.k.dtype,
                        device=self.device)
            for _ in range(2)
        )

    def tail_attend(self, big_state, tail_state, q, k_new, v_new, rope,
                    base_len, tail_len, step_idx, num_new, sliding_window,
                    scale=None):
        """Two-segment attention of one layer: the buffers stay read-only,
        the new token's k/v land in tail slot ``step_idx`` (in place)."""
        from ..ops.attention import gqa_attention_segments

        big_k, big_v = big_state
        tk, tv = tail_state
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        slot = step_idx.reshape(1).long()
        tk.index_copy_(1, slot, k_rot.to(tk.dtype))
        tv.index_copy_(1, slot, v_new.to(tv.dtype))
        big_valid, tail_valid = segment_valids(
            base_len, tail_len, num_new, big_k.shape[1], tk.shape[1],
            sliding_window,
        )
        out = gqa_attention_segments(
            q_rot, [(big_k, big_v, big_valid), (tk, tv, tail_valid)], scale,
        )
        return out, (tk, tv)

    def tail_flush(self, tail, tail_len):
        """Merge the tail into the buffers (each row's ``tail_len`` slots at
        its offset) and advance ``lengths``."""
        wk, wv = tail  # [L, B, K, Hkv, D]
        _tail_flush_rows(self.k, wk, self.lengths, tail_len, axis=1)
        _tail_flush_rows(self.v, wv, self.lengths, tail_len, axis=1)
        self.lengths += tail_len
        return self


class QuantizedDenseKVCache(_DenseRowsMixin):
    """Dense cache with int8 K/V and per-(token, head) f32 scales,
    head-major: ``k``/``v`` int8 ``[L, B, Hkv, T, D]``, ``ks``/``vs`` f32
    ``[L, B, Hkv, T]``.

    ``use_kernel``: decode steps through ``quantized_decode_attention``
    (#8) and, where the width is a multiple of 32, the fused window's step
    and flush through its kernels (#9, #10). Long prefills (``S >= 1024``,
    tiles permitting) take the gather path through the flash kernel
    (``cache/base.py:flash_prefill_fn``); other multi-token rows attend over
    the int8 buffers with the scales on the scores
    (``gqa_attention_quantized``)."""

    PLANE_FIELDS = ("k", "v", "ks", "vs")
    TIME_AXIS = 2

    def __init__(self, k, v, ks, vs, lengths, use_kernel: bool = False):
        self.k = k
        self.v = v
        self.ks = ks
        self.vs = vs
        self.lengths = lengths
        self.use_kernel = use_kernel

    @staticmethod
    def create(
        num_layers: int,
        batch: int,
        max_seq_len: int,
        num_kv_heads: int,
        head_dim: int,
        dtype=torch.bfloat16,  # interface parity; values are int8
        use_kernel: bool = False,
        device: Union[str, torch.device] = "cuda",
    ) -> "QuantizedDenseKVCache":
        dev = resolve_device(device)
        shape = (num_layers, batch, num_kv_heads, max_seq_len, head_dim)
        return QuantizedDenseKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            ks=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            vs=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
            use_kernel=use_kernel,
        )

    @property
    def _kernel_tail_ok(self) -> bool:
        """The kernel form of the fused window needs a 32-aligned width
        (the JAX kernel's whole-stack operands cannot pad; the engine's
        ladder widths always are); other widths keep the plain segments
        path end to end."""
        return self.use_kernel and self.max_len % 32 == 0

    @property
    def tail_reads_whole_big(self) -> bool:
        """Kernel form: the buffers pass whole, with the layer index."""
        return self._kernel_tail_ok

    @property
    def tail_in_kernel(self) -> bool:
        """Kernel form: the tail planes pass whole; the kernel quantizes
        the step's K/V into its layer's slot."""
        return self._kernel_tail_ok

    def attend(self, layer_state, q, k_new, v_new, rope, q_pos, num_new,
               sliding_window, attention_fn, scale=None):
        """The int8 buffers feed the attention directly, the scales on the
        scores: ``quantized_decode_attention`` for decode steps with
        ``use_kernel``, else ``gqa_attention_quantized``. A non-default
        ``attention_fn``, and long prefills (flash), take the dequantizing
        gather path."""
        from ..ops.attention import gqa_attention, gqa_attention_quantized

        if attention_fn is not gqa_attention:
            return GatherAttendMixin.attend(
                self, layer_state, q, k_new, v_new, rope, q_pos, num_new,
                sliding_window, attention_fn, scale,
            )
        flash = flash_prefill_fn(q.shape[1], layer_state[0].shape[2],
                                 attention_fn)
        if flash is not None:
            return GatherAttendMixin.attend(
                self, layer_state, q, k_new, v_new, rope, q_pos, num_new,
                sliding_window, flash, scale,
            )
        layer_k, layer_v, layer_ks, layer_vs = layer_state
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        self._write_quantized(layer_state, k_rot, v_new, num_new)
        if self.use_kernel and q.shape[1] == 1:
            from ..ops.quant_attention import quantized_decode_attention

            out = quantized_decode_attention(
                q_rot, layer_k, layer_ks, layer_v, layer_vs,
                self.lengths + num_new, scale, sliding_window,
            )
        else:
            mask = self._mask(q, q_pos, num_new, sliding_window)
            out = gqa_attention_quantized(
                q_rot, layer_k, layer_ks, layer_v, layer_vs, mask, scale
            )
        return out, layer_state

    def _write_quantized(self, layer_state, k_rot, v_new, num_new) -> None:
        """Quantize incoming ``[B, S, Hkv, D]`` K/V per (token, head) and
        write values and scales into the layer's four planes."""
        layer_k, layer_v, layer_ks, layer_vs = layer_state
        k_q, k_s = _quantize_kv(k_rot)
        v_q, v_s = _quantize_kv(v_new)
        self._write(layer_k, k_q, num_new)
        self._write(layer_v, v_q, num_new)
        self._write(layer_ks, k_s, num_new)
        self._write(layer_vs, v_s, num_new)

    def update_and_gather(self, layer_state, q, k_new, v_new, rope, q_pos,
                          num_new, sliding_window=None):
        """The gather path: values stored int8, returned DEQUANTIZED in q's
        type as time-major ``[B, T, Hkv, D]`` views of head-major products
        (``values.to(dt) * scales.to(dt)``, as the JAX cache does)."""
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        self._write_quantized(layer_state, k_rot, v_new, num_new)
        layer_k, layer_v, layer_ks, layer_vs = layer_state
        dt = q.dtype
        k_all = (layer_k.to(dt) * layer_ks[..., None].to(dt)).transpose(1, 2)
        v_all = (layer_v.to(dt) * layer_vs[..., None].to(dt)).transpose(1, 2)
        mask = self._mask(q, q_pos, num_new, sliding_window)
        return q_rot, k_all, v_all, mask, layer_state

    # -- write-behind tail (fused multi-step decode) --------------------------

    def tail_init(self, k_steps: int):
        """int8 ``[L, B, Hkv, K, D]`` planes and f32 ``[L, B, Hkv, K]``
        scales ``(k, v, ks, vs)``, four distinct tensors (both forms write
        them in place)."""
        l, b, h, _, d = self.k.shape
        dev = self.device
        return (
            torch.zeros((l, b, h, k_steps, d), dtype=torch.int8, device=dev),
            torch.zeros((l, b, h, k_steps, d), dtype=torch.int8, device=dev),
            torch.zeros((l, b, h, k_steps), dtype=torch.float32, device=dev),
            torch.zeros((l, b, h, k_steps), dtype=torch.float32, device=dev),
        )

    def tail_attend(self, big_state, tail_state, q, k_new, v_new, rope,
                    base_len, tail_len, step_idx, num_new, sliding_window,
                    scale=None):
        """One layer of a fused step. Kernel form: ``big_state`` is the
        whole buffers plus the layer index, ``tail_state`` the whole tail;
        one kernel call. Otherwise the layer's slices: the step's K/V
        quantized into tail slot ``step_idx``, the joint softmax in plain
        PyTorch."""
        from ..ops.attention import gqa_attention_quantized_segments

        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        tk, tv, tks, tvs = tail_state
        if self._kernel_tail_ok and q.shape[1] == 1:
            from ..ops.quant_attention import quantized_fused_decode_attention

            big_k, big_v, big_ks, big_vs, lidx = big_state
            out, tk, tks, tv, tvs = quantized_fused_decode_attention(
                q_rot, k_rot, v_new, big_k, big_ks, big_v, big_vs,
                tk, tks, tv, tvs, layer_idx=lidx, step_idx=step_idx,
                base_len=base_len, tail_valid_len=tail_len + num_new,
                q_positions=base_len + tail_len, scale=scale,
                sliding_window=sliding_window,
            )
            return out, (tk, tv, tks, tvs)
        big_k, big_v, big_ks, big_vs = big_state  # [B, Hkv, T(, D)]
        k_q, k_s = _quantize_kv(k_rot)            # [B, 1, Hkv(, D)]
        v_q, v_s = _quantize_kv(v_new)
        slot = step_idx.reshape(1).long()
        tk.index_copy_(2, slot, k_q.transpose(1, 2))
        tv.index_copy_(2, slot, v_q.transpose(1, 2))
        tks.index_copy_(2, slot, k_s.transpose(1, 2))
        tvs.index_copy_(2, slot, v_s.transpose(1, 2))
        big_valid, tail_valid = segment_valids(
            base_len, tail_len, num_new, big_k.shape[2], tk.shape[2],
            sliding_window,
        )
        out = gqa_attention_quantized_segments(
            q_rot,
            [(big_k, big_ks, big_v, big_vs, big_valid),
             (tk, tks, tv, tvs, tail_valid)],
            scale,
        )
        return out, (tk, tv, tks, tvs)

    def tail_flush(self, tail, tail_len):
        """Merge each row's ``tail_len`` tail slots into the buffers at its
        offset (the flush kernel, #10, in the kernel form) and advance
        ``lengths``."""
        wk, wv, wks, wvs = tail  # [L, B, Hkv, K(, D)]
        if self._kernel_tail_ok:
            from ..ops.quant_attention import fused_tail_flush

            fused_tail_flush(self.k, self.ks, self.v, self.vs, wk, wks, wv,
                             wvs, self.lengths, tail_len)
        else:
            for big, tl in ((self.k, wk), (self.v, wv), (self.ks, wks),
                            (self.vs, wvs)):
                _tail_flush_rows(big, tl, self.lengths, tail_len, axis=2)
        self.lengths += tail_len
        return self
