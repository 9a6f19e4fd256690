"""Paged KV cache: fixed page pool + per-session page tables (counterpart of
the JAX package's ``cache/paged.py``).

Sessions own rows of a ``page_table``; pages are allocated and freed on the
host by the scheduler (``engine/engine.py``) through :class:`PageAllocator`.

Layout:
    ``k_pages``/``v_pages``: ``[L, num_pages, Hkv, page_size, D]`` (keys
    rotated; head-major within a page, so one head's slots of a page are a
    contiguous ``[page_size, D]`` tile)
    ``page_table``: ``[B, table_width]`` int32 page ids
    ``lengths``: ``[B]`` int32 tokens currently cached per session row

``QuantizedPagedKVCache`` holds int8 ``k_pages``/``v_pages`` and two f32
``[L, num_pages, Hkv, page_size]`` scale planes ``ks_pages``/``vs_pages``.

Page 0 is the NULL page: never allocated to a session, absorbing writes from
padding tokens and unallocated table slots, so a misconfigured row can never
corrupt another session's pages. Nothing reads page 0 as live content.

**In place.** The JAX cache is an immutable pytree and every method returns a
new one. Here the page pool, the page table and the lengths are updated IN
PLACE: ``_scatter`` writes into the pool it is given, ``advance`` /
``reset_rows`` / ``assign_pages*`` / ``merge_row(s)`` mutate ``self``. Methods
still return the cache (or the layer state) so call sites read like the JAX
ones. ``select_row(s)`` returns a small view object that SHARES the pool and
owns copies of its rows' table and lengths; ``merge_row(s)`` writes only
those two back. Row arguments are host integers: the port runs eagerly, so
there is no traced index to keep on the device.

**Write-behind tail.** The fused K-step decode window
(``models/llama.py:multi_decode_apply``) keeps the pool read-only for K
steps: each step's K/V lands in a small per-layer tail (``tail_init``),
attention runs over the pool plus the tail (``tail_attend``), and
``tail_flush`` writes the tail into the pages once per window. The tail is
updated in place, and its slot index ``step_idx`` is a device tensor, so
that one captured step serves the whole window.
"""

from __future__ import annotations

import collections
import copy
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.attention import causal_mask
from ..ops.rotary import RopeAngles, apply_rope
from ..utils.device import resolve_device, to_device
from .base import GatherAttendMixin, flash_prefill_fn
from .dense import _quantize_kv, segment_valids


class PagedKVCache(GatherAttendMixin):
    def __init__(
        self,
        k_pages: torch.Tensor,
        v_pages: torch.Tensor,
        page_table: torch.Tensor,
        lengths: torch.Tensor,
        page_size: int,
        use_kernel: bool = False,
        use_ragged: bool = False,
    ):
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.page_table = page_table
        self.lengths = lengths
        self.page_size = page_size
        # Decode rows (S == 1) through ops/paged_attention.py.
        self.use_kernel = use_kernel
        # Multi-token rows (prefill / chunked prefill) through
        # ops/ragged_attention.py.
        self.use_ragged = use_ragged

    @staticmethod
    def create(
        num_layers: int,
        batch: int,
        num_pages: int,
        page_size: int,
        max_pages_per_session: int,
        num_kv_heads: int,
        head_dim: int,
        dtype=torch.bfloat16,
        use_kernel: bool = False,
        use_ragged: bool = False,
        device: Union[str, torch.device] = "cuda",
    ) -> "PagedKVCache":
        dev = resolve_device(device)
        shape = (num_layers, num_pages, num_kv_heads, page_size, head_dim)
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=dtype, device=dev),
            v_pages=torch.zeros(shape, dtype=dtype, device=dev),
            page_table=torch.zeros(
                (batch, max_pages_per_session), dtype=torch.int32, device=dev
            ),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
            page_size=page_size,
            use_kernel=use_kernel,
            use_ragged=use_ragged,
        )

    def _view(self, page_table, lengths) -> "PagedKVCache":
        """A cache of the same kind over the SAME planes with its own table
        and lengths."""
        view = copy.copy(self)
        view.page_table = page_table
        view.lengths = lengths
        return view

    @property
    def device(self) -> torch.device:
        return self.page_table.device

    @property
    def max_len(self) -> int:
        return self.page_table.shape[1] * self.page_size

    @property
    def window_anchor(self) -> torch.Tensor:
        """The tensor whose identity fixes this cache's shapes: a fused
        window (or a CUDA graph of its step) captured over the cache stays
        valid while it stands. Here the page table, which a widening or a
        shrink replaces (the pool never moves)."""
        return self.page_table

    # Plane name -> attribute, as in the JAX package (``kv_bytes_per_token``
    # counts every plane).
    PLANE_FIELDS = {"k": "k_pages", "v": "v_pages"}

    @property
    def layer_stacks(self):
        """The planes, ``[L, ...]`` each. (The JAX cache's
        ``with_layer_stacks`` has no counterpart: the planes are updated in
        place, so there is nothing to put back.)"""
        return tuple(getattr(self, f) for f in self.PLANE_FIELDS.values())

    def q_positions(self, seq_len: int) -> torch.Tensor:
        return self.lengths[:, None] + torch.arange(
            seq_len, dtype=torch.int32, device=self.device
        )[None, :]

    def rope_positions(self, seq_len: int, num_new: torch.Tensor) -> torch.Tensor:
        return self.q_positions(seq_len)

    def fits(self, num_new) -> torch.Tensor:
        """Scheduler contract: the row has table room for ``num_new`` more
        tokens (the scheduler must also have mapped the pages)."""
        return self.lengths + num_new <= self.max_len

    def _slot_pages(self, q_pos: torch.Tensor, num_new: torch.Tensor):
        """Map incoming tokens' absolute positions ``[B, S]`` →
        ``(physical page, in-page offset)``, both ``[B, S]`` int64.

        Inactive rows / padding positions (``>= num_new``) and out-of-range
        table slots divert to the NULL page 0 — an inactive slot's old pages
        may already belong to ANOTHER session (freed + reallocated), so a
        write there would corrupt it.
        """
        s = q_pos.shape[1]
        width = self.page_table.shape[1]
        table_slot = torch.div(q_pos, self.page_size, rounding_mode="floor")
        offset = q_pos % self.page_size
        in_range = (
            torch.arange(s, dtype=torch.int32, device=q_pos.device)[None, :]
            < num_new[:, None]
        ) & (table_slot < width)
        phys = torch.gather(
            self.page_table, 1, table_slot.clamp(0, width - 1).long()
        )
        return torch.where(in_range, phys, 0).long(), offset.long()

    def _scatter(
        self,
        layer_k: torch.Tensor,
        layer_v: torch.Tensor,
        k_rot: torch.Tensor,
        v_new: torch.Tensor,
        q_pos: torch.Tensor,
        num_new: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Write rotated k / raw v INTO the page pool at each incoming
        token's (physical page, offset) per the row's page table. Padding
        tokens all land on page 0 (duplicate indices there: any of them may
        win, and nothing reads that page as live)."""
        b, s, hkv, d = k_rot.shape
        phys_page, offset = self._slot_pages(q_pos, num_new)
        flat_page = phys_page.reshape(-1)
        flat_off = offset.reshape(-1)
        # Pool is [P, Hkv, PS, D]: advanced indices (page, offset) around the
        # head slice put the broadcast dim first → values are [N, Hkv, D].
        layer_k[flat_page, :, flat_off] = k_rot.reshape(b * s, hkv, d).to(
            layer_k.dtype
        )
        layer_v[flat_page, :, flat_off] = v_new.reshape(b * s, hkv, d).to(
            layer_v.dtype
        )
        return layer_k, layer_v

    def attend(
        self,
        layer_state,
        q,
        k_new,
        v_new,
        rope,
        q_pos,
        num_new,
        sliding_window,
        attention_fn,
        scale=None,
    ):
        """Multi-token rows with ``use_ragged`` and decode steps with
        ``use_kernel``: scatter into the pool, then run the kernel wrapper
        over the pages in place — no contiguous gather. Everything else uses
        the default gather + ``attention_fn`` (``GatherAttendMixin``)."""
        s = q.shape[1]
        if not ((self.use_ragged and s > 1) or (self.use_kernel and s == 1)):
            return super().attend(
                layer_state, q, k_new, v_new, rope, q_pos, num_new,
                sliding_window, attention_fn, scale,
            )
        layer_k, layer_v = layer_state
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        self._scatter(layer_k, layer_v, k_rot, v_new, q_pos, num_new)
        kv_lengths = self.lengths + num_new
        if s > 1:
            from ..ops.ragged_attention import ragged_paged_attention

            out = ragged_paged_attention(
                q_rot, layer_k, layer_v, self.page_table, kv_lengths,
                num_new, scale=scale, sliding_window=sliding_window,
            )
        else:
            from ..ops.paged_attention import paged_attention

            out = paged_attention(
                q_rot, layer_k, layer_v, self.page_table, kv_lengths,
                scale=scale, sliding_window=sliding_window,
            )
        return out, (layer_k, layer_v)

    # -- write-behind tail (fused multi-step decode) --------------------------
    #
    # Kernel-only, as in the JAX package: the engine gates the tail on
    # use_kernel for this cache. The pool segment runs the paged kernel with
    # its softmax stats, merged with the tail under one softmax.

    def tail_init(self, k_steps: int):
        """Two distinct ``[L, B, K, Hkv, D]`` planes in the pool's type."""
        l, _, hkv, _, d = self.k_pages.shape
        shape = (l, self.page_table.shape[0], k_steps, hkv, d)
        return tuple(
            torch.zeros(shape, dtype=self.k_pages.dtype, device=self.device)
            for _ in range(2)
        )

    def tail_attend(self, big_state, tail_state, q, k_new, v_new, rope,
                    base_len, tail_len, step_idx, num_new, sliding_window,
                    scale=None):
        """One layer of a fused step: the rotated K and V into tail slot
        ``step_idx`` (``[B, K, Hkv, D]`` planes of this layer, in place),
        the pool segment through :func:`paged_attention` with its stats, the
        tail merged by ``merge_softmax_segments``."""
        from ..ops.attention import merge_softmax_segments
        from ..ops.paged_attention import paged_attention

        pool_k, pool_v = big_state
        tk, tv = tail_state
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        slot = step_idx.reshape(1).long()
        tk.index_copy_(1, slot, k_rot.to(tk.dtype))
        tv.index_copy_(1, slot, v_new.to(tv.dtype))

        q_pos = base_len + tail_len
        out_pool, m_pool, l_pool = paged_attention(
            q_rot, pool_k, pool_v, self.page_table, base_len,
            scale=scale, sliding_window=sliding_window,
            q_positions=q_pos, return_stats=True,
        )
        slots = torch.arange(tk.shape[1], dtype=torch.int32,
                             device=self.device)[None, :]
        tail_valid = slots < (tail_len + num_new)[:, None]
        if sliding_window is not None:
            tail_valid &= base_len[:, None] + slots > (
                q_pos[:, None] - sliding_window)
        out = merge_softmax_segments(
            q_rot, out_pool, m_pool, l_pool, tk, tv, tail_valid, scale
        )
        return out, (tk, tv)

    def tail_flush(self, tail, tail_len):
        """Write each row's ``tail_len`` tail slots into its pages (the
        prefill scatter, one layer at a time) and advance ``lengths``."""
        wk, wv = tail  # [L, B, K, Hkv, D]
        q_pos = self.lengths[:, None] + torch.arange(
            wk.shape[2], dtype=torch.int32, device=self.device)[None, :]
        for i in range(wk.shape[0]):
            self._scatter(self.k_pages[i], self.v_pages[i], wk[i], wv[i],
                          q_pos, tail_len)
        self.lengths += tail_len
        return self

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
        """Scatter new k/v into pages; gather each row's pages for attention.

        ``layer_state``: ``(layer_k, layer_v)``, each ``[P, Hkv, page_size,
        D]`` (one layer). The gather materializes
        ``[B, table_width * page_size, …]`` per layer — the correctness
        baseline the kernels are held against.
        """
        from ..ops.paged_attention import gather_pages

        layer_k, layer_v = layer_state
        b = k_new.shape[0]
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        self._scatter(layer_k, layer_v, k_rot, v_new, q_pos, num_new)

        # Slot i of the view holds absolute position i because table slots
        # are position-ordered.
        k_all = gather_pages(layer_k, self.page_table)
        v_all = gather_pages(layer_v, self.page_table)
        kv_pos = torch.arange(
            self.max_len, dtype=torch.int32, device=self.device
        )[None, :].expand(b, self.max_len)
        kv_valid = kv_pos < (self.lengths + num_new)[:, None]
        mask = causal_mask(q_pos, kv_pos, kv_valid, sliding_window)
        return q_rot, k_all, v_all, mask, (layer_k, layer_v)

    def advance(self, num_new: torch.Tensor) -> "PagedKVCache":
        self.lengths += num_new
        return self

    def reset_rows(self, row_mask: torch.Tensor) -> "PagedKVCache":
        """Clear sessions (host frees their pages via the allocator)."""
        self.lengths.masked_fill_(row_mask, 0)
        self.page_table.masked_fill_(row_mask[:, None], 0)
        return self

    def select_row(self, row: int) -> "PagedKVCache":
        """Batch-1 view: a copy of the row's page table/length over the
        SHARED page pool, so a single-row prefill writes straight into the
        pool."""
        return self._view(
            self.page_table[row : row + 1].clone(),
            self.lengths[row : row + 1].clone(),
        )

    def merge_row(self, sub: "PagedKVCache", row: int) -> "PagedKVCache":
        self.page_table[row : row + 1] = sub.page_table
        self.lengths[row : row + 1] = sub.lengths
        return self

    def select_rows(self, rows: Sequence[int]) -> "PagedKVCache":
        """Compact multi-row view for the batched-admission prefill. Padding
        entries are out-of-range rows, clamped here and dropped on merge. A
        clamped padding row's table is harmless: its ``num_new = 0`` prefill
        diverts every write to the null page."""
        idx = to_device(
            np.minimum(np.asarray(rows, np.int64), self.lengths.shape[0] - 1),
            torch.int64, self.device,
        )
        return self._view(
            self.page_table.index_select(0, idx),
            self.lengths.index_select(0, idx),
        )

    def merge_rows(self, sub: "PagedKVCache", rows: Sequence[int]):
        """Write the view's table rows and lengths back; out-of-range
        (padding) rows drop. The pool needs no merge: the view wrote into
        it."""
        rows = np.asarray(rows, np.int64)
        keep = np.nonzero(rows < self.lengths.shape[0])[0]
        src = to_device(keep, torch.int64, self.device)
        dst = to_device(rows[keep], torch.int64, self.device)
        self.page_table.index_copy_(0, dst, sub.page_table.index_select(0, src))
        self.lengths.index_copy_(0, dst, sub.lengths.index_select(0, src))
        return self

    def assign_pages(self, row: int, pages, start_slot: int = 0) -> "PagedKVCache":
        """Install allocator-chosen page ids for a row, from ``start_slot``."""
        pages = torch.as_tensor(pages, dtype=torch.int32, device=self.device)
        self.page_table[row, start_slot : start_slot + pages.shape[0]] = pages
        return self

    def assign_pages_batch(self, rows, slots, pages) -> "PagedKVCache":
        """Install N (row, slot) ← page mappings in one scatter."""
        dev = self.device
        self.page_table[
            to_device(rows, torch.int64, dev), to_device(slots, torch.int64, dev),
        ] = to_device(pages, torch.int32, dev)
        return self


class QuantizedPagedKVCache(PagedKVCache):
    """Page pool with int8 K/V + per-(slot, head) f32 scale planes
    (counterpart of the JAX package's ``QuantizedPagedKVCache``).

    Decode reads every live page each step, so int8 pages halve the pool's
    bytes. Scales ride separate ``[L, P, Hkv, PS]`` planes; the kernels
    apply them to the scores and probabilities (``q·(k·s) = s·(q·k)``), so
    the int8 pages are read as they are, and the gather path dequantizes its
    contiguous view in the model dtype. New K/V are quantized per (token,
    head) on the way in (``cache/dense.py:_quantize_kv``). The planes are
    updated in place, so ``merge_row(s)`` (inherited) writes only the table
    and lengths back, and ``select_row(s)`` views carry all four planes.
    """

    PLANE_FIELDS = {
        "k": "k_pages", "v": "v_pages", "ks": "ks_pages", "vs": "vs_pages",
    }

    def __init__(
        self,
        k_pages: torch.Tensor,
        v_pages: torch.Tensor,
        ks_pages: torch.Tensor,
        vs_pages: torch.Tensor,
        page_table: torch.Tensor,
        lengths: torch.Tensor,
        page_size: int,
        use_kernel: bool = False,
        use_ragged: bool = False,
    ):
        super().__init__(k_pages, v_pages, page_table, lengths, page_size,
                         use_kernel, use_ragged)
        self.ks_pages = ks_pages
        self.vs_pages = vs_pages

    @staticmethod
    def create(
        num_layers: int,
        batch: int,
        num_pages: int,
        page_size: int,
        max_pages_per_session: int,
        num_kv_heads: int,
        head_dim: int,
        dtype=torch.bfloat16,  # interface parity; values are int8
        use_kernel: bool = False,
        use_ragged: bool = False,
        device: Union[str, torch.device] = "cuda",
    ) -> "QuantizedPagedKVCache":
        dev = resolve_device(device)
        shape = (num_layers, num_pages, num_kv_heads, page_size, head_dim)
        return QuantizedPagedKVCache(
            k_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            v_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            ks_pages=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            vs_pages=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            page_table=torch.zeros(
                (batch, max_pages_per_session), dtype=torch.int32, device=dev
            ),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
            page_size=page_size,
            use_kernel=use_kernel,
            use_ragged=use_ragged,
        )

    def _scatter_q(self, layer_k, layer_v, layer_ks, layer_vs, k_rot, v_new,
                   q_pos, num_new):
        """Quantize incoming k/v, then the :meth:`_scatter` write pattern
        over the four planes."""
        k_q, k_s = _quantize_kv(k_rot)
        v_q, v_s = _quantize_kv(v_new)
        return self._scatter_planes(
            layer_k, layer_v, layer_ks, layer_vs, k_q, v_q, k_s, v_s, q_pos,
            num_new,
        )

    def _scatter_planes(self, layer_k, layer_v, layer_ks, layer_vs,
                        k_q, v_q, k_s, v_s, q_pos, num_new):
        """Scatter PRE-QUANTIZED ``[B, S, Hkv(, D)]`` values + scales INTO
        the pool planes (padding tokens land on the null page)."""
        b, s, hkv, d = k_q.shape
        phys_page, offset = self._slot_pages(q_pos, num_new)
        flat_page = phys_page.reshape(-1)
        flat_off = offset.reshape(-1)
        layer_k[flat_page, :, flat_off] = k_q.reshape(b * s, hkv, d)
        layer_v[flat_page, :, flat_off] = v_q.reshape(b * s, hkv, d)
        layer_ks[flat_page, :, flat_off] = k_s.reshape(b * s, hkv)
        layer_vs[flat_page, :, flat_off] = v_s.reshape(b * s, hkv)
        return layer_k, layer_v, layer_ks, layer_vs

    def attend(self, layer_state, q, k_new, v_new, rope, q_pos, num_new,
               sliding_window, attention_fn, scale=None):
        """Multi-token rows with ``use_ragged`` and decode steps with
        ``use_kernel``: quantize and scatter into the pool, then the int8
        kernel wrapper over the pages in place. Everything else takes the
        gather path (dequantized view + ``attention_fn``)."""
        s = q.shape[1]
        if not ((self.use_ragged and s > 1) or (self.use_kernel and s == 1)):
            # Long prefill: flash over the dequantized pool view (the
            # full-score path dominates from S ~ 1k).
            flash = flash_prefill_fn(s, self.max_len, attention_fn)
            if flash is not None:
                attention_fn = flash
            return GatherAttendMixin.attend(
                self, layer_state, q, k_new, v_new, rope, q_pos, num_new,
                sliding_window, attention_fn, scale,
            )
        lk, lv, lks, lvs = layer_state
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        self._scatter_q(lk, lv, lks, lvs, k_rot, v_new, q_pos, num_new)
        kv_lengths = self.lengths + num_new
        if s > 1:
            from ..ops.ragged_attention import quantized_ragged_paged_attention

            out = quantized_ragged_paged_attention(
                q_rot, lk, lks, lv, lvs, self.page_table, kv_lengths,
                num_new, scale=scale, sliding_window=sliding_window,
            )
        else:
            from ..ops.paged_attention import quantized_paged_attention

            out = quantized_paged_attention(
                q_rot, lk, lks, lv, lvs, self.page_table, kv_lengths,
                scale=scale, sliding_window=sliding_window,
            )
        return out, layer_state

    # -- write-behind tail ----------------------------------------------------
    #
    # The fused window's two forms, as in the JAX package. Below INPLACE_CTX
    # of table capacity, each row's pages are gathered once per window into
    # contiguous head-major stacks (``tail_big_stacks``), which every step
    # reads; from INPLACE_CTX on, every step reads the pool in place. With
    # the kernels, both forms keep an int8 tail that each step's kernel
    # quantizes into (#9 over the stacks, #6 over the pool) and the flush
    # kernel (#7) writes into the pages; without them, a bf16 tail, the
    # joint softmax in plain PyTorch, and the quantizing scatter at flush.

    #: Table capacity (table width x page size) from which the kernel form
    #: reads the pool in place instead of gathering it per window. The JAX
    #: package's value, measured on its TPU; the port keeps it so that it
    #: runs the reference's program (re-tuning it for the card is open).
    INPLACE_CTX = 768

    @property
    def _fused_inplace(self) -> bool:
        return self.use_kernel and self.max_len >= self.INPLACE_CTX

    def tail_big_stacks(self, out=None):
        """Read-only big planes for the fused window, ``(k, v, ks, vs)``:
        from ``INPLACE_CTX`` on the pool planes themselves; below it a
        contiguous head-major gather of every row's table span, ``[L, B,
        Hkv, T*PS, D]`` int8 and ``[L, B, Hkv, T*PS]`` f32 (unmapped slots
        read the null page, masked by ``pos < base_len``). ``out``: planes
        of that shape from an earlier call to gather into, so that their
        storage (which a CUDA graph captured) is kept."""
        planes = (self.k_pages, self.v_pages, self.ks_pages, self.vs_pages)
        if self._fused_inplace:
            return planes
        table = self.page_table.long()
        b, t = table.shape

        def g(pages):  # [L, P, H, PS(, D)] -> [L, B, H, T*PS(, D)]
            v = pages[:, table]                       # [L, B, T, H, PS(, D)]
            v = v.transpose(2, 3)                     # [L, B, H, T, PS(, D)]
            return v.reshape(v.shape[0], b, v.shape[2], t * v.shape[4],
                             *v.shape[5:])

        if out is None:
            return tuple(g(p) for p in planes)
        for dst, p in zip(out, planes):
            dst.copy_(g(p))
        return out

    @property
    def _kernel_tail_ok(self) -> bool:
        """The kernel forms: in place, or gathered with a capacity that is a
        multiple of 32 (the JAX kernel's io-aliased stacks cannot pad; the
        port keeps the same switch). Other capacities take the plain
        segments path."""
        return self.use_kernel and (
            self._fused_inplace or self.max_len % 32 == 0
        )

    @property
    def tail_reads_whole_big(self) -> bool:
        """Kernel forms: the big planes pass whole, with the layer index."""
        return self._kernel_tail_ok

    @property
    def tail_in_kernel(self) -> bool:
        """Kernel forms: the tail planes pass whole; the kernel writes its
        layer's slot."""
        return self._kernel_tail_ok

    def tail_init(self, k_steps: int):
        """Kernel forms: int8 ``[L, B, Hkv, K, D]`` planes and f32 ``[L, B,
        Hkv, K]`` scales ``(k, v, ks, vs)``, quantized in the kernel as the
        pool is. Otherwise bf16 ``(k, v)``, quantized at flush."""
        l, _, hkv, _, d = self.k_pages.shape
        b = self.page_table.shape[0]
        dev = self.device
        if self._kernel_tail_ok:
            return (
                torch.zeros((l, b, hkv, k_steps, d), dtype=torch.int8, device=dev),
                torch.zeros((l, b, hkv, k_steps, d), dtype=torch.int8, device=dev),
                torch.zeros((l, b, hkv, k_steps), dtype=torch.float32, device=dev),
                torch.zeros((l, b, hkv, k_steps), dtype=torch.float32, device=dev),
            )
        shape = (l, b, hkv, k_steps, d)
        return tuple(
            torch.zeros(shape, dtype=torch.bfloat16, device=dev)
            for _ in range(2)
        )

    def tail_attend(self, big_state, tail_state, q, k_new, v_new, rope,
                    base_len, tail_len, step_idx, num_new, sliding_window,
                    scale=None):
        """One layer of a fused step. Kernel forms: ``big_state`` is the
        whole big planes plus the layer index, ``tail_state`` the whole
        tail; one kernel call (#6 in place, #9 gathered). Otherwise the
        layer's gathered slices and bf16 tail, plain PyTorch."""
        from ..ops.attention import gqa_attention_quantized_segments

        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        if self._kernel_tail_ok and q.shape[1] == 1:
            gk, gv, gks, gvs, lidx = big_state
            tk, tv, tks, tvs = tail_state
            kw = dict(
                layer_idx=lidx, step_idx=step_idx, base_len=base_len,
                tail_valid_len=tail_len + num_new,
                q_positions=base_len + tail_len,
                scale=scale, sliding_window=sliding_window,
            )
            if self._fused_inplace:
                from ..ops.paged_attention import (
                    quantized_paged_fused_attention,
                )

                out, ntk, ntks, ntv, ntvs = quantized_paged_fused_attention(
                    q_rot, k_rot, v_new, gk, gks, gv, gvs, tk, tks, tv, tvs,
                    page_table=self.page_table, **kw,
                )
            else:
                from ..ops.quant_attention import (
                    quantized_fused_decode_attention,
                )

                out, ntk, ntks, ntv, ntvs = quantized_fused_decode_attention(
                    q_rot, k_rot, v_new, gk, gks, gv, gvs, tk, tks, tv, tvs,
                    **kw,
                )
            return out, (ntk, ntv, ntks, ntvs)
        gk, gv, gks, gvs = big_state   # [B, Hkv, Tmax(, D)] of this layer
        tk, tv = tail_state            # [B, Hkv, K, D] bf16
        slot = step_idx.reshape(1).long()
        tk.index_copy_(2, slot, k_rot.transpose(1, 2).to(tk.dtype))
        tv.index_copy_(2, slot, v_new.transpose(1, 2).to(tv.dtype))
        big_valid, tail_valid = segment_valids(
            base_len, tail_len, num_new, gk.shape[2], tk.shape[2],
            sliding_window,
        )
        ones = torch.ones(tk.shape[:3], dtype=torch.float32, device=self.device)
        out = gqa_attention_quantized_segments(
            q_rot,
            [(gk, gks, gv, gvs, big_valid), (tk, ones, tv, ones, tail_valid)],
            scale,
        )
        return out, (tk, tv)

    def tail_flush(self, tail, tail_len):
        """Write each row's ``tail_len`` tail slots into its pages and
        advance ``lengths``: the flush kernel (#7) for the int8 tail when it
        fits one page, as in the JAX package; otherwise the scatter, one
        layer at a time (the bf16 tail quantized on the way, as the per-step
        write would)."""
        kk = tail[0].shape[3]
        q_pos = self.lengths[:, None] + torch.arange(
            kk, dtype=torch.int32, device=self.device)[None, :]
        num_l = self.k_pages.shape[0]
        if len(tail) == 4:  # kernel forms: int8 + scales
            wk, wv, wks, wvs = tail
            if kk <= self.page_size:
                from ..ops.paged_attention import paged_tail_flush

                paged_tail_flush(
                    self.k_pages, self.ks_pages, self.v_pages, self.vs_pages,
                    wk, wks, wv, wvs, self.page_table, self.lengths, tail_len,
                )
            else:
                for i in range(num_l):
                    self._scatter_planes(
                        self.k_pages[i], self.v_pages[i], self.ks_pages[i],
                        self.vs_pages[i], wk[i].transpose(1, 2),
                        wv[i].transpose(1, 2), wks[i].transpose(1, 2),
                        wvs[i].transpose(1, 2), q_pos, tail_len,
                    )
        else:
            wk, wv = tail  # [L, B, Hkv, K, D] bf16, keys rotated
            for i in range(num_l):
                self._scatter_q(
                    self.k_pages[i], self.v_pages[i], self.ks_pages[i],
                    self.vs_pages[i], wk[i].transpose(1, 2),
                    wv[i].transpose(1, 2), q_pos, tail_len,
                )
        self.lengths += tail_len
        return self

    def update_and_gather(self, layer_state, q, k_new, v_new, rope, q_pos,
                          num_new, sliding_window=None):
        """Gather fallback: the contiguous int8 view dequantized in the
        model dtype (``values.to(dt) * scales.to(dt)``, as the JAX cache
        does)."""
        from ..ops.paged_attention import gather_pages, gather_scales

        lk, lv, lks, lvs = layer_state
        b = k_new.shape[0]
        q_rot = apply_rope(q, rope.cos, rope.sin)
        k_rot = apply_rope(k_new, rope.cos, rope.sin)
        self._scatter_q(lk, lv, lks, lvs, k_rot, v_new, q_pos, num_new)
        dt = q.dtype

        def view(pages, scales):
            return gather_pages(pages, self.page_table).to(dt) * gather_scales(
                scales, self.page_table
            ).to(dt)[..., None]

        k_all = view(lk, lks)
        v_all = view(lv, lvs)
        kv_pos = torch.arange(
            self.max_len, dtype=torch.int32, device=self.device
        )[None, :].expand(b, self.max_len)
        kv_valid = kv_pos < (self.lengths + num_new)[:, None]
        mask = causal_mask(q_pos, kv_pos, kv_valid, sliding_window)
        return q_rot, k_all, v_all, mask, layer_state


class PageAllocator:
    """Host-side page allocator (page 0 reserved as the null page) with
    refcounts and a prompt-prefix registry for automatic prefix caching.

    Pure Python — only its *outputs* (page tables) reach the device. Guarded
    by the engine's scheduler lock.

    Prefix caching (vLLM-style): a page holding a FULL page-sized chunk of a
    session's prompt is content-addressed by the hash chain of the prompt up
    to and including that chunk. On release such pages are ``register``-ed
    instead of freed; a later session with the same prompt prefix ``lookup``s
    the chain and maps the cached pages into its table read-only (refcounted;
    writes never touch them — the session's write offset starts past the
    shared span). Unreferenced registered pages form an LRU that ``alloc``
    evicts from under pool pressure.
    """

    def __init__(self, num_pages: int):
        self._free = list(range(num_pages - 1, 0, -1))  # pop() yields low ids first
        self._free_set = set(self._free)
        self.num_pages = num_pages
        self._refs: Dict[int, int] = {}
        self._registry: Dict[bytes, int] = {}      # chain key -> page
        self._page_key: Dict[int, bytes] = {}      # page -> chain key
        self._lru: "collections.OrderedDict[int, None]" = collections.OrderedDict()
        # Eviction hook: called with (page, key) BEFORE the page returns to
        # the free list, while its content is still valid.
        self.on_evict = None

    @property
    def free_count(self) -> int:
        """Pages obtainable right now (free list + evictable cached pages)."""
        return len(self._free) + len(self._lru)

    @staticmethod
    def chain_keys(tokens, page_size: int) -> List[bytes]:
        """Hash-chain keys of every FULL page-sized chunk of ``tokens``."""
        keys, h = [], hashlib.sha1()
        for i in range(len(tokens) // page_size):
            chunk = tokens[i * page_size : (i + 1) * page_size]
            h.update(np.asarray(chunk, np.int64).tobytes())
            keys.append(h.digest())
        return keys

    def _evict_one(self) -> None:
        page, _ = self._lru.popitem(last=False)  # oldest
        key = self._page_key.pop(page)
        del self._registry[key]
        del self._refs[page]
        if self.on_evict is not None:
            self.on_evict(page, key)
        self._free.append(page)
        self._free_set.add(page)

    def alloc(self, n: int):
        """n fresh (private, refcount-1) pages; evicts cached pages if needed."""
        while len(self._free) < n and self._lru:
            self._evict_one()
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)}"
            )
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        for p in pages:
            self._refs[p] = 1
        return pages

    def lookup(self, keys: Sequence[bytes]) -> List[int]:
        """Longest cached run of prefix pages for ``keys``; each returned
        page's refcount is incremented (caller owns a reference)."""
        pages: List[int] = []
        for key in keys:
            page = self._registry.get(key)
            if page is None:
                break
            self._refs[page] += 1
            self._lru.pop(page, None)  # referenced: not evictable
            pages.append(page)
        return pages

    def lookup_one(self, key: bytes) -> Optional[int]:
        """One registered page by key, refcounted like :meth:`lookup`, or
        ``None`` when the key is not cached."""
        page = self._registry.get(key)
        if page is None:
            return None
        self._refs[page] += 1
        self._lru.pop(page, None)
        return page

    def peek(self, key: bytes) -> Optional[int]:
        """Registered page for ``key`` WITHOUT taking a reference."""
        return self._registry.get(key)

    def registered_keys(self, limit: int = 0) -> List[bytes]:
        """Registered chain keys, oldest first; ``limit`` > 0 keeps only the
        NEWEST that many."""
        keys = list(self._registry)
        return keys[-limit:] if limit > 0 else keys

    def register(self, page: int, key: bytes) -> None:
        """Content-address ``page`` (a full prompt-prefix page) under ``key``.
        If ``key`` is already registered to a different page, the existing
        entry wins (first writer; duplicates just stay private)."""
        if key in self._registry or page in self._page_key:
            return
        self._registry[key] = page
        self._page_key[page] = key

    def free(self, pages) -> None:
        """Drop one reference per page; unreferenced pages return to the free
        list, or to the evictable LRU if they are registered prefixes.

        Iterates in REVERSE so a prefix chain's deepest chunks enter the LRU
        first (oldest): eviction then trims chains from the tail, keeping a
        usable shorter prefix.

        The whole list is validated BEFORE any state changes: a bad id must
        raise with the pool untouched."""
        pages = list(pages)
        drops: Dict[int, int] = {}
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(
                    f"page {p} outside pool (1..{self.num_pages - 1}; 0 is the "
                    "reserved null page)"
                )
            drops[p] = drops.get(p, 0) + 1
            refs = self._refs.get(p)
            if (
                refs is None
                or refs == 0
                or p in self._free_set
                or drops[p] > refs  # duplicates within ONE call over-release
            ):
                raise ValueError(f"double free of page {p}")
        for p in reversed(pages):
            refs = self._refs[p]
            if refs > 1:
                self._refs[p] = refs - 1
                continue
            if p in self._page_key:  # cached prefix: evictable, not freed
                self._lru[p] = None
                self._refs[p] = 0
            else:
                del self._refs[p]
                self._free.append(p)
                self._free_set.add(p)
