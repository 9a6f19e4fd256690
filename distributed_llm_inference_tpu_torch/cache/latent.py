"""Latent (low-rank, MLA) paged KV cache (counterpart of the JAX package's
``cache/latent.py``).

The pool stores ONE fused latent per token, ``[c ; k_rope]``: the shared
``rank``-dim KV latent and the ``rope_head_dim``-dim decoupled rotary key
(``lat_dim = rank + rope_head_dim`` values a token), f32, or int8 with one
f32 scale a token. Attention runs over that stored form in the absorbed
formulation (``models/llama.py:_latent_attention``): ``K = V =`` the latent
over a single kv head, so the kernels' page walk reads the latents in
place and no per-token K/V is ever made.

Two consequences, as in the JAX cache:

* The model applies rope (to the ``k_rope`` slice only) before the latent
  reaches the cache: ``attend`` and ``update_and_gather`` never rotate.
* There is no write-behind tail: the parent's tail would rotate the stored
  form again, so ``tail_init`` raises and the engine's tail gate leaves
  latent caches out (``decode_steps`` K then steps ``model_apply`` K
  times).

The pool, the table and the lengths are updated in place, as in the port's
``cache/paged.py``; ``select_row(s)`` views share the planes (the int8
pool's scale plane too), so ``merge_row(s)`` writes back only the table and
the lengths. Whole pages move through the parent's ``copy_page``,
``read_page`` and ``write_page`` (prefix caching: ``PLANE_FIELDS`` names
``c``, and ``cs`` on the int8 pool); a row's planes' export and ingest
wait for disaggregation (ROADMAP.md queue 1, item 14).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..ops.attention import causal_mask
from ..utils.device import resolve_device
from .dense import _quantize_kv
from .paged import PagedKVCache

__all__ = ["LatentPagedKVCache", "QuantizedLatentPagedKVCache"]


class LatentPagedKVCache(PagedKVCache):
    """Paged pool of one f32 ``[lat_dim]`` latent a token.

    ``k_pages``: ``[L, num_pages, 1, page_size, lat_dim]`` f32, the fused
    ``[c ; k_rope]`` stored form. ``v_pages`` is None: no path reads a
    second plane (``PLANE_FIELDS`` names the latent planes only).
    """

    PLANE_FIELDS = {"c": "k_pages"}

    @staticmethod
    def create(
        num_layers: int,
        batch: int,
        num_pages: int,
        page_size: int,
        max_pages_per_session: int,
        num_kv_heads: int,
        lat_dim: int,
        dtype=torch.float32,  # interface parity; the stored form is f32
        use_kernel: bool = False,
        use_ragged: bool = False,
        device: Union[str, torch.device] = "cuda",
    ) -> "LatentPagedKVCache":
        _one_head(num_kv_heads)
        dev = resolve_device(device)
        shape = (num_layers, num_pages, 1, page_size, lat_dim)
        return LatentPagedKVCache(
            k_pages=torch.zeros(shape, dtype=torch.float32, device=dev),
            v_pages=None,
            page_table=torch.zeros((batch, max_pages_per_session),
                                   dtype=torch.int32, device=dev),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
            page_size=page_size,
            use_kernel=use_kernel,
            use_ragged=use_ragged,
        )

    @property
    def lat_dim(self) -> int:
        return self.k_pages.shape[-1]

    # -- pool writes / reads ------------------------------------------------
    def _scatter_latent(self, layer_state, c_new, q_pos, num_new):
        """Write incoming fused latents ``[B, S, 1, lat_dim]`` INTO the
        pool (padding tokens land on the null page 0)."""
        (layer_c,) = layer_state
        b, s, _, d = c_new.shape
        phys_page, offset = self._slot_pages(q_pos, num_new)
        layer_c[phys_page.reshape(-1), :, offset.reshape(-1)] = c_new.reshape(
            b * s, 1, d).to(layer_c.dtype)
        return layer_state

    def _contiguous_view(self, layer_state, dt):
        """Each row's pages as ``[B, max_len, 1, lat_dim]`` in ``dt``."""
        from ..ops.paged_attention import gather_pages

        return gather_pages(layer_state[0], self.page_table).to(dt)

    def _latent_mask(self, b, q_pos, num_new, sliding_window):
        kv_pos = torch.arange(
            self.max_len, dtype=torch.int32, device=self.device
        )[None, :].expand(b, self.max_len)
        kv_valid = kv_pos < (self.lengths + num_new)[:, None]
        return causal_mask(q_pos, kv_pos, kv_valid, sliding_window)

    def _kernel_attend(self, state, q, num_new, scale, sliding_window):
        from ..ops.paged_attention import latent_paged_attention
        from ..ops.ragged_attention import latent_ragged_paged_attention

        kv_lengths = self.lengths + num_new
        if q.shape[1] > 1:
            return latent_ragged_paged_attention(
                q, state[0], self.page_table, kv_lengths, num_new,
                scale=scale, sliding_window=sliding_window)
        return latent_paged_attention(
            q, state[0], self.page_table, kv_lengths, scale=scale,
            sliding_window=sliding_window)

    # -- attention ----------------------------------------------------------
    def attend(self, layer_state, q, k_new, v_new, rope, q_pos, num_new,
               sliding_window, attention_fn, scale=None):
        """``q`` is the absorbed query ``[B, S, Hq, lat_dim]`` and
        ``k_new`` (== ``v_new``) the fused latent, both already rotated on
        their rope slice: nothing here rotates. Multi-token rows with
        ``use_ragged`` and decode steps with ``use_kernel`` read the pool
        in place through the latent kernels; the rest gathers."""
        state = self._scatter_latent(layer_state, k_new, q_pos, num_new)
        s = q.shape[1]
        if (self.use_ragged and s > 1) or (self.use_kernel and s == 1):
            return self._kernel_attend(state, q, num_new, scale,
                                       sliding_window), state
        c_all = self._contiguous_view(state, q.dtype)
        mask = self._latent_mask(q.shape[0], q_pos, num_new, sliding_window)
        return attention_fn(q, c_all, c_all, mask, scale=scale), state

    def update_and_gather(self, layer_state, q, k_new, v_new, rope, q_pos,
                          num_new, sliding_window: Optional[int] = None):
        """The gather view (no rope, see :meth:`attend`)."""
        state = self._scatter_latent(layer_state, k_new, q_pos, num_new)
        c_all = self._contiguous_view(state, q.dtype)
        mask = self._latent_mask(q.shape[0], q_pos, num_new, sliding_window)
        return q, c_all, c_all, mask, state

    # -- serialization ------------------------------------------------------
    def ingest_row(self, ks, vs, n_valid, first_slot=0):
        raise TypeError(
            "latent cache has no k/v planes; use ingest_latent_row"
        )

    def ingest_latent_row(self, planes, n_valid, first_slot=0):
        raise NotImplementedError(
            "installing latent planes (ingest_latent_row) is not ported yet "
            "(ROADMAP.md queue 1, item 14)"
        )

    # -- write-behind tail: never used (the engine's tail gate leaves latent
    # caches out: the parent's tail would rotate the stored form again).
    def tail_init(self, k_steps: int):
        raise NotImplementedError("latent cache has no write-behind tail")


class QuantizedLatentPagedKVCache(LatentPagedKVCache):
    """Latent pool in int8 with one f32 scale a token.

    ``k_pages``: int8 ``[L, P, 1, PS, lat_dim]``; ``cs_pages``: f32
    ``[L, P, 1, PS]``. New latents are quantized per token on the way in
    (``cache/dense.py:_quantize_kv``); the kernels apply the scale to the
    score and to the probability before P V; the gather path dequantizes
    its contiguous view in q's type."""

    PLANE_FIELDS = {"c": "k_pages", "cs": "cs_pages"}

    def __init__(self, k_pages, cs_pages, page_table, lengths, page_size,
                 use_kernel=False, use_ragged=False):
        super().__init__(k_pages, None, page_table, lengths, page_size,
                         use_kernel, use_ragged)
        self.cs_pages = cs_pages

    @staticmethod
    def create(
        num_layers: int,
        batch: int,
        num_pages: int,
        page_size: int,
        max_pages_per_session: int,
        num_kv_heads: int,
        lat_dim: int,
        dtype=torch.float32,  # interface parity; values are int8
        use_kernel: bool = False,
        use_ragged: bool = False,
        device: Union[str, torch.device] = "cuda",
    ) -> "QuantizedLatentPagedKVCache":
        _one_head(num_kv_heads)
        dev = resolve_device(device)
        shape = (num_layers, num_pages, 1, page_size, lat_dim)
        return QuantizedLatentPagedKVCache(
            k_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            cs_pages=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            page_table=torch.zeros((batch, max_pages_per_session),
                                   dtype=torch.int32, device=dev),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
            page_size=page_size,
            use_kernel=use_kernel,
            use_ragged=use_ragged,
        )

    def _scatter_latent(self, layer_state, c_new, q_pos, num_new):
        layer_c, layer_cs = layer_state
        b, s, _, d = c_new.shape
        c_q, c_s = _quantize_kv(c_new)  # int8 [B, S, 1, D] / f32 [B, S, 1]
        phys_page, offset = self._slot_pages(q_pos, num_new)
        flat_page, flat_off = phys_page.reshape(-1), offset.reshape(-1)
        layer_c[flat_page, :, flat_off] = c_q.reshape(b * s, 1, d)
        layer_cs[flat_page, :, flat_off] = c_s.reshape(b * s, 1)
        return layer_state

    def _contiguous_view(self, layer_state, dt):
        from ..ops.paged_attention import gather_pages, gather_scales

        c, cs = layer_state
        return gather_pages(c, self.page_table).to(dt) * gather_scales(
            cs, self.page_table).to(dt)[..., None]

    def _kernel_attend(self, state, q, num_new, scale, sliding_window):
        from ..ops.paged_attention import quantized_latent_paged_attention
        from ..ops.ragged_attention import (
            quantized_latent_ragged_paged_attention)

        kv_lengths = self.lengths + num_new
        if q.shape[1] > 1:
            return quantized_latent_ragged_paged_attention(
                q, state[0], state[1], self.page_table, kv_lengths, num_new,
                scale=scale, sliding_window=sliding_window)
        return quantized_latent_paged_attention(
            q, state[0], state[1], self.page_table, kv_lengths, scale=scale,
            sliding_window=sliding_window)


def _one_head(num_kv_heads: int) -> None:
    if num_kv_heads != 1:
        raise ValueError(
            f"latent cache stores ONE shared latent head, got "
            f"num_kv_heads={num_kv_heads}"
        )
