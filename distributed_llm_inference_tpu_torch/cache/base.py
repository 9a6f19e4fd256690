"""Shared cache behavior: the window ladder and the default ``attend`` step
(counterpart of the JAX package's ``cache/base.py``).

``attend`` is the single entry the model calls per decoder layer: write the
new k/v into the cache, run attention, return ``(attn_out, layer_state)``.
The default is the always-correct gather path — ``update_and_gather`` into a
contiguous view, then the caller-supplied ``attention_fn``. The paged caches
override it to read pages in place through the CUDA kernels, the int8 dense
cache to attend over its int8 buffers directly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


def window_ladder(
    cap: int,
    custom: Optional[Sequence[int]] = None,
    strict: bool = True,
) -> Tuple[int, ...]:
    """Buffer-size buckets for live-context growth: ~1.25x geometric,
    32-aligned, ending exactly at ``cap``. ``custom`` overrides the ladder
    ((), the empty ladder, disables growth); ``strict`` rejects a custom
    ladder lying entirely above ``cap``, non-strict callers get ``(cap,)``."""
    if custom is not None:
        if not custom:
            return ()
        if any(w <= 0 for w in custom):
            raise ValueError(f"window buckets must be positive: {custom}")
        ws = tuple(sorted(w for w in custom if w <= cap))
        if not ws:
            if strict:
                raise ValueError(
                    f"every window bucket exceeds the cache capacity "
                    f"{cap}: {custom}"
                )
            return (cap,)
        return ws if ws[-1] == cap else ws + (cap,)
    ws, w = [], 32
    while w < cap:
        ws.append(w)
        nxt = ((int(w * 1.25) + 31) // 32) * 32
        w = nxt if nxt > w else w + 32
    ws.append(cap)
    return tuple(ws)


# Prefills at least this long route the quantized caches' attention through
# the flash kernel's gather path instead of the int8-score formulation: the
# materialised [B, Hq, S, T] scores turn dominant around S ~ 1k (the JAX
# package's measurement, in its ``cache/base.py``).
FLASH_PREFILL_MIN_S = 1024


def flash_prefill_fn(s: int, t: int, attention_fn):
    """The flash-for-long-prefill policy, in ONE place for every quantized
    cache kind: returns :func:`ops.flash_attention.flash_attention` when the
    caller's default-attention prefill is long enough and tiles cleanly,
    else None (keep the int8-score path). ``s``/``t`` = query/buffer
    lengths."""
    from ..ops.attention import gqa_attention

    if (
        attention_fn is gqa_attention
        and s >= FLASH_PREFILL_MIN_S
        and s % 128 == 0
        and t % 128 == 0
    ):
        from ..ops.flash_attention import flash_attention

        return flash_attention
    return None


class GatherAttendMixin:
    """Default ``attend``: gather-to-contiguous + ``attention_fn``."""

    def attend(
        self,
        layer_state: Tuple,
        q,
        k_new,
        v_new,
        rope,
        q_pos,
        num_new,
        sliding_window: Optional[int],
        attention_fn,
        scale: Optional[float] = None,
    ):
        q_rot, k_all, v_all, mask, new_state = self.update_and_gather(
            layer_state, q, k_new, v_new, rope, q_pos, num_new,
            sliding_window=sliding_window,
        )
        return attention_fn(q_rot, k_all, v_all, mask, scale=scale), new_state
