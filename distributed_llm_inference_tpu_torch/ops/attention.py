"""Plain GQA attention and mask construction (counterpart of the JAX
package's ``ops/attention.py``).

The always-correct gather path of the caches, and the oracle the kernels'
plain versions are held against.
"""

from __future__ import annotations

from typing import Optional

import torch

# Finite on purpose (not ``-inf``): a fully masked row then softmaxes to a
# uniform row that the mask zeroes again, instead of NaN.
_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# The widths every attention kernel (``csrc/``) is built for: the head_dim,
# and the query heads a kv head, from MHA to Llama-3-70B's 8.
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_GROUP = 8


def kernel_widths_error(head_dim: int, group: int) -> Optional[str]:
    """Why no attention kernel takes ``head_dim`` with ``group`` query
    heads a kv head, or None when every one does."""
    if group > KERNEL_MAX_GROUP:
        return (f"{group} query heads per kv head: the attention kernels "
                f"take 1 to {KERNEL_MAX_GROUP}; per-head groups of 9 to 16 "
                f"(Qwen3-235B's 64 over 4) are not ported yet (ROADMAP.md "
                f"queue 1, item 18)")
    if group < 1 or head_dim not in KERNEL_HEAD_DIMS:
        return (f"head_dim {head_dim} with {group} query heads per kv head: "
                f"the attention kernels are built for "
                f"{' and '.join(f'head_dim {d}' for d in KERNEL_HEAD_DIMS)}")
    return None


# The widths the latent kernels (``csrc/latent_attention.cu``) are built
# for: the stored latent ``rank + rope_head_dim`` (DeepSeek-V2/V3's 512 + 64,
# and the ``LatentConfig`` defaults' 64 + 16), and the query heads over the
# one latent head, up to DeepSeek-V2-Lite's 16.
LATENT_DIMS = (576, 80)
LATENT_MAX_GROUP = 16


def latent_widths_error(lat_dim: int, group: int) -> Optional[str]:
    """Why no latent kernel takes a stored latent of ``lat_dim`` with
    ``group`` query heads over it, or None when every one does."""
    if group > LATENT_MAX_GROUP:
        return (f"{group} query heads over one latent: the latent kernels "
                f"take 1 to {LATENT_MAX_GROUP}; DeepSeek-V2/V3's 128 are not "
                f"ported yet (ROADMAP.md queue 1, item 19)")
    if group < 1 or lat_dim not in LATENT_DIMS:
        return (f"a latent of {lat_dim} with {group} query heads: the latent "
                f"kernels are built for "
                f"{' and '.join(f'lat_dim {d}' for d in LATENT_DIMS)} (other "
                f"widths: ROADMAP.md queue 1, item 19)")
    return None


def check_latent_widths(name: str, lat_dim: int, group: int) -> None:
    """Raise ``ValueError`` naming ``name`` for latent widths no latent
    kernel takes."""
    why = latent_widths_error(lat_dim, group)
    if why is not None:
        raise ValueError(f"{name}: {why}")


def int8_pages_error(head_dim: int, page_size: int) -> Optional[str]:
    """Why the bf16 kernels over int8 pages cannot take pages of
    ``page_size`` rows of ``head_dim``, or None. An int8 row of 64 is 64
    bytes: boxes of an odd number of rows would land off the 128-byte
    alignment a TMA destination needs."""
    if head_dim == 64 and page_size % 2:
        return (f"int8 pages of head_dim 64 need an even page size, got "
                f"{page_size}")
    return None


def rows_per_query(group: int) -> int:
    """Score rows a query takes in the bf16 prefill kernels' blocks of 128
    (ragged and flash): its kv head's ``group`` query heads, rounded up to a
    power of two (1, 2, 4 or 8), so that a block and each warpgroup's 64
    rows hold whole queries."""
    return 1 << (group - 1).bit_length()


def check_kernel_widths(name: str, head_dim: int, group: int) -> None:
    """Raise ``ValueError`` naming ``name`` for widths no kernel takes."""
    why = kernel_widths_error(head_dim, group)
    if why is not None:
        raise ValueError(f"{name}: {why}")


def causal_mask(
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Boolean attend-mask ``[..., S, T]`` from per-token positions.

    ``q_positions``: ``[..., S]``; ``kv_positions``: ``[..., T]``;
    ``kv_valid``: optional ``[..., T]`` slot validity; ``sliding_window``:
    key visible iff ``q_pos - w < k_pos <= q_pos``.
    """
    q = q_positions[..., :, None]
    k = kv_positions[..., None, :]
    mask = k <= q
    if sliding_window is not None:
        mask = mask & (k > (q - sliding_window))
    if kv_valid is not None:
        mask = mask & kv_valid[..., None, :]
    return mask


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention.

    ``q``: ``[B, S, Hq, D]``; ``k``/``v``: ``[B, T, Hkv, D]`` with
    ``Hq = G * Hkv``. ``mask``: boolean ``[B, S, T]`` or ``[B, 1, S, T]``
    (True = attend). Returns ``[B, S, Hq, D]`` in q's dtype; scores and
    softmax in fp32.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5

    qg = q.reshape(b, s, hkv, g, d)
    # [B, Hkv, G, S, T]
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale

    m = None
    if mask is not None:
        if mask.ndim == 3:
            m = mask[:, None, None, :, :]
        elif mask.ndim == 4:  # [B, 1, S, T]
            m = mask[:, :, None, :, :]
        else:
            raise ValueError(f"mask ndim {mask.ndim}")
        scores = torch.where(m, scores, _NEG_INF)

    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    if m is not None:
        # Fully masked rows (padded slots) come out as zeros.
        weights = torch.where(m, weights, 0.0)
    denom = weights.sum(dim=-1, keepdim=True)
    weights = weights / denom.clamp_min(1e-20)

    out = torch.einsum(
        "bkgst,btkd->bskgd", weights.to(v.dtype).float(), v.float()
    )
    return out.reshape(b, s, hq, d).to(q.dtype)


def merge_softmax_segments(
    q: torch.Tensor,
    out_a: torch.Tensor,
    m_a: torch.Tensor,
    l_a: torch.Tensor,
    k_tail: torch.Tensor,
    v_tail: torch.Tensor,
    tail_valid: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Joint softmax of a pre-computed attention segment with a small tail.

    ``out_a`` (``[B, 1, Hq, D]``, already normalized) with online-softmax
    stats ``m_a``/``l_a`` (``[B, Hkv, G]``) comes from ``paged_attention``
    with ``return_stats``; the tail segment (``k_tail``/``v_tail``
    ``[B, K, Hkv, D]``, ``tail_valid`` ``[B, K]``) holds fresh tokens. The
    flash-attention merge: exact, not an approximation.
    """
    b, s, hq, d = q.shape
    hkv = k_tail.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, s, hkv, g, d)

    sc = torch.einsum("bskgd,btkd->bkgst", qg.float(), k_tail.float()) * scale
    mask = tail_valid[:, None, None, None, :]
    sc = torch.where(mask, sc, _NEG_INF)                 # [B, Hkv, G, 1, K]
    m_t = sc.amax(dim=-1)                                # [B, Hkv, G, 1]
    w = torch.where(mask, torch.exp(sc - m_t[..., None]), 0.0)
    l_t = w.sum(dim=-1)
    pv_t = torch.einsum(
        "bkgst,btkd->bskgd", w.to(v_tail.dtype).float(), v_tail.float()
    )                                                    # [B, 1, Hkv, G, D]
    out_t = pv_t / l_t.clamp_min(1e-20).reshape(b, 1, hkv, g, 1)

    m_t = m_t[..., 0]
    l_t = l_t[..., 0]
    m = torch.maximum(m_a, m_t)                          # [B, Hkv, G]
    w_a = l_a * torch.exp(m_a - m)
    w_t = l_t * torch.exp(m_t - m)
    denom = (w_a + w_t).clamp_min(1e-20)
    fa = (w_a / denom)[:, None, :, :, None]
    ft = (w_t / denom)[:, None, :, :, None]
    out = out_a.reshape(b, s, hkv, g, d).float() * fa + out_t * ft
    return out.reshape(b, s, hq, d).to(q.dtype)


def gqa_attention_quantized(
    q: torch.Tensor,
    k_q: torch.Tensor,
    ks: torch.Tensor,
    v_q: torch.Tensor,
    vs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention over an int8 head-major cache without dequantizing it
    (counterpart of the JAX package's ``gqa_attention_quantized``).

    ``k_q``/``v_q``: int8 ``[B, Hkv, T, D]``; ``ks``/``vs``: f32 ``[B, Hkv,
    T]`` per-(token, head) scales. The K scale multiplies the scores
    (``q·(k·s) = s·(q·k)``); the softmax is normalised first, then each
    weight times its V scale is rounded to q's type before P V, as the JAX
    function does. ``mask``: boolean ``[B, S, T]`` or ``[B, 1, S, T]``.
    Returns ``[B, S, Hq, D]`` in q's type.
    """
    b, s, hq, d = q.shape
    hkv = k_q.shape[1]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, s, hkv, g, d).float()
    scores = torch.einsum("bskgd,bktd->bkgst", qg, k_q.to(q.dtype).float())
    scores = scores * (ks[:, :, None, None, :] * scale)
    m = None
    if mask is not None:
        if mask.ndim == 3:
            m = mask[:, None, None, :, :]
        elif mask.ndim == 4:  # [B, 1, S, T]
            m = mask[:, :, None, :, :]
        else:
            raise ValueError(f"mask ndim {mask.ndim}")
        scores = torch.where(m, scores, _NEG_INF)
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    if m is not None:
        weights = torch.where(m, weights, 0.0)
    denom = weights.sum(dim=-1, keepdim=True)
    weights = weights / denom.clamp_min(1e-20)
    wv = (weights * vs[:, :, None, None, :]).to(q.dtype).float()
    out = torch.einsum("bkgst,bktd->bskgd", wv, v_q.to(q.dtype).float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def gqa_attention_segments(
    q: torch.Tensor,
    segments,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention over several time-major KV segments under one joint
    softmax (counterpart of the JAX package's ``gqa_attention_segments``):
    the model-dtype dense cache's fused window, segment 0 the read-only
    buffer, segment 1 the write-behind tail.

    ``q``: ``[B, S, Hq, D]``; each segment ``(k, v, valid)`` with ``k``/``v``
    ``[B, Ti, Hkv, D]`` and ``valid`` ``[B, Ti]``. The unnormalised weights
    are rounded to v's type before P V, and the sum divided last, as the JAX
    function does. Returns ``[B, S, Hq, D]`` in q's type.
    """
    b, s, hq, d = q.shape
    hkv = segments[0][0].shape[2]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, s, hkv, g, d).float()

    scored = []
    for k, _, valid in segments:
        sc = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
        m = valid[:, None, None, None, :]
        scored.append((torch.where(m, sc, _NEG_INF), m))
    gmax = scored[0][0].amax(dim=-1, keepdim=True)
    for sc, _ in scored[1:]:
        gmax = torch.maximum(gmax, sc.amax(dim=-1, keepdim=True))
    denom = 0.0
    out = 0.0
    for (sc, m), (_, v, _) in zip(scored, segments):
        w = torch.where(m, torch.exp(sc - gmax), 0.0)
        denom = denom + w.sum(dim=-1, keepdim=True)
        out = out + torch.einsum(
            "bkgst,btkd->bskgd", w.to(v.dtype).float(), v.float()
        )
    denom = denom.clamp_min(1e-20).permute(0, 3, 1, 2, 4)
    return (out / denom).reshape(b, s, hq, d).to(q.dtype)


def gqa_attention_quantized_segments(
    q: torch.Tensor,
    segments,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Joint softmax over int8 head-major segments sharing one query
    (counterpart of the JAX package's ``gqa_attention_quantized_segments``).

    ``q``: ``[B, S, Hq, D]``; each segment is ``(k_q, ks, v_q, vs, valid)``
    with ``k_q``/``v_q`` ``[B, Hkv, Ti, D]`` (int8, or any type: the bf16
    write-behind tail rides along with unit scales), ``ks``/``vs`` f32
    ``[B, Hkv, Ti]`` and ``valid`` ``[B, Ti]``. The K scale multiplies the
    score and the V scale the probability, which is rounded to q's type
    before P V, as the JAX function does. Returns ``[B, S, Hq, D]`` in q's
    type.
    """
    b, s, hq, d = q.shape
    hkv = segments[0][0].shape[1]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, s, hkv, g, d).float()

    scored = []
    for k_q, ks, _, _, valid in segments:
        sc = torch.einsum("bskgd,bktd->bkgst", qg, k_q.to(q.dtype).float())
        sc = sc * (ks[:, :, None, None, :] * scale)
        m = valid[:, None, None, None, :]                # [B, 1, 1, 1, T]
        scored.append((torch.where(m, sc, _NEG_INF), m))

    gmax = scored[0][0].amax(dim=-1, keepdim=True)
    for sc, _ in scored[1:]:
        gmax = torch.maximum(gmax, sc.amax(dim=-1, keepdim=True))
    denom = 0.0
    out = 0.0
    for (sc, m), (_, _, v_q, vs, _) in zip(scored, segments):
        w = torch.where(m, torch.exp(sc - gmax), 0.0)
        denom = denom + w.sum(dim=-1, keepdim=True)
        wv = (w * vs[:, :, None, None, :]).to(q.dtype).float()
        out = out + torch.einsum(
            "bkgst,bktd->bskgd", wv, v_q.to(q.dtype).float()
        )
    denom = denom.clamp_min(1e-20).permute(0, 3, 1, 2, 4)
    return (out / denom).reshape(b, s, hq, d).to(q.dtype)


def gqa_attention_quantized_multi_q_segments(
    segments,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Joint softmax over int8 head-major segments, each with its OWN query
    and mask (counterpart of the JAX package's
    ``gqa_attention_quantized_multi_q_segments``): the int8 sink ring's
    sink segment is attended with the window-relative-rotated query, its
    ring and tail segments with the absolute-rotated one
    (``cache/sink.py``).

    Each segment is ``(q [B, S, Hq, D], k_q [B, Hkv, Ti, D] int8, ks [B,
    Hkv, Ti] f32, v_q, vs, mask)`` with ``mask`` ``[B, S, Ti]`` or a
    broadcastable ``[B, 1, Ti]``. Scores in f32, the K scale on the score,
    the V scale on the unnormalised weight, which is rounded to the first
    query's type before P V; the sum is divided last. Returns ``[B, S, Hq,
    D]`` in the first query's type."""
    q0 = segments[0][0]
    b, s, hq, d = q0.shape
    hkv = segments[0][1].shape[1]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5

    scored = []
    for q, k_q, ks, _, _, mask in segments:
        qg = q.reshape(b, s, hkv, g, d).float()
        sc = torch.einsum("bskgd,bktd->bkgst", qg, k_q.to(q.dtype).float())
        sc = sc * (ks[:, :, None, None, :] * scale)
        m = mask[:, None, None, :, :]                  # [B, 1, 1, S|1, T]
        scored.append((torch.where(m, sc, _NEG_INF), m))

    gmax = scored[0][0].amax(dim=-1, keepdim=True)
    for sc, _ in scored[1:]:
        gmax = torch.maximum(gmax, sc.amax(dim=-1, keepdim=True))
    denom = 0.0
    out = 0.0
    for (sc, m), (_, _, _, v_q, vs, _) in zip(scored, segments):
        w = torch.where(m, torch.exp(sc - gmax), 0.0)
        denom = denom + w.sum(dim=-1, keepdim=True)
        wv = (w * vs[:, :, None, None, :]).to(q0.dtype).float()
        out = out + torch.einsum(
            "bkgst,bktd->bskgd", wv, v_q.to(q0.dtype).float()
        )
    denom = denom.clamp_min(1e-20).permute(0, 3, 1, 2, 4)
    return (out / denom).reshape(b, s, hq, d).to(q0.dtype)
