"""The int8 decode kernel's decomposition (``csrc/paged_decode.cuh`` over
int8 rows, the bf16-query form of ``quantized_paged_attention``, #5, and of
``quantized_decode_attention``, #8), modelled in PyTorch and held to the
JAX package's Pallas kernels in interpret mode on the same numpy inputs:
``quantized_paged_attention`` (the output, ``m`` and ``l``) and
``quantized_decode_attention`` (the output).

The kernel serves one (row, kv head) with a cluster of C blocks. The row's
live positions ``[lo, hi)`` (``hi = min(kv_len, cap)``, ``lo`` from the
sliding window anchored at ``q_positions``) are walked in steps of 64
positions aligned on 64; block r takes steps r, r + C, ...; each of its 4
warps takes 16 positions of a step and keeps its own online softmax, one
max a head per 16 positions. The K scale multiplies the score, ``s = (q .
k) * ks * scale``; P V takes ``p * vs`` as two bf16 terms, ``hi =
bf16(p * vs)`` and ``lo = bf16(p * vs - hi)``; l sums p in f32. The warps'
states merge into the block's, the blocks' into the output. Over pages the
rows come through the page table, over the dense buffer they are the row's
own ``T`` positions: the model gathers each (row, kv head)'s positions in
order, as the kernel's row maps name them.

Inputs: bf16 values of q held in f32, K and V quantized per (position, kv
head) from normal values as the caches store them (int8 and an f32 scale,
``cache/dense.py:_quantize_kv``), so the kernel's bf16 operands (q, and int8
K and V converted exactly) are the same numbers. JAX runs in f32, so the
one difference in arithmetic is ``hi + lo`` for ``p * vs`` in P V: about
2^-17 of a term, far inside the 1e-2 tolerance of the output (a weighted
mean of dequantized values below 5). ``m`` and ``l`` are f32 on both sides,
summed in another order: 1e-5."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.cache import dense as jdense
from distributed_llm_inference_tpu.ops.paged_attention import (
    quantized_paged_attention as jax_qpaged,
)
from distributed_llm_inference_tpu.ops.quant_attention import (
    quantized_decode_attention as jax_qdense,
)
from distributed_llm_inference_tpu_torch.ops.attention import _NEG_INF

torch.set_num_threads(1)
STEP, WARPS = 64, 4  # pdec::kStep, pdec::kWarps
ROWS = STEP // WARPS  # positions a warp takes of a step
ATOL_OUT, ATOL_STATS = 1e-2, 1e-5
HKV, D = 2, 16


def merge(states):
    """(m, l, acc) states ([B, Hkv, G], the same, [B, Hkv, G, D]) merged
    under one max."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(states[0][2])
    for sm, sl, sa in states:
        f = torch.exp(sm - m)
        l = l + sl * f
        acc = acc + sa * f[..., None]
    return m, l, acc


def decode_model(q, k, ks, v, vs, lens, qpos, window, blocks):
    """``(out [B, Hq, D], m [B, Hkv, G], l [B, Hkv, G])`` of the kernel's
    split with ``blocks`` blocks a cluster. ``q`` ``[B, Hq, D]`` f32; ``k``
    / ``v`` each (row, kv head)'s positions in order, ``[B, Hkv, cap, D]``
    int8, their scales ``ks`` / ``vs`` ``[B, Hkv, cap]`` f32."""
    b, hq, d = q.shape
    hkv, cap = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d**-0.5
    qh = q.reshape(b, hkv, g, d)
    lens = torch.as_tensor(lens, dtype=torch.int64)
    qpos = torch.as_tensor(qpos, dtype=torch.int64)
    hi = lens.clamp(max=cap)
    lo = (qpos - window + 1).clamp(min=0) if window else torch.zeros_like(hi)
    first = lo // STEP * STEP
    nsteps = torch.where(hi > lo, -(-(hi - first) // STEP), 0)
    rows = torch.arange(b)[:, None]
    block_states = []
    for rank in range(blocks):
        warp_states = []
        for w in range(WARPS):
            m = torch.full((b, hkv, g), _NEG_INF)
            l = torch.zeros(b, hkv, g)
            acc = torch.zeros(b, hkv, g, d)
            for i in range(rank, int(nsteps.max()), blocks):
                # A row with no live position among these 16 leaves its
                # state as it was, as the warp that skips them does.
                pos = first[:, None] + i * STEP + w * ROWS + torch.arange(ROWS)
                valid = ((pos >= lo[:, None]) & (pos < hi[:, None]))[:, None]
                at = pos.clamp(0, cap - 1)
                kk = k[rows, :, at].permute(0, 2, 1, 3).float()  # [B, Hkv, 16, D]
                vv = v[rows, :, at].permute(0, 2, 1, 3).float()
                kscl = ks[rows, :, at].permute(0, 2, 1)          # [B, Hkv, 16]
                vscl = vs[rows, :, at].permute(0, 2, 1)
                s = torch.einsum("bhgd,bhpd->bhgp", qh, kk)
                s = torch.where(valid[:, :, None], s * kscl[:, :, None] * scale,
                                float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                pw = torch.where(valid[:, :, None], p * vscl[:, :, None], 0.0)
                pw_hi = pw.to(torch.bfloat16).float()
                pw_lo = (pw - pw_hi).to(torch.bfloat16).float()
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhgp,bhpd->bhgd", pw_hi, vv) + torch.einsum(
                    "bhgp,bhpd->bhgd", pw_lo, vv)
                m = m_new
            warp_states.append((m, l, acc))
        block_states.append(merge(warp_states))
    m, l, acc = merge(block_states)
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.reshape(b, hq, d), m, l


def quantized(rng, shape, d=D):
    """Normal values ``shape + (d,)`` quantized per leading index as the
    caches store them: (int8 values, f32 scales)."""
    x = rng.standard_normal((*shape, d)).astype(np.float32)
    qv, sc = jdense._quantize_kv(jnp.asarray(x))
    return np.array(qv), np.array(sc)


def bf16_values(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# Paged rows: empty, one slot, shorter than one step, across pages and
# steps, and long enough for every block of an 8-block cluster to take
# steps.
PAGED_LENS = [0, 1, 40, 130, 600]
# (window, past): none; one that starts inside a page and a step, anchored
# at the row's last position; one anchored 9 positions past it (the query
# ahead of the cache).
WINDOWS = [(None, 0), (37, 0), (100, 9)]
# The groupings 3, 7 and 8 at the tests' head_dim, and 4 and 8 at 64: the
# split is the same one, over page sizes and widths of their own, the
# windows in turn.
WIDTHS = ((3, D), (7, D), (8, D), (4, 64), (8, 64))


def width_id(g, d):
    return str(g) if d == D else f"{g}d{d}"


@functools.lru_cache(maxsize=None)
def paged_case(ps, g, window, past, d=D):
    """Inputs of one paged case and the Pallas kernel's (out, m, l) on
    them (the cluster sizes of a case share them)."""
    rng = np.random.default_rng(ps + 10 * g + (d != D) * d)
    b = len(PAGED_LENS)
    width = -(-max(PAGED_LENS) // ps) + 1
    pages = b * width + 1
    q = bf16_values(rng.standard_normal((b, 1, HKV * g, d)).astype(np.float32))
    kp, ksp = quantized(rng, (pages, HKV, ps), d)
    vp, vsp = quantized(rng, (pages, HKV, ps), d)
    table = (rng.permutation(pages - 1)[: b * width].reshape(b, width)
             + 1).astype(np.int32)
    lens = np.asarray(PAGED_LENS, np.int32)
    qpos = (np.maximum(lens - 1, 0) + past).astype(np.int32)
    want = jax_qpaged(
        *(jnp.asarray(a) for a in (q, kp, ksp, vp, vsp, table, lens)),
        sliding_window=window, interpret=True, q_positions=jnp.asarray(qpos),
        return_stats=True)
    return (q, kp, ksp, vp, vsp, table, lens, qpos), tuple(
        np.asarray(x) for x in want)


def page_rows(pages, table):
    """``[P, Hkv, PS(, D)]`` pages under ``table`` ``[B, Tw]`` -> each
    (row, kv head)'s positions in order, ``[B, Hkv, Tw * PS(, D)]``."""
    g = pages[table.long()]  # [B, Tw, Hkv, PS(, D)]
    g = g.transpose(1, 2)    # [B, Hkv, Tw, PS(, D)]
    return g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])


PAGED_CASES = [
    (ps, g, D, blocks, window, past)
    for window, past in WINDOWS for blocks in (1, 2, 8) for g in (1, 4)
    for ps in (1, 16, 48, 64, 128)] + [
    (ps, g, d, 2, *WINDOWS[i % 3])
    for i, ((g, d), ps) in enumerate(zip(WIDTHS, (16, 48, 128, 16, 48)))]


@pytest.mark.parametrize(
    "ps,g,d,blocks,window,past", PAGED_CASES,
    ids=[f"{w}-{p}-{c}-{width_id(g, d)}-{ps}"
         for ps, g, d, c, w, p in PAGED_CASES])
def test_paged_split_matches_jax(ps, g, d, blocks, window, past):
    """#5: the model of the kernel's split over int8 pages against
    ``quantized_paged_attention``'s Pallas kernel: the output, ``m`` and
    ``l``; an empty row is zeros with ``m = _NEG_INF``, ``l = 0``."""
    (q, kp, ksp, vp, vsp, table, lens, qpos), (want, wm, wl) = paged_case(
        ps, g, window, past, d)
    tab = torch.from_numpy(table)
    got, gm, gl = decode_model(
        torch.from_numpy(q[:, 0]),
        *(page_rows(torch.from_numpy(a), tab) for a in (kp, ksp, vp, vsp)),
        lens, qpos, window, blocks)
    np.testing.assert_allclose(got.numpy(), want[:, 0], atol=ATOL_OUT, rtol=0)
    np.testing.assert_allclose(gm.numpy(), wm, atol=ATOL_STATS, rtol=0)
    np.testing.assert_allclose(gl.numpy(), wl, atol=ATOL_STATS,
                               rtol=ATOL_STATS)
    assert (got[0] == 0).all() and (gl[0] == 0).all(), "an empty row is zeros"
    assert (gm[0] == _NEG_INF).all()


@functools.lru_cache(maxsize=None)
def dense_case(t, g, window, past, d=D):
    """Inputs of one dense case (widths not multiples of 64; the last row
    runs to the buffer's end) and the Pallas kernel's output on them."""
    rng = np.random.default_rng(t + 10 * g + (d != D) * d)
    lens = np.asarray([0, 1, t // 2 + 3, t - 1, t], np.int32)
    b = len(lens)
    q = bf16_values(rng.standard_normal((b, 1, HKV * g, d)).astype(np.float32))
    k, ks = quantized(rng, (b, HKV, t), d)
    v, vs = quantized(rng, (b, HKV, t), d)
    qpos = (np.maximum(lens - 1, 0) + past).astype(np.int32)
    want = jax_qdense(
        *(jnp.asarray(a) for a in (q, k, ks, v, vs, lens)),
        sliding_window=window, interpret=True, q_positions=jnp.asarray(qpos))
    return (q, k, ks, v, vs, lens, qpos), np.asarray(want)


DENSE_CASES = [
    (t, g, D, blocks, window, past)
    for window, past in WINDOWS for blocks in (1, 2, 8) for g in (1, 4)
    for t in (40, 200, 300)] + [
    (t, g, d, 2, *WINDOWS[(i + 1) % 3])
    for i, ((g, d), t) in enumerate(zip(WIDTHS, (200, 40, 300, 200, 40)))]


@pytest.mark.parametrize(
    "t,g,d,blocks,window,past", DENSE_CASES,
    ids=[f"{w}-{p}-{c}-{width_id(g, d)}-{t}"
         for t, g, d, c, w, p in DENSE_CASES])
def test_dense_split_matches_jax(t, g, d, blocks, window, past):
    """#8: the model of the kernel's split over the int8 dense buffer
    against ``quantized_decode_attention``'s Pallas kernel; an empty row is
    zeros. The model's ``m`` and ``l`` are held to a softmax of the whole
    row in f32."""
    (q, k, ks, v, vs, lens, qpos), want = dense_case(t, g, window, past, d)
    kt, kst, vt, vst = (torch.from_numpy(a) for a in (k, ks, v, vs))
    got, gm, gl = decode_model(torch.from_numpy(q[:, 0]), kt, kst, vt, vst,
                               lens, qpos, window, blocks)
    np.testing.assert_allclose(got.numpy(), want[:, 0], atol=ATOL_OUT, rtol=0)
    assert (got[0] == 0).all() and (gl[0] == 0).all(), "an empty row is zeros"
    # The stats: one max and one sum over the row's live positions.
    pos = torch.arange(t)[None, :]
    lo = torch.as_tensor(np.maximum(qpos - window + 1, 0) if window
                         else np.zeros_like(qpos))[:, None]
    valid = (pos < torch.as_tensor(lens)[:, None]) & (pos >= lo)
    qh = torch.from_numpy(q[:, 0]).reshape(len(lens), HKV, g, d)
    s = torch.einsum("bhgd,bhtd->bhgt", qh, kt.float()) * kst[:, :, None]
    s = torch.where(valid[:, None, None], s * d**-0.5, _NEG_INF)
    m = s.amax(-1)
    l = torch.where(valid[:, None, None], torch.exp(s - m[..., None]),
                    0.0).sum(-1)
    np.testing.assert_allclose(gm.numpy(), m.numpy(), atol=ATOL_STATS, rtol=0)
    np.testing.assert_allclose(gl.numpy(), l.numpy(), atol=ATOL_STATS,
                               rtol=ATOL_STATS)
