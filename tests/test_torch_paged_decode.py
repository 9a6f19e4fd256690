"""The bf16 decode kernel's decomposition (``csrc/paged_decode.cuh``),
modelled in PyTorch and held to the JAX package's ``paged_attention``
Pallas kernel in interpret mode, ``m`` and ``l`` included, on the same numpy
inputs.

The kernel serves one (row, kv head) with a cluster of C blocks. The row's
live positions ``[lo, kv_len)`` (``lo`` from the sliding window, anchored
at ``q_positions``) are walked in steps of 64 positions aligned on 64;
block r takes steps r, r + C, ...; each of its 4 warps takes 16 positions
of a step and keeps its own online softmax, one max a head per 16
positions, with p rounded to bf16 for P V and summed in f32 for l. The
warps' states merge into the block's, the blocks' into the output. The
model below repeats that, with the cluster sizes the wrapper picks
(``cluster_size``: 1 at large batches, up to 8 at one row).

Inputs are bf16 values held in f32 (the kernel's bf16 operands are then
the same numbers) and JAX runs in f32, so the one difference in arithmetic
is the kernel's bf16 p in P V: at most 2^-9 of each term p * v, which over
rows of normal values stays far inside the 1e-2 tolerance of the output
(the relative error of a weighted mean of |v| < 5). ``m`` and ``l`` are
f32 on both sides, summed in another order: 1e-5."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
)
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa
from distributed_llm_inference_tpu_torch.ops.attention import _NEG_INF

torch.set_num_threads(1)
STEP, WARPS = 64, 4  # pdec::kStep, pdec::kWarps
ROWS = STEP // WARPS  # positions a warp takes of a step
ATOL_OUT, ATOL_STATS = 1e-2, 1e-5


def bf16_values(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def merge(states):
    """(m, l, acc) states of one (row, kv head) merged under one max."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(states[0][2])
    for sm, sl, sa in states:
        f = torch.exp(sm - m)
        l = l + sl * f
        acc = acc + sa * f[:, None]
    return m, l, acc


def decode_model(q, kp, vp, table, lens, qpos, window, blocks):
    """``(out [B, Hq, D], m [B, Hkv, G], l [B, Hkv, G])`` of the kernel's
    split with ``blocks`` blocks a cluster. ``q`` ``[B, Hq, D]``, pages
    ``[P, Hkv, PS, D]``, all f32 tensors."""
    b, hq, d = q.shape
    hkv, ps = kp.shape[1], kp.shape[2]
    g = hq // hkv
    scale = d**-0.5
    out = torch.zeros(b, hkv, g, d)
    m_out = torch.full((b, hkv, g), _NEG_INF)
    l_out = torch.zeros(b, hkv, g)
    for r in range(b):
        hi = min(int(lens[r]), table.shape[1] * ps)
        lo = max(0, int(qpos[r]) - window + 1) if window else 0
        first = lo // STEP * STEP
        nsteps = -(-(hi - first) // STEP) if hi > lo else 0
        for h in range(hkv):
            qh = q[r, h * g:(h + 1) * g]
            block_states = []
            for rank in range(blocks):
                warp_states = []
                for w in range(WARPS):
                    m = torch.full((g,), _NEG_INF)
                    l = torch.zeros(g)
                    acc = torch.zeros(g, d)
                    for i in range(rank, nsteps, blocks):
                        p0 = first + i * STEP + w * ROWS
                        pos = torch.arange(p0, p0 + ROWS)
                        valid = (pos >= lo) & (pos < hi)
                        if not bool(valid.any()):
                            continue
                        live = pos.clamp(max=hi - 1)
                        pages = table[r, live // ps].long()
                        k = kp[pages, h, live % ps]
                        v = vp[pages, h, live % ps]
                        s = torch.where(valid[None], qh @ k.T * scale,
                                        float("-inf"))
                        m_new = torch.maximum(m, s.amax(-1))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        pb = p.to(torch.bfloat16).float()
                        acc = acc * alpha[:, None] + pb @ v
                        m = m_new
                    warp_states.append((m, l, acc))
                block_states.append(merge(warp_states))
            m, l, acc = merge(block_states)
            out[r, h] = acc / l.clamp_min(1e-20)[:, None]
            m_out[r, h], l_out[r, h] = m, l
    return out.reshape(b, hq, d), m_out, l_out


def case_inputs(seed, ps, g, lens, hkv=2, d=16, width=None):
    rng = np.random.default_rng(seed)
    b = len(lens)
    width = width or -(-max(lens) // ps) + 1
    pages = b * width + 1
    q = bf16_values(rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32))
    kp = bf16_values(rng.standard_normal((pages, hkv, ps, d)).astype(np.float32))
    vp = bf16_values(rng.standard_normal((pages, hkv, ps, d)).astype(np.float32))
    table = (rng.permutation(pages - 1)[: b * width].reshape(b, width) + 1)
    return q, kp, vp, table.astype(np.int32), np.asarray(lens, np.int32)


# Rows: empty, shorter than a warp's 16 positions, shorter than one block's
# step, across pages and steps, and long enough for every block of an
# 8-block cluster to take steps.
LENS = [0, 5, 40, 130, 600]


@functools.lru_cache(maxsize=None)
def jax_case(ps, g, window, past, d=16):
    """Inputs of one case and the Pallas kernel's (out, m, l) on them (the
    cluster sizes of a case share them)."""
    q, kp, vp, table, lens = case_inputs(ps + 10 * g + (d != 16) * d, ps, g,
                                         LENS, d=d)
    qpos = np.maximum(lens - 1, 0) + past
    want, wm, wl = jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), sliding_window=window, interpret=True,
        q_positions=jnp.asarray(qpos.astype(np.int32)), return_stats=True)
    return (q, kp, vp, table, lens, qpos), tuple(
        np.asarray(x) for x in (want, wm, wl))


WINDOWS = [(None, 0), (37, 0), (100, 9)]
# Every grouping 1 to 8 and head_dim 64 ride on the same split: the 8 rows
# of the score tile's heads (3, 7, 8 query heads a kv head at head_dim 16;
# 4 and 8 at 64), over pages of 48 and 3-block clusters, the windows in
# turn.
SPLIT_CASES = [
    (ps, g, 16, blocks, window, past)
    for window, past in WINDOWS for blocks in (1, 3, 8) for g in (1, 4)
    for ps in (16, 48, 64)] + [
    (48, g, d, 3, *WINDOWS[i % 3])
    for i, (g, d) in enumerate(((3, 16), (7, 16), (8, 16), (4, 64),
                                (8, 64)))]


@pytest.mark.parametrize(
    "ps,g,d,blocks,window,past", SPLIT_CASES,
    ids=[f"{w}-{p}-{c}-{g if d == 16 else f'{g}d{d}'}-{ps}"
         for ps, g, d, c, w, p in SPLIT_CASES])
def test_cluster_split_matches_jax(ps, g, d, blocks, window, past):
    """The model of the kernel's split against the Pallas kernel: the
    output, ``m`` and ``l``; a sliding window whose start falls inside a
    page and a step, anchored at the row's last position or at
    ``q_positions`` past it (the query ahead of the cache)."""
    (q, kp, vp, table, lens, qpos), (want, wm, wl) = jax_case(
        ps, g, window, past, d)
    got, gm, gl = decode_model(
        torch.from_numpy(q[:, 0]), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), lens, qpos, window, blocks)
    np.testing.assert_allclose(got.numpy(), want[:, 0], atol=ATOL_OUT, rtol=0)
    np.testing.assert_allclose(gm.numpy(), wm, atol=ATOL_STATS, rtol=0)
    np.testing.assert_allclose(gl.numpy(), wl, atol=ATOL_STATS,
                               rtol=ATOL_STATS)
    assert (got[0] == 0).all() and (gl[0] == 0).all(), "an empty row is zeros"
    assert (gm[0] == _NEG_INF).all()


@pytest.mark.parametrize("pairs,span,want", [
    (64, 2048, 2), (8, 2048, 8), (1, 2048, 8), (16, 2048, 8), (32, 2048, 4),
    (8, 100, 2), (128, 2048, 1), (512, 4096, 1), (64, 40, 1), (8, 300, 5)])
def test_cluster_size(pairs, span, want, monkeypatch):
    """The wrappers' cluster size on a card of 132 SMs: about one block an
    SM over all (row, kv head) pairs, at most 8, at most the 64-position
    steps of the table or of the dense buffer (widths of 40 and 300)."""
    monkeypatch.setitem(tpa._sm_count, "card", 132)
    assert tpa.cluster_size("card", pairs, span) == want
