"""The tensor-core instance of the ragged latent kernel
(``csrc/latent_attention.cu``, ``latent_wgmma_kernel``: bf16 queries at
lat_dim 576, over the f32 and the int8 latent pools) as a plain model, held
to the port's plain version and to the JAX package's latent wrappers
(Pallas, interpret mode) on the same numpy inputs; and its launch plan
(``ops/ragged_attention.py:latent_wgmma_plan``).

The model follows the kernel block by block and step by step: the plan's
query tiles (64 score rows a block, ``64 >> gshift`` queries of
``rows_per_query(G)`` rows, the last tile launched first), each block's
positions [lo, hi) walked a step at a time (32 positions of the int8 pool,
16 of the f32 pool) from lo rounded down, positions outside them converted
to zeros, the converted tile (f32 pool: hi = bf16(x), lo = bf16(x - hi),
each position's two rows; int8: the bytes, exact in bf16), the three
consumer warpgroups' partial scores over their 192 columns (f32: Q K_hi and
Q K_lo as two columns, added) summed in the kernel's fixed order, the masks
(causal, window, kv length, pad queries), the online softmax in the log2
domain, P (int8: p * vs) as bf16 hi + lo terms, P V on each warpgroup's
columns (int8: p_hi V + p_lo V; f32: (p_hi + p_lo) (V_hi + V_lo), both
terms meeting both rows), then the normalisation, zeros for pad queries
and one rounding to bf16.

Tolerances. Before the rounding the model is f32-grade: the hi + lo terms
leave about 2^-17 of each operand, so its f32 output is held to the plain
version's (f32 math on the same bf16 queries) within 1e-4 on outputs of
magnitude about 1; one bf16 pass without the lo terms misses that by an
order of magnitude (checked). After the rounding, model and plain version
differ by at most one bf16 step: 2^-7 of max(|out|, 1). Against the JAX
wrappers (f32 math, bf16 out) the same step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.ops import ragged_attention as jra
from distributed_llm_inference_tpu_torch.cache.dense import _quantize_kv
from distributed_llm_inference_tpu_torch.ops import ragged_attention as tra

torch.set_num_threads(1)
D = tra.WGMMA_LAT_DIM
LOG2E = 1.4426950408889634
NEG_INF = -0.7 * float(np.finfo(np.float32).max)
F32_TOL = 1e-4   # model before its bf16 rounding against the plain f32 math
BF16_STEP = 2.0**-7  # one bf16 step, relative to max(|out|, 1)


def bf16(x):
    return x.to(torch.bfloat16).float()


def blocks_of(seq, group, quantized):
    """The kernel's blocks in launch order: (grid x, first query), the
    query tiles reversed."""
    plan = tra.latent_wgmma_plan(seq, group, quantized)
    tiles, per = plan["query_tiles"], plan["queries_a_block"]
    return [(x, (tiles - 1 - x) * per) for x in range(tiles)], plan


def block_range(i0, per, num_new, seq, q_start, kv_len, span, window, step):
    """A block's real queries, the positions [lo, hi) they see and the
    steps that walk them, as ``latent_wgmma_kernel`` computes them."""
    nn = min(num_new, seq)
    if i0 >= nn:
        return 0, 0, 0, 0, 0
    nq = min(per, nn - i0)
    kv_len = min(kv_len, span)
    hi = min(kv_len, q_start + i0 + nq)
    lo = max(0, q_start + i0 - window + 1) if window else 0
    first = lo - lo % step
    steps = -(-(hi - first) // step) if hi > first else 0
    return nq, lo, hi, first, steps


def model_wgmma(q, c, cs, table, kv_lens, num_new, q_start, scale=None,
                window=None, lo_terms=True):
    """The tensor-core instance on the CPU. q: [B, S, G, 576] bf16; c:
    [P, 1, PS, 576] f32 or int8 (``cs`` [P, 1, PS] f32). Returns the bf16
    output and the f32 one before its rounding. ``lo_terms=False`` drops
    the lo passes (one bf16 pass each), to show what they buy."""
    b_, s_, g, d = q.shape
    q8 = cs is not None
    scale = d**-0.5 if scale is None else scale
    blocks, plan = blocks_of(s_, g, q8)
    per, gp, step = (plan["queries_a_block"], plan["rows_per_query"],
                     plan["step"])
    cols = plan["columns_a_warpgroup"]
    assert plan["threads"] == 512 and d % cols == 0 and cols % 64 == 0
    ps, tw = c.shape[2], table.shape[1]
    span = tw * ps
    lat = c[table.long()].reshape(b_, span, d).float()
    sc = cs[table.long()].reshape(b_, span) if q8 else None
    k_hi = bf16(lat)
    k_lo = None if q8 else bf16(lat - k_hi)
    out = torch.zeros(b_, s_, g, d)
    seen = torch.zeros(b_, s_, dtype=torch.int64)
    for b in range(b_):
        for _, i0 in blocks:
            nq, lo, hi, first, steps = block_range(
                i0, per, int(num_new[b]), s_, int(q_start[b]),
                int(kv_lens[b]), span, window, step)
            seen[b, i0:i0 + per] += 1
            if nq == 0:
                continue
            r = torch.arange(64)
            qi, h = r // gp, r % gp
            real = (h < g) & (qi < nq)
            qrows = torch.zeros(64, d)
            qrows[real] = q[b, i0 + qi[real], h[real]].float()
            qpos = int(q_start[b]) + i0 + qi
            top = torch.where(qi < nq, torch.clamp(qpos, max=hi - 1),
                              torch.full_like(qpos, -1))
            bot = qpos - window + 1 if window else torch.zeros_like(qpos)
            o = torch.zeros(64, d)
            m = torch.full((64,), NEG_INF)
            l_ = torch.zeros(64)
            for i in range(steps):
                pos = first + i * step + torch.arange(step)
                live = (pos >= lo) & (pos < hi)
                at = pos.clamp(0, span - 1)
                th = torch.where(live[:, None], k_hi[b, at], 0.0)
                tl = None if q8 else torch.where(live[:, None], k_lo[b, at],
                                                 0.0)
                parts = []
                for w in range(d // cols):
                    c0 = slice(w * cols, (w + 1) * cols)
                    part = qrows[:, c0] @ th[:, c0].T
                    if not q8 and lo_terms:
                        part = part + qrows[:, c0] @ tl[:, c0].T
                    parts.append(part)
                s = parts[0]
                for part in parts[1:]:
                    s = s + part
                mult = scale * LOG2E
                if q8:
                    cst = torch.where(live, sc[b, at], 0.0)
                    mult = mult * cst[None, :]
                valid = (pos[None, :] >= bot[:, None]) & (
                    pos[None, :] <= top[:, None])
                x = torch.where(valid, s * mult, -torch.inf)
                mn = torch.maximum(m, x.max(1).values)
                alpha = torch.exp2(m - mn)
                p = torch.exp2(x - mn[:, None])
                l_ = l_ * alpha + p.sum(1)
                m = mn
                pv = p * cst[None, :] if q8 else p
                p_hi = bf16(pv)
                p_lo = bf16(pv - p_hi) if lo_terms else torch.zeros_like(pv)
                for w in range(d // cols):
                    c0 = slice(w * cols, (w + 1) * cols)
                    acc = o[:, c0] * alpha[:, None] + p_hi @ th[:, c0]
                    acc = acc + p_lo @ th[:, c0]
                    if not q8 and lo_terms:
                        acc = acc + p_hi @ tl[:, c0] + p_lo @ tl[:, c0]
                    o[:, c0] = acc
            ok = qi < nq
            res = torch.where(ok[:, None], o / l_.clamp_min(1e-20)[:, None],
                              0.0)
            keep = (h < g) & (i0 + qi < s_)
            out[b, i0 + qi[keep], h[keep]] = res[keep]
    assert bool((seen >= 1).all()) and bool((seen <= 1).all()), seen
    return out.to(torch.bfloat16), out


def latent_inputs(seed, g, ps, q_start, num_new, int8, width=None):
    """q (bf16), the pool (f32, or int8 + scales quantized as the int8 pool
    stores them), a shuffled table, lengths; numpy first, so the JAX
    wrappers see the same values."""
    rng = np.random.default_rng(seed)
    b_ = len(num_new)
    s_ = max(num_new)
    lens = np.asarray(q_start) + np.asarray(num_new)
    width = width or -(-int(lens.max()) // ps)
    pages = 1 + b_ * width
    c = rng.standard_normal((pages, 1, ps, D)).astype(np.float32)
    qn = (rng.standard_normal((b_, s_, g, D)) * 0.3).astype(np.float32)
    table = (1 + rng.permutation(pages - 1)[:b_ * width]).reshape(
        b_, width).astype(np.int32)
    q = torch.from_numpy(qn).to(torch.bfloat16)
    cs = None
    ct = torch.from_numpy(c)
    if int8:
        ct, cs = _quantize_kv(ct)
    return (q, ct, cs, torch.from_numpy(table), torch.from_numpy(
        lens.astype(np.int32)), torch.from_numpy(np.asarray(
            num_new, np.int32)), torch.from_numpy(np.asarray(
                q_start, np.int32)))


def plain(q, c, cs, table, lens, num_new, q_start, window, dtype=None):
    qq = q if dtype is None else q.to(dtype)
    if cs is None:
        return tra.latent_ragged_paged_attention_plain(
            qq, c, table, lens, num_new, q_start, sliding_window=window)
    return tra.quantized_latent_ragged_paged_attention_plain(
        qq, c, cs, table, lens, num_new, q_start, sliding_window=window)


def assert_one_bf16_step(got, want, what=""):
    got, want = got.float(), want.float()
    err = (got - want).abs() / want.abs().clamp_min(1.0)
    assert float(err.max()) <= BF16_STEP, (what, float(err.max()))


# Rows of a mixed dispatch: (q_start, num_new). A prompt, a chunk from 300
# (a window of 300 cuts it), a decode token at 330, an empty row.
MIXED = ([0, 300, 330, 0], [37, 21, 1, 0])
CASES = [(g, ps, window, int8)
         for g, ps, window in ((16, 16, None), (16, 64, 300), (8, 64, None),
                               (8, 16, 300), (1, 64, None), (1, 16, 300))
         for int8 in (False, True)]


@pytest.mark.parametrize(
    "g,ps,window,int8", CASES,
    ids=[f"g{g}_ps{ps}_w{w}_{'int8' if i else 'f32'}"
         for g, ps, w, i in CASES])
def test_model_matches_plain_version(g, ps, window, int8):
    """The model against the plain version: f32-grade before the bf16
    rounding (1e-4), one bf16 step after it; pad queries and the empty row
    exact zeros."""
    q, c, cs, table, lens, new, start = latent_inputs(
        g * 7 + ps + (window or 0), g, ps, *MIXED, int8)
    got, got_f32 = model_wgmma(q, c, cs, table, lens, new, start,
                               window=window)
    want_f32 = plain(q, c, cs, table, lens, new, start, window,
                     torch.float32)
    want = plain(q, c, cs, table, lens, new, start, window)
    assert got.shape == want.shape == q.shape and got.dtype == torch.bfloat16
    assert float((got_f32 - want_f32).abs().max()) <= F32_TOL
    assert_one_bf16_step(got, want)
    pad = torch.arange(q.shape[1])[None, :] >= new[:, None]
    assert not got[pad].any()


def test_lo_terms_make_the_products_f32_grade():
    """Without the lo terms (one bf16 pass of K and of P) the model misses
    the f32 math by far more than with them, over either pool's P V and the
    f32 pool's K."""
    for int8 in (False, True):
        q, c, cs, table, lens, new, start = latent_inputs(
            11, 16, 16, *MIXED, int8)
        want = plain(q, c, cs, table, lens, new, start, None, torch.float32)
        _, with_lo = model_wgmma(q, c, cs, table, lens, new, start)
        _, without = model_wgmma(q, c, cs, table, lens, new, start,
                                 lo_terms=False)
        e_with = float((with_lo - want).abs().max())
        e_without = float((without - want).abs().max())
        assert e_with <= F32_TOL < e_without and 10 * e_with < e_without, (
            int8, e_with, e_without)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_model_matches_jax_interpret(int8):
    """One tiny mixed dispatch per pool through the JAX package's latent
    wrapper (Pallas, interpret mode) and the model: a prompt, a chunk with
    a window of 5, an empty row."""
    q, c, cs, table, lens, new, start = latent_inputs(
        3, 16, 4, [0, 9, 0], [6, 3, 0], int8, width=4)
    window = 5
    jfn = (jra.quantized_latent_ragged_paged_attention if int8
           else jra.latent_ragged_paged_attention)
    pools = (jnp.asarray(c.numpy()),) + (
        (jnp.asarray(cs.numpy()),) if int8 else ())
    want = jfn(jnp.asarray(q.float().numpy(), jnp.bfloat16), *pools,
               table.numpy(), lens.numpy(), new.numpy(),
               q_start=start.numpy(), sliding_window=window, interpret=True)
    got, _ = model_wgmma(q, c, cs, table, lens, new, start, window=window)
    assert_one_bf16_step(got, torch.from_numpy(
        np.array(jnp.asarray(want, jnp.float32))))
    assert not got[2].any() and not got[1, 3:].any()


@pytest.mark.parametrize("seq", [1, 5, 300, 2048])
@pytest.mark.parametrize("group", [1, 3, 8, 16])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_plan_covers_every_query_once_and_fits(seq, group, int8):
    """The blocks cover each query of a row once (tiles of ``64 >> gshift``
    whole queries, launched last first); the 576 columns split into three
    warpgroups' 192 (three 64-column blocks each); the shared memory fits
    a block's 232,448 bytes and every stage starts on a 1024-byte line."""
    blocks, plan = blocks_of(seq, group, int8)
    rows = plan["rows_per_query"]
    assert rows >= group and rows & (rows - 1) == 0
    assert plan["queries_a_block"] * rows == 64
    firsts = [i0 for _, i0 in blocks]
    assert firsts == sorted(firsts, reverse=True) and firsts[-1] == 0
    covered = sorted(q for i0 in firsts
                     for q in range(i0, min(i0 + plan["queries_a_block"],
                                            seq)))
    assert covered == list(range(seq))
    assert plan["columns_a_warpgroup"] * 3 == D
    assert plan["columns_a_warpgroup"] % 64 == 0
    assert plan["smem_bytes"] <= 232448
    stage = (1 if int8 else 2) * D * plan["step"] * 2
    assert stage % 1024 == 0 and (64 * D * 2) % 1024 == 0
    assert plan["step"] % plan["piece_positions"] == 0


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [None, 5, 300])
def test_block_ranges_hold_every_visible_position(window, int8):
    """Every (query, position) pair the function sees lies in its block's
    walked steps, inside [lo, hi); the walk starts less than a step before
    lo and ends less than a step past hi."""
    rng = np.random.default_rng(4)
    for _ in range(50):
        g = int(rng.choice([1, 3, 8, 16]))
        seq = int(rng.integers(1, 80))
        num_new = int(rng.integers(0, seq + 1))
        q_start = int(rng.integers(0, 400))
        kv_len = q_start + num_new
        blocks, plan = blocks_of(seq, g, int8)
        per, step = plan["queries_a_block"], plan["step"]
        for _, i0 in blocks:
            nq, lo, hi, first, steps = block_range(
                i0, per, num_new, seq, q_start, kv_len, 4096, window, step)
            for qi in range(nq):
                qp = q_start + i0 + qi
                seen_lo = max(0, qp - window + 1) if window else 0
                assert lo <= seen_lo and min(qp, kv_len - 1) < hi
            if nq:
                assert first <= lo < first + step
                assert hi <= first + step * steps < hi + step
