"""The tensor-core instance of the latent decode kernel
(``csrc/latent_attention.cu``, ``latent_decode_tc_kernel``: bf16 queries at
lat_dim 576, one query a row, over the f32 and the int8 latent pools) as a
plain model, held to the port's plain version and to the JAX package's
latent decode wrappers (Pallas, interpret mode) on the same numpy inputs;
and its launch plan (``ops/paged_attention.py:latent_decode_plan``,
``latent_cluster_size``).

The model follows the kernel cluster by cluster and block by block: a row's
live positions [lo, hi) (hi the kv length cut to the table, lo from the
window anchored at q_positions) in steps of 16 from lo rounded down, dealt
to the C blocks of the row's cluster in turn (block r takes steps r, r + C,
...); a step's positions outside [lo, hi) converted to zeros; the f32
pool's latents as hi = bf16(x) and lo = bf16(x - hi), the int8 pool's bytes
exact in bf16; the four consumer warps' partial scores over their 144
columns (f32: Q K_hi + Q K_lo) summed in warp order, so every warp holds
the same scores; the K scale on the score, then the scale; the online
softmax (m from the finite ``_NEG_INF``); P (int8: p * vs) as bf16 hi + lo
terms; P V on each warp's columns (int8: p_hi V + p_lo V; f32: p_hi V_hi +
p_hi V_lo + p_lo V_hi, the fifth pass; p_lo V_lo is not run); then the
blocks' (O, m, l) merged in rank order, the output rounded once to bf16.
An empty row gives zeros, m = ``_NEG_INF`` and l = 0.

Tolerances. Before the rounding the model is f32-grade: the hi + lo terms
leave about 2^-17 of each operand, so its f32 output is held to the plain
version's (f32 math on the same bf16 queries) within 1e-4 on outputs of
magnitude about 1; a one-pass control (no lo terms) misses that. After the
rounding, model and plain version (and the JAX wrappers: f32 math, bf16
out) differ by at most one bf16 step, 2^-7 of max(|out|, 1); m and l within
1e-4 (l relative to max(l, 1)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.ops import paged_attention as jpa
from distributed_llm_inference_tpu_torch.cache.dense import _quantize_kv
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)
D = tpa.DECODE_TC_LAT_DIM
NEG_INF = -0.7 * float(np.finfo(np.float32).max)
F32_TOL = 1e-4
BF16_STEP = 2.0**-7
STEP, WARPS, COLS = 16, 4, 144


def bf16(x):
    return x.to(torch.bfloat16).float()


def row_range(kv_len, q_pos, span, window):
    """A row's live positions [lo, hi), the first step and the steps, as
    ``latent_decode_tc_kernel`` computes them."""
    hi = min(kv_len, span)
    lo = max(0, q_pos - window + 1) if window else 0
    first = lo & ~(STEP - 1)
    steps = -(-(hi - first) // STEP) if hi > lo else 0
    return lo, hi, first, steps


def deal(steps, cluster):
    """Block r's steps: r, r + C, ..."""
    return [list(range(r, steps, cluster)) for r in range(cluster)]


def walk_block(qrows, k_hi, k_lo, cs, pos_steps, lo, hi, scale, lo_terms):
    """One block's (O, m, l) over its steps. ``k_hi``/``k_lo``: the row's
    converted latents [span, D] (k_lo None for int8), ``cs`` its scales or
    None."""
    q8 = cs is not None
    o = torch.zeros(16, D)
    m = torch.full((16,), NEG_INF)
    l_ = torch.zeros(16)
    span = k_hi.shape[0]
    for s0 in pos_steps:
        pos = s0 + torch.arange(STEP)
        live = (pos >= lo) & (pos < hi)
        at = pos.clamp(0, span - 1)
        th = torch.where(live[:, None], k_hi[at], 0.0)
        tl = None if q8 else torch.where(live[:, None], k_lo[at], 0.0)
        parts = []
        for w in range(WARPS):
            c = slice(w * COLS, (w + 1) * COLS)
            part = qrows[:, c] @ th[:, c].T
            if not q8 and lo_terms:
                part = part + qrows[:, c] @ tl[:, c].T
            parts.append(part)
        s = ((parts[0] + parts[1]) + parts[2]) + parts[3]
        cst = torch.where(live, cs[at], 0.0) if q8 else None
        if q8:
            s = s * cst[None, :]
        x = torch.where(live[None, :], s * scale, -torch.inf)
        mn = torch.maximum(m, x.max(1).values)
        alpha = torch.exp(m - mn)
        p = torch.exp(x - mn[:, None])
        l_ = l_ * alpha + p.sum(1)
        m = mn
        pv = p * cst[None, :] if q8 else p
        p_hi = bf16(pv)
        p_lo = bf16(pv - p_hi) if lo_terms else torch.zeros_like(pv)
        for w in range(WARPS):
            c = slice(w * COLS, (w + 1) * COLS)
            acc = o[:, c] * alpha[:, None] + p_hi @ th[:, c]
            if not q8 and lo_terms:
                acc = acc + p_hi @ tl[:, c]
            acc = acc + p_lo @ th[:, c]
            o[:, c] = acc
    return o, m, l_


def model_decode(q, c, cs, table, kv_lens, q_positions, cluster, scale=None,
                 window=None, lo_terms=True):
    """The tensor-core decode instance on the CPU. q: [B, 1, G, 576] bf16;
    c: [P, 1, PS, 576] f32 or int8 (``cs`` [P, 1, PS] f32). Returns the bf16
    output, the f32 one before its rounding, m and l [B, 1, G].
    ``lo_terms=False`` drops the lo passes, to show what they buy."""
    b_, _, g, d = q.shape
    assert d == D and 1 <= g <= 16
    q8 = cs is not None
    scale = d**-0.5 if scale is None else scale
    ps, tw = c.shape[2], table.shape[1]
    span = tw * ps
    lat = c[table.long()].reshape(b_, span, d).float()
    sc = cs[table.long()].reshape(b_, span) if q8 else None
    k_hi = bf16(lat)
    k_lo = None if q8 else bf16(lat - k_hi)
    out = torch.zeros(b_, 1, g, d)
    m_out = torch.zeros(b_, 1, g)
    l_out = torch.zeros(b_, 1, g)
    for b in range(b_):
        lo, hi, first, steps = row_range(int(kv_lens[b]), int(q_positions[b]),
                                         span, window)
        qrows = torch.zeros(16, d)
        qrows[:g] = q[b, 0].float()
        states = [walk_block(qrows, k_hi[b], None if q8 else k_lo[b],
                             sc[b] if q8 else None,
                             [first + STEP * i for i in mine], lo, hi, scale,
                             lo_terms)
                  for mine in deal(steps, cluster)]
        mx = torch.full((16,), NEG_INF)
        for _, mk, _ in states:
            mx = torch.maximum(mx, mk)
        acc = torch.zeros(16, d)
        tot = torch.zeros(16)
        for ok, mk, lk in states:  # rank order
            f = torch.exp(mk - mx)
            tot = tot + lk * f
            acc = acc + ok * f[:, None]
        out[b, 0] = (acc / tot.clamp_min(1e-20)[:, None])[:g]
        m_out[b, 0], l_out[b, 0] = mx[:g], tot[:g]
    return out.to(torch.bfloat16), out, m_out, l_out


def decode_inputs(seed, g, ps, lens, int8, width):
    """q (bf16), the pool (f32, or int8 + scales as the int8 pool stores
    them), a shuffled table, lengths; numpy first, so the JAX wrappers see
    the same values."""
    rng = np.random.default_rng(seed)
    b_ = len(lens)
    pages = 1 + b_ * width
    c = rng.standard_normal((pages, 1, ps, D)).astype(np.float32)
    qn = (rng.standard_normal((b_, 1, g, D)) * 0.3).astype(np.float32)
    table = (1 + rng.permutation(pages - 1)[:b_ * width]).reshape(
        b_, width).astype(np.int32)
    ct, cs = torch.from_numpy(c), None
    if int8:
        ct, cs = _quantize_kv(ct)
    return (torch.from_numpy(qn).to(torch.bfloat16), ct, cs,
            torch.from_numpy(table),
            torch.from_numpy(np.asarray(lens, np.int32)))


def plain(q, c, cs, table, lens, window, dtype=None):
    qq = q if dtype is None else q.to(dtype)
    qpos = lens - 1
    if cs is None:
        return tpa.latent_paged_attention_plain(
            qq, c, table, lens, sliding_window=window, q_positions=qpos,
            return_stats=True)
    return tpa.quantized_latent_paged_attention_plain(
        qq, c, cs, table, lens, sliding_window=window, q_positions=qpos,
        return_stats=True)


def assert_one_bf16_step(got, want, what=""):
    got, want = got.float(), want.float()
    err = (got - want).abs() / want.abs().clamp_min(1.0)
    assert float(err.max()) <= BF16_STEP, (what, float(err.max()))


def assert_stats(gm, gl, wm, wl):
    assert float((gm - wm).abs().max()) <= 1e-4
    assert float(((gl - wl).abs() / wl.clamp_min(1.0)).max()) <= 1e-4


# Rows: empty, one position, a page, a page and one, a long row, a row whose
# window starts mid-step. Clusters: one block, a few, more blocks than steps.
def row_lens(ps):
    return [0, 1, ps, ps + 1, 150, 97]


CASES = [(g, ps, window, cluster, int8)
         for g, ps, window, cluster in ((16, 16, None, 4), (16, 6, 40, 3),
                                        (8, 16, 40, 1), (1, 6, None, 7))
         for int8 in (False, True)]


@pytest.mark.parametrize(
    "g,ps,window,cluster,int8", CASES,
    ids=[f"g{g}_ps{ps}_w{w}_c{c}_{'int8' if i else 'f32'}"
         for g, ps, w, c, i in CASES])
def test_model_matches_plain_version(g, ps, window, cluster, int8):
    """The model against the plain version: f32-grade before the bf16
    rounding (1e-4), one bf16 step after it; m and l within 1e-4; the empty
    row exact zeros, m = _NEG_INF, l = 0."""
    lens = row_lens(ps)
    q, c, cs, table, lens_t = decode_inputs(
        g * 7 + ps + (window or 0) + cluster, g, ps, lens, int8,
        -(-max(lens) // ps) + 1)
    got, got_f32, gm, gl = model_decode(q, c, cs, table, lens_t, lens_t - 1,
                                        cluster, window=window)
    want_f32, wm, wl = plain(q, c, cs, table, lens_t, window, torch.float32)
    want, _, _ = plain(q, c, cs, table, lens_t, window)
    assert got.shape == want.shape == q.shape and got.dtype == torch.bfloat16
    assert float((got_f32 - want_f32).abs().max()) <= F32_TOL
    assert_one_bf16_step(got, want)
    assert_stats(gm, gl, wm, wl)
    assert not got[0].float().any()
    assert float(gm[0].max()) == float(np.float32(NEG_INF))
    assert float(gl[0].abs().max()) == 0.0


def test_one_pass_control_misses_f32_grade():
    """Without the lo terms (one bf16 pass of K and of P) the model misses
    the f32 math by far more than with them, over either pool."""
    lens = [150, 97, 61]
    for int8 in (False, True):
        q, c, cs, table, lens_t = decode_inputs(11, 16, 16, lens, int8, 11)
        want, _, _ = plain(q, c, cs, table, lens_t, None, torch.float32)
        _, with_lo, _, _ = model_decode(q, c, cs, table, lens_t, lens_t - 1,
                                        4)
        _, without, _, _ = model_decode(q, c, cs, table, lens_t, lens_t - 1,
                                        4, lo_terms=False)
        e_with = float((with_lo - want).abs().max())
        e_without = float((without - want).abs().max())
        assert e_with <= F32_TOL < e_without and 10 * e_with < e_without, (
            int8, e_with, e_without)


JAX_CASES = [(g, ps, window, int8) for g, ps, window in
             ((16, 6, None), (8, 16, 20), (1, 16, None), (16, 16, 20))
             for int8 in (False, True)]


@pytest.mark.parametrize(
    "g,ps,window,int8", JAX_CASES,
    ids=[f"g{g}_ps{ps}_w{w}_{'int8' if i else 'f32'}"
         for g, ps, w, i in JAX_CASES])
def test_model_matches_jax_interpret(g, ps, window, int8):
    """Rows of length 0, 1, a page and a page + 1 through the JAX package's
    latent decode wrapper (Pallas, interpret mode) and the model, a cluster
    of 2: the output within one bf16 step, m and l within 1e-4."""
    lens = [0, 1, ps, ps + 1]
    q, c, cs, table, lens_t = decode_inputs(5 + g + ps, g, ps, lens, int8, 3)
    jfn = (jpa.quantized_latent_paged_attention if int8
           else jpa.latent_paged_attention)
    pools = (jnp.asarray(c.numpy()),) + (
        (jnp.asarray(cs.numpy()),) if int8 else ())
    want, wm, wl = jfn(jnp.asarray(q.float().numpy(), jnp.bfloat16), *pools,
                       table.numpy(), lens_t.numpy(), sliding_window=window,
                       interpret=True, q_positions=(lens_t - 1).numpy(),
                       return_stats=True)
    got, _, gm, gl = model_decode(q, c, cs, table, lens_t, lens_t - 1, 2,
                                  window=window)
    assert_one_bf16_step(got, torch.from_numpy(
        np.array(jnp.asarray(want, jnp.float32))))
    assert_stats(gm, gl, torch.from_numpy(np.array(wm)),
                 torch.from_numpy(np.array(wl)))
    assert not got[0].float().any()


@pytest.mark.parametrize("window", [None, 5, 300])
def test_deal_gives_every_live_position_once(window):
    """For every cluster size, every live position of a row lies in exactly
    one block's steps, the walk starting less than a step before lo and
    ending less than a step past hi."""
    rng = np.random.default_rng(4)
    for _ in range(40):
        kv_len = int(rng.integers(0, 3000))
        lo, hi, first, steps = row_range(kv_len, kv_len - 1, 4096, window)
        for cluster in range(1, 17):
            seen = np.zeros(4096 + STEP, np.int64)
            for mine in deal(steps, cluster):
                for i in mine:
                    seen[first + STEP * i:first + STEP * (i + 1)] += 1
            assert (seen[lo:hi] == 1).all() and seen.max() <= 1
            if hi > lo:
                assert first <= lo < first + STEP
                assert hi <= first + STEP * steps < hi + STEP
            else:
                assert steps == 0


def banks(word, n):
    return {(word + i) % 32 for i in range(n)}


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_plan_fits_and_reads_free_of_bank_conflicts(int8):
    """Q, the converted and the raw rings, the partial scores, the scales
    and the barriers fit a block's 232,448 bytes; the block's (O, m, l)
    fits in the drained converted ring; a converted row's stride is 4 mod
    32 words, so ldmatrix's 8 rows of 16 bytes hit distinct banks; the
    converters' raw reads (int8: 8 bytes a lane, a half warp; f32: 16, a
    quarter warp) and converted writes (int8: 16 bytes, a quarter warp; f32:
    8, a half warp) do too."""
    plan = tpa.latent_decode_plan(int8)
    assert plan["smem_bytes"] <= 232448
    assert plan["state_bytes"] <= plan["converted_ring_bytes"]
    assert plan["step"] == STEP and plan["threads"] == 32 * (WARPS + 4 + 1)
    assert plan["columns_a_warp"] * WARPS == D and COLS % 16 == 0
    row = plan["converted_row_bytes"] // 4
    assert row % 32 == 4 and plan["converted_row_bytes"] % 16 == 0
    got = [banks(r * row, 4) for r in range(8)]  # ldmatrix: 8 rows
    assert len(set().union(*got)) == 32
    if int8:  # lane ct: row ct // 8, bytes 72 (ct % 8) + 8 j
        for half in range(8):
            got = [banks((ct // 8) * (D // 4) + (ct % 8) * 18, 2)
                   for ct in range(16 * half, 16 * half + 16)]
            assert len(set().union(*got)) == 32
        for quarter in range(16):
            got = [banks((ct // 8) * row + (ct % 8) * 36, 4)
                   for ct in range(8 * quarter, 8 * quarter + 8)]
            assert len(set().union(*got)) == 32
    else:  # lane ct: row ct // 16 (+ 8), float4 ct % 16 + 16 j
        for quarter in range(16):
            got = [banks((ct // 16) * D + (ct % 16) * 4, 4)
                   for ct in range(8 * quarter, 8 * quarter + 8)]
            assert len(set().union(*got)) == 32
        for half in range(8):
            got = [banks((ct // 16) * row + (ct % 16) * 2, 2)
                   for ct in range(16 * half, 16 * half + 16)]
            assert len(set().union(*got)) == 32


@pytest.mark.parametrize("batch,span,fits,want", [
    (8, 2048, {}, 16), (1, 2048, {}, 16), (9, 2048, {}, 14),
    (8, 40, {}, 3), (200, 2048, {}, 1), (8, 2048, {16: 7, 15: 7}, 14),
])
def test_cluster_size(monkeypatch, batch, span, fits, want):
    """B x C near the SM count (132), at most 16 and the span's steps, and
    shrunk until the card holds the batch's clusters at once (``fits``:
    clusters the card holds, by size; 132 // C where not given)."""
    dev = torch.device("cuda", 0)
    monkeypatch.setitem(tpa._sm_count, dev, 132)
    monkeypatch.setattr(tpa, "latent_cluster_fit",
                        lambda device, q8, c: fits.get(c, 132 // c))
    assert tpa.latent_cluster_size(dev, batch, span, False) == want
