"""Port parity: the fused decode window's three kernels on the int8 pool
(on CPU tensors, so their plain versions) against the JAX package's Pallas
kernels in interpret mode, on the same numpy inputs:
``quantized_paged_fused_attention`` (the pool read in place),
``quantized_fused_decode_attention`` (contiguous gathered stacks) and
``paged_tail_flush``.

Tolerances: outputs 2e-5 absolute in f32 (both sides round q and p * vs to
bf16 at the same points over the same tiles, and sum in another order) and
2e-2 in bf16 (the output's own rounding); the tail's scales equal to 1e-6
relative (one f32 division on both sides); the flushed pool bytes equal.
The tail's int8 planes are equal from f32 inputs. From bf16 inputs they
are within 1 LSB, on at most 1% of the values: the port divides by the
scale as ``_quantize_kv`` specifies, while XLA's CPU compiler, under the
jit that interpret mode runs in, rewrites that division, and for the few
values a bf16 input puts next to a rounding tie the quotient falls on the
other side (the JAX package's own eager ``_quantize_kv`` agrees with the
port there). Rows cover a fresh row, continued rows,
a finished row (its slot write is never read), a row whose window straddles
a page, a sliding window, and 1 or 2 query heads per kv head."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.cache.dense import _quantize_kv as jax_quantize_kv
from distributed_llm_inference_tpu.ops.paged_attention import (
    paged_tail_flush as jax_flush,
    quantized_paged_fused_attention as jax_paged_fused,
)
from distributed_llm_inference_tpu.ops.quant_attention import (
    quantized_fused_decode_attention as jax_fused,
)
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa
from distributed_llm_inference_tpu_torch.ops import quant_attention as tqa

torch.set_num_threads(1)
L, B, HKV, D, PS, WIDTH, KT = 2, 4, 2, 16, 8, 6, 4
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Rows: fresh (nothing cached), continued, continued across a page edge
# during the window, and one that finished after its first step.
BASE = [0, 13, 38, 21]


def jx(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, getattr(jnp, dtype))


def tt(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def int8_planes(rng, lead, n, d=D):
    """int8 values and f32 scales as the cache stores them, ``lead + (n,
    d)`` / ``lead + (n,)``."""
    x = rng.standard_normal((2, *lead, n, d)).astype(np.float32)
    q, s = jax_quantize_kv(jnp.asarray(x))
    q, s = np.asarray(q), np.asarray(s)
    return q[0], s[0], q[1], s[1]


def table(rng):
    ids = rng.permutation(np.arange(1, 1 + B * WIDTH)).reshape(B, WIDTH)
    return ids.astype(np.int32)


def step_inputs(rng, g, dtype):
    q = rng.standard_normal((B, 1, HKV * g, D)).astype(np.float32)
    kn = rng.standard_normal((B, 1, HKV, D)).astype(np.float32)
    vn = rng.standard_normal((B, 1, HKV, D)).astype(np.float32)
    return q, kn, vn


def run_window(jax_fn, port_fn, big_np, rng, g, dtype, window, extra,
               base=BASE):
    """Three steps of a window through both sides; after each the outputs
    and the tails are compared. Row 3 stops after its first step."""
    tails_np = int8_planes(rng, (L, B, HKV), KT)
    tail_j = [jx(t) for t in tails_np]
    tail_t = [tt(t).clone() for t in tails_np]
    base = np.asarray(base, np.int32)
    tail_len = np.zeros(B, np.int32)
    alive = np.ones(B, np.int32)
    layer = 1
    for step in range(3):
        q, kn, vn = step_inputs(rng, g, dtype)
        num_new = alive.copy()
        vlen = tail_len + num_new
        qpos = base + tail_len
        out_j, *tail_j = jax_fn(
            jx(q, dtype), jx(kn, dtype), jx(vn, dtype),
            *[jx(a) for a in big_np], *tail_j,
            layer_idx=jnp.int32(layer), step_idx=jnp.int32(step),
            base_len=jx(base), tail_valid_len=jx(vlen),
            q_positions=jx(qpos), sliding_window=window, interpret=True,
            **{k: jx(v) for k, v in extra.items()})
        out_t, *tail_t = port_fn(
            tt(q, dtype), tt(kn, dtype), tt(vn, dtype),
            *[tt(a) for a in big_np], *tail_t,
            layer_idx=layer, step_idx=torch.tensor([step], dtype=torch.int32),
            base_len=tt(base), tail_valid_len=tt(vlen), q_positions=tt(qpos),
            sliding_window=window, **{k: tt(v) for k, v in extra.items()})
        np.testing.assert_allclose(
            out_t.float().numpy(), np.asarray(out_j, np.float32),
            atol=ATOL[dtype], rtol=0)
        for got, want in zip(tail_t, tail_j):
            want = np.asarray(want)
            if want.dtype == np.int8 and dtype == "float32":
                np.testing.assert_array_equal(got.numpy(), want)
            elif want.dtype == np.int8:
                diff = np.abs(got.numpy().astype(np.int32) - want)
                assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=0)
        tail_len += num_new
        alive[3] = 0
    return tail_t, tail_len


# (type, query heads per kv head, sliding window): every value of each
# axis, in fewer cases than their product (interpret mode takes seconds).
CASES = [("float32", 1, None), ("float32", 2, 9), ("float32", 1, 9),
         ("bfloat16", 2, None), ("bfloat16", 1, 9)]


@pytest.mark.parametrize("dtype,g,window", CASES)
def test_paged_fused_attention_matches_jax(dtype, g, window):
    rng = np.random.default_rng(10 * g + (window or 0))
    pages = 1 + B * WIDTH
    pool = int8_planes(rng, (L, pages, HKV), PS)
    before = tpa.fused_launches
    run_window(jax_paged_fused, tpa.quantized_paged_fused_attention, pool,
               rng, g, dtype, window, {"page_table": table(rng)})
    assert tpa.fused_launches == before, "no kernel runs on the CPU"


# Stack lengths: one tile, and two whole 256-wide tiles (interpret mode pads
# a partial last tile with NaN, which P V then carries into the output: the
# JAX kernel is held to whole tiles here, the port's partial tiles are
# compared on the card).
@pytest.mark.parametrize("dtype,g,window,t", [
    *((d, g, w, 48) for d, g, w in CASES[:3]), ("float32", 2, None, 512),
    ("bfloat16", 1, 9, 512)])
def test_gathered_fused_attention_matches_jax(dtype, g, window, t):
    rng = np.random.default_rng(100 * g + t + (window or 0))
    stacks = int8_planes(rng, (L, B, HKV), t)
    # Past 256 slots, live positions reach into the second tile too.
    base = BASE if t < 256 else [0, 260, 300, 255]
    run_window(jax_fused, tqa.quantized_fused_decode_attention, stacks,
               rng, g, dtype, window, {}, base)


def test_tail_flush_matches_jax_pool_bytes():
    """A window's tails through both flushes: every byte of the real pages
    equal, including pages no row touched. Row 3's position sits in an
    unmapped table slot: the JAX kernel writes it into the null page 0, the
    port writes nothing there (page 0 keeps its sentinel bytes)."""
    rng = np.random.default_rng(3)
    pages = 1 + B * WIDTH
    pool = [np.array(a) for a in int8_planes(rng, (L, pages, HKV), PS)]
    for a in pool:
        a[:, 0] = 7 if a.dtype == np.int8 else 0.5
    tails = int8_planes(rng, (L, B, HKV), KT)
    tab = table(rng)
    base = np.asarray(BASE, np.int32)           # row 2 crosses into page 5
    tail_len = np.asarray([4, 3, 4, 1], np.int32)
    tab[3, 2] = 0                               # row 3's slot: unmapped
    want = jax_flush(*[jx(a) for a in pool], *[jx(a) for a in tails],
                     jx(tab), jx(base), jx(tail_len), interpret=True)
    port = [tt(a).clone() for a in pool]
    before = tpa.flush_launches
    got = tpa.paged_tail_flush(*port, *[tt(a) for a in tails], tt(tab),
                               tt(base), tt(tail_len))
    assert tpa.flush_launches == before
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy()[:, 1:], np.asarray(w_)[:, 1:])
    assert (got[0][:, 0] == 7).all() and (got[1][:, 0] == 0.5).all()
    moved = sum(int((g_.numpy() != a).any(axis=-1).sum()) if a.ndim == 5
                else 0 for g_, a in zip(got, pool))
    assert moved > 0, "the flush wrote nothing"


def test_wrappers_refuse_what_the_kernel_does_not_take():
    q = torch.zeros((B, 1, HKV, D))
    kn = torch.zeros((B, 1, HKV, D))
    planes = [torch.zeros((L, B, HKV, 8, D), dtype=torch.int8),
              torch.zeros((L, B, HKV, 8)),
              torch.zeros((L, B, HKV, 8, D), dtype=torch.int8),
              torch.zeros((L, B, HKV, 8))]
    tail = [torch.zeros((L, B, HKV, KT, D), dtype=torch.int8),
            torch.zeros((L, B, HKV, KT)),
            torch.zeros((L, B, HKV, KT, D), dtype=torch.int8),
            torch.zeros((L, B, HKV, KT))]
    vec = torch.zeros((B,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim 128"):
        tqa.check_fused_inputs(
            "fused", q, kn, kn, (("big_k", planes[0], torch.int8),),
            (("base_len", vec),), torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device|device"):
        tqa.quantized_fused_decode_attention(
            q.to("meta"), kn, kn, *planes, *tail, 0,
            torch.zeros((1,), dtype=torch.int32), vec, vec, vec)


# ---------------------------------------------------------------------------
# The one-launch kernel's decomposition (csrc/fused_decode.cuh, the cluster
# section): a row's tiles dealt to the blocks of a cluster in turn, each
# block's tile maxima exchanged and their prefix maxima taken, each tile's
# sums scaled by exp(m_j - m_last), the blocks' sums added up. Held to the
# sequential walk of ``quantized_paged_fused_attention_plain``.
# ---------------------------------------------------------------------------

def row_tiles(base, vlen, qpos, window, ps, width, kt):
    """The kernel's Geometry: ``(vlo, n, is_tail)`` of each live tile of a
    row, in the walk's order: pages holding a live position inside the
    window, then the tail."""
    lo = max(0, qpos - window + 1) if window else 0
    hi = min(base, width * ps)
    first = (lo // ps) * ps
    nbig = -(-(hi - first) // ps) if hi > lo else 0
    tiles = [(max(lo, first + j * ps),
              min(hi, first + j * ps + ps) - max(lo, first + j * ps), False)
             for j in range(nbig)]
    vlen = min(vlen, kt)
    tlo = max(0, qpos - window + 1 - base) if window else 0
    if tlo < vlen:
        tiles.append((tlo, vlen - tlo, True))
    return tiles


def cluster_model(q, pool, tail, table, base, vlen, qpos, window, layer,
                  blocks):
    """Output ``[B, Hq, D]`` f32 of the cluster decomposition with
    ``blocks`` blocks a (row, kv head), and for every (row, kv head) the
    prefix maxima the exchange gives ``[tiles, G]`` beside the running
    maxima of the sequential walk."""
    pk, pks, pv, pvs = (x[layer] for x in pool)
    tk, tks, tv, tvs = (x[layer] for x in tail)
    b, hq, d = q.shape
    hkv, ps = pk.shape[1], pk.shape[2]
    g = hq // hkv
    qb = q.to(torch.bfloat16).float().reshape(b, hkv, g, d)
    out = torch.zeros(b, hkv, g, d)
    maxima = []
    for r in range(b):
        tiles = row_tiles(int(base[r]), int(vlen[r]), int(qpos[r]), window,
                          ps, table.shape[1], tk.shape[2])
        for h in range(hkv):
            def rows(tile):
                vlo, n, is_tail = tile
                if is_tail:
                    sl = slice(vlo, vlo + n)
                    return tk[r, h, sl], tks[r, h, sl], tv[r, h, sl], tvs[r, h, sl]
                page = int(table[r, vlo // ps])
                sl = slice(vlo % ps, vlo % ps + n)
                return pk[page, h, sl], pks[page, h, sl], pv[page, h, sl], pvs[page, h, sl]

            data = [rows(tile) for tile in tiles]
            # 1. each block scores its tiles (j % blocks == rank) and takes
            #    their maxima
            scores, tmax = {}, {}
            for rank in range(blocks):
                for j in range(rank, len(tiles), blocks):
                    k, ks = data[j][0], data[j][1]
                    s = tqa._lane_order_dot(qb[r, h][None, None], k[None, None])[0, 0]
                    scores[j] = s * ks[None, :] * d**-0.5
                    tmax[j] = scores[j].amax(-1)
            # 2. the exchange: every tile's max by index, prefix maxima
            pm, m = [], torch.full((g,), -0.7 * 3.4028234663852886e38)
            for j in range(len(tiles)):
                m = torch.maximum(m, tmax[j])
                pm.append(m)
            walk, m = [], torch.full((g,), -0.7 * 3.4028234663852886e38)
            for j in range(len(tiles)):       # the sequential walk's max
                m = torch.maximum(m, scores[j].amax(-1))
                walk.append(m)
            maxima.append((pm, walk))
            # 3. each block's sums, each tile scaled by exp(m_j - m_last)
            num, den = torch.zeros(g, d), torch.zeros(g)
            for rank in range(blocks):
                bnum, bden = torch.zeros(g, d), torch.zeros(g)
                for j in range(rank, len(tiles), blocks):
                    _, _, v, vs = data[j]
                    p = torch.exp(scores[j] - pm[j][:, None])
                    pw = (p * vs[None, :]).to(torch.bfloat16).float()
                    w = torch.exp(pm[j] - pm[-1])
                    bnum += w[:, None] * (pw @ v.float())
                    bden += w * p.sum(-1)
                # 4. the cluster adds up the blocks' sums
                num += bnum
                den += bden
            out[r, h] = num / den.clamp_min(1e-20)[:, None]
    return out.reshape(b, hq, d), maxima


# (ps, window, blocks, g, d): two query heads a kv head over every page
# size, window and cluster size; and the groupings 3, 7, 8 and head_dim 64
# (the kernel's 8-head instance scores 4 heads at a time; at D = 64 four
# lanes hold a position), over pages of 48 and 3 blocks, the windows in
# turn.
SPLIT_CASES = [(ps, window, blocks, 2, D) for blocks in (1, 3, 8)
               for window in (None, 37) for ps in (16, 48, 64)] + [
    (48, (None, 37)[i % 2], 3, g, d)
    for i, (g, d) in enumerate(((3, D), (7, D), (8, D), (4, 64), (8, 64)))]


@pytest.mark.parametrize(
    "ps,window,blocks,g,d", SPLIT_CASES,
    ids=[f"{c}-{w}-{ps}" + ("" if (g, d) == (2, D) else f"-g{g}d{d}")
         for ps, w, c, g, d in SPLIT_CASES])
def test_cluster_split_matches_the_walk(ps, window, blocks, g, d):
    """Rows: empty (nothing cached, no tail), tail only, short (fewer tiles
    than blocks), across pages, and long; a window that starts inside a
    page; 2 to 8 query heads per kv head, head_dim 16 and 64."""
    rng = np.random.default_rng(ps + blocks + (window or 0)
                                + ((g, d) != (2, D)) * (100 * g + d))
    b, width, kt = 5, 6, 8
    pages = 1 + b * width
    pool = [tt(x).clone() for x in int8_planes(rng, (L, pages, HKV), ps, d)]
    tail = [tt(x).clone() for x in int8_planes(rng, (L, b, HKV), kt, d)]
    tab = tt(table_for(rng, b, width, pages))
    base = torch.tensor([0, 0, 5, ps + 3, width * ps - 2], dtype=torch.int32)
    tail_len = torch.tensor([0, 3, 2, 5, 7], dtype=torch.int32)
    vlen = tail_len + torch.tensor([0, 1, 1, 1, 1], dtype=torch.int32)
    qpos = base + tail_len
    q, kn, vn = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for shape in ((b, 1, HKV * g, d), (b, 1, HKV, d),
                               (b, 1, HKV, d)))
    step = 3
    kw = dict(layer_idx=1, step_idx=torch.tensor([step], dtype=torch.int32),
              page_table=tab, base_len=base, tail_valid_len=vlen,
              q_positions=qpos, sliding_window=window)
    want, *tail_w = tpa.quantized_paged_fused_attention_plain(
        q, kn, vn, *pool, *[t.clone() for t in tail], **kw)
    got, maxima = cluster_model(q[:, 0], pool, tail_w, tab, base, vlen, qpos,
                                window, 1, blocks)
    np.testing.assert_allclose(got.numpy(), want[:, 0].numpy(), atol=2e-5,
                               rtol=0)
    assert (got[0] == 0).all(), "a row with no live tile gives zeros"
    for pm, walk in maxima:
        for a, w in zip(pm, walk):
            assert torch.equal(a, w)


def table_for(rng, b, width, pages):
    ids = rng.permutation(np.arange(1, pages)).reshape(b, width)
    return ids.astype(np.int32)


# ---------------------------------------------------------------------------
# The same one-launch decomposition over contiguous stacks (#9): the TPU
# kernel's tiles of min(256, T) positions, dealt to the cluster's 7 blocks as
# pieces of at most 64 positions (fused::kPiece) that never cross a tile's
# edge; a tile's max is the max of its pieces' maxima, so the running max
# at each tile, and every rounding of p * vs, stay the walk's. Held to the
# sequential walk of ``quantized_fused_decode_attention_plain`` and, on
# stacks of whole tiles, to the JAX kernel in interpret mode.
# ---------------------------------------------------------------------------

PIECE, CLUSTER = 64, 7  # fused::kPiece, fused::kCluster


def row_pieces(base, vlen, qpos, window, t, kt):
    """The kernel's Geometry over stacks of ``t`` positions: ``(vlo, n,
    tile, is_tail)`` of each piece of a row, in the walk's order."""
    tw = min(256, t)
    pw = min(PIECE, tw)
    lo = max(0, qpos - window + 1) if window else 0
    hi = min(base, t)
    first = (lo // tw) * tw
    nbig = -(-(hi - first) // tw) if hi > lo else 0
    fp = (lo // pw) * pw
    pieces = []
    for k in range(-(-(hi - fp) // pw) if hi > lo else 0):
        start = fp + k * pw
        vlo = max(lo, start)
        pieces.append((vlo, min(hi, start + pw) - vlo,
                       start // tw - first // tw, False))
    vlen = min(vlen, kt)
    tlo = max(0, qpos - window + 1 - base) if window else 0
    if tlo < vlen:
        for start in range((tlo // pw) * pw, vlen, pw):
            vlo = max(tlo, start)
            pieces.append((vlo, min(vlen, start + pw) - vlo, nbig, True))
    assert len({p[2] for p in pieces}) == (nbig + (tlo < vlen)), "tiles"
    return pieces


def contiguous_cluster_model(q, stacks, tail, base, vlen, qpos, window,
                             layer):
    """Output ``[B, Hq, D]`` f32 of the pieces dealt to the cluster's
    blocks, and for every (row, kv head) the running max each tile gets from
    the exchange ``[tiles, G]`` beside the sequential walk's."""
    sk, sks, sv, svs = (x[layer] for x in stacks)
    tk, tks, tv, tvs = (x[layer] for x in tail)
    b, hq, d = q.shape
    hkv, t = sk.shape[1], sk.shape[2]
    g = hq // hkv
    neg = torch.full((g,), -0.7 * 3.4028234663852886e38)
    qb = q.to(torch.bfloat16).float().reshape(b, hkv, g, d)
    out = torch.zeros(b, hkv, g, d)
    maxima = []
    for r in range(b):
        pieces = row_pieces(int(base[r]), int(vlen[r]), int(qpos[r]), window,
                            t, tk.shape[2])
        for h in range(hkv):
            def rows(vlo, n, is_tail):
                sl = slice(vlo, vlo + n)
                if is_tail:
                    return tk[r, h, sl], tks[r, h, sl], tv[r, h, sl], tvs[r, h, sl]
                return sk[r, h, sl], sks[r, h, sl], sv[r, h, sl], svs[r, h, sl]

            data = [rows(vlo, n, is_tail) for vlo, n, _, is_tail in pieces]
            # 1. each block scores its pieces (k % 7 == rank), and their maxima
            scores = []
            for k, ks, _, _ in data:
                s = tqa._lane_order_dot(qb[r, h][None, None], k[None, None])[0, 0]
                scores.append(s * ks[None, :] * d**-0.5)
            # 2. running maxima over the pieces; each piece takes the one at
            #    the end of its tile
            run, m = [], neg
            for s in scores:
                m = torch.maximum(m, s.amax(-1))
                run.append(m)
            tile_max = {}
            for k, (_, _, j, _) in enumerate(pieces):
                tile_max[j] = run[k]
            walk, m = [], neg             # the sequential walk's, by tile
            for j in sorted(tile_max):
                tile_scores = torch.cat([s for s, p in zip(scores, pieces)
                                         if p[2] == j], dim=-1)
                m = torch.maximum(m, tile_scores.amax(-1))
                walk.append(m)
            maxima.append(([tile_max[j] for j in sorted(tile_max)], walk))
            # 3. each block's sums, each piece under its tile's max, scaled
            #    by exp(m_j - m_last); 4. the cluster adds up the blocks'
            num, den = torch.zeros(g, d), torch.zeros(g)
            m_last = run[-1] if run else neg
            for rank in range(CLUSTER):
                bnum, bden = torch.zeros(g, d), torch.zeros(g)
                for k in range(rank, len(pieces), CLUSTER):
                    _, _, v, vs = data[k]
                    mj = tile_max[pieces[k][2]]
                    p = torch.exp(scores[k] - mj[:, None])
                    pw = (p * vs[None, :]).to(torch.bfloat16).float()
                    w = torch.exp(mj - m_last)
                    bnum += w[:, None] * (pw @ v.float())
                    bden += w * p.sum(-1)
                num += bnum
                den += bden
            out[r, h] = num / den.clamp_min(1e-20)[:, None]
    return out.reshape(b, hq, d), maxima


# (t, window, g, d): 1 and 4 query heads a kv head over every stack width
# and window; the groupings 3, 7, 8 and head_dim 64 over one width and
# window each.
CONTIGUOUS_CASES = [(t, window, g, D) for g in (1, 4) for window in (None, 37)
                    for t in (40, 256, 300, 640)] + [
    (t, (37, None)[i % 2], g, d)
    for i, ((g, d), t) in enumerate(zip(
        ((3, D), (7, D), (8, D), (4, 64), (8, 64)), (256, 300, 40, 40, 640)))]


@pytest.mark.parametrize(
    "t,window,g,d", CONTIGUOUS_CASES,
    ids=[f"{g if d == D else f'{g}d{d}'}-{w}-{t}"
         for t, w, g, d in CONTIGUOUS_CASES])
def test_contiguous_cluster_split_matches_the_walk(t, window, g, d):
    """Rows: empty (nothing cached, no tail), tail only, short (one piece),
    across pieces and tiles, and long (the last tile partial where T is not
    a multiple of 256); a window that starts inside a piece; 1 to 8 query
    heads per kv head, head_dim 16 and 64. Stacks of whole tiles (T = 40,
    256) also against the JAX kernel (its interpret mode pads a partial
    tile with NaN)."""
    rng = np.random.default_rng(t + 10 * g + (window or 0) + (d != D) * d)
    b, kt = 5, 8
    stacks = [tt(x).clone() for x in int8_planes(rng, (L, b, HKV), t, d)]
    tail = [tt(x).clone() for x in int8_planes(rng, (L, b, HKV), kt, d)]
    base = torch.tensor([0, 0, 5, t // 2 + 3, t - 2], dtype=torch.int32)
    tail_len = torch.tensor([0, 3, 2, 5, 7], dtype=torch.int32)
    vlen = tail_len + torch.tensor([0, 1, 1, 1, 1], dtype=torch.int32)
    qpos = base + tail_len
    q, kn, vn = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for shape in ((b, 1, HKV * g, d), (b, 1, HKV, d),
                               (b, 1, HKV, d)))
    step = 3
    kw = dict(layer_idx=1, step_idx=torch.tensor([step], dtype=torch.int32),
              base_len=base, tail_valid_len=vlen, q_positions=qpos,
              sliding_window=window)
    want, *tail_w = tqa.quantized_fused_decode_attention_plain(
        q, kn, vn, *stacks, *[x.clone() for x in tail], **kw)
    got, maxima = contiguous_cluster_model(q[:, 0], stacks, tail_w, base,
                                           vlen, qpos, window, 1)
    np.testing.assert_allclose(got.numpy(), want[:, 0].numpy(), atol=2e-5,
                               rtol=0)
    assert (got[0] == 0).all(), "a row with no live tile gives zeros"
    for pm, walk in maxima:
        assert len(pm) == len(walk)
        for a, w in zip(pm, walk):
            assert torch.equal(a, w)
    if t % 256 and t > 256:
        return
    out_j, *_ = jax_fused(
        jx(q.numpy()), jx(kn.numpy()), jx(vn.numpy()),
        *[jx(x.numpy()) for x in stacks], *[jx(x.numpy()) for x in tail],
        layer_idx=jnp.int32(1), step_idx=jnp.int32(step),
        base_len=jx(base.numpy()), tail_valid_len=jx(vlen.numpy()),
        q_positions=jx(qpos.numpy()), sliding_window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out_j)[:, 0],
                               atol=2e-5, rtol=0)
