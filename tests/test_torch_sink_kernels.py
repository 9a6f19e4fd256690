"""Port parity, the int8 sink ring's kernels and its fused window: the plain
versions of ``sink_fused_decode_attention`` (#11) and ``sink_tail_flush``
(#12) against the JAX package's Pallas kernels in interpret mode, and
``multi_decode_apply`` over ``QuantizedSinkKVCache`` against the JAX one,
on the same numpy inputs (CPU tensors, so the wrappers take their plain
versions).

#11 is held over four steps of a window (KT = 8) at TR = 64 (a ring span of
50: one 64-wide tile), rows in the sink phase, partly filled, wrapped with
the evicted range crossing the ring's end, and one that stops after its
first step; 1 and 2 query heads per kv head, and no sinks at all. Outputs
within 2e-5 in f32 (both sides round q and p * vs to bf16 at the same
points over the same tiles and sum in another order), 2e-2 in bf16; the
tail's int8 values EQUAL from f32 inputs (from bf16 inputs within 1 LSB on
at most 1% of the values) and its scales within 1e-6 relative (XLA's jit
rewrites the division by 127), as ``test_torch_fused_attention``
explains. #12 byte-equal to the JAX kernel and to the cache's own gather
and select (the JAX cache's ``_ring_flush_xla``): a pointer near the
ring's end, sink-bound heads (``skip > 0``), an empty tail, a span that is
not a multiple of 32. The window: identical tokens and planes, the kernel
form and the segments form, with a one-token prompt whose tail flushes
into the sink planes and a row that stops inside a window. #11's CUDA
kernel is one launch of the cluster kernel of ``csrc/fused_decode.cuh``:
its split of a row into pieces (ring pieces of 64 or 32 slots, the sinks,
the tail) dealt to 7 blocks is modelled step by step and held to the walk
(every tile's running max EQUAL, outputs within 2e-5) and to the JAX
kernel. The planes the
model computed: int8 values within 1 LSB, scales within 1e-5 relative (the
projections sum in another order, about 1e-6 relative after some 50
positions of f32 hidden states)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.cache import sink as jsink
from distributed_llm_inference_tpu.cache.dense import _quantize_kv as jax_quantize_kv
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu.ops.quant_attention import (
    sink_fused_decode_attention as jax_sink_fused,
    sink_tail_flush as jax_sink_flush,
)
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache import sink as tsink
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import quant_attention as tqa

torch.set_num_threads(1)
L, B, HKV, D, KT, SP = 2, 4, 2, 16, 8, 32
R, TR = 50, 64
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def jx(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, getattr(jnp, dtype))


def tt(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def int8_planes(rng, lead, n, d=D):
    x = rng.standard_normal((2, *lead, n, d)).astype(np.float32)
    q, s = (np.array(a) for a in jax_quantize_kv(jnp.asarray(x)))
    return q[0], s[0], q[1], s[1]


# Stream lengths at the window's start: a row in the sink phase, a partly
# filled ring, a wrapped ring whose pointer sits 2 slots before the ring's
# end (the evicted range crosses it from step 2 on), a row that stops after
# its first step.
BASE = [1, 30, 2 + 3 * R + 48, 77]


def check_steps(dtype, g, sinks, seed):
    rng = np.random.default_rng(seed)
    ring = int8_planes(rng, (L, B, HKV), TR)
    sink = int8_planes(rng, (L, B, HKV), SP)
    tail_np = int8_planes(rng, (L, B, HKV), KT)
    tail_j = [jx(t) for t in tail_np]
    tail_t = [tt(t).clone() for t in tail_np]
    base = np.asarray(BASE, np.int32)
    tail_len = np.zeros(B, np.int32)
    alive = np.ones(B, np.int32)
    ring_len = np.clip(base - sinks, 0, R).astype(np.int32)
    ring_ptr = (np.maximum(base - sinks, 0) % R).astype(np.int32)
    sink_len = np.minimum(base, sinks).astype(np.int32)
    layer = 1
    for step in range(4):
        q, qs = (rng.standard_normal((B, 1, HKV * g, D)).astype(np.float32)
                 for _ in range(2))
        kn, vn = (rng.standard_normal((B, 1, HKV, D)).astype(np.float32)
                  for _ in range(2))
        evict = tail_len + alive
        scalars = dict(ring_len=ring_len, ring_ptr=ring_ptr, evict_len=evict,
                       sink_len=sink_len, tail_valid_len=evict)
        out_j, *tail_j = jax_sink_fused(
            jx(q, dtype), jx(qs, dtype), jx(kn, dtype), jx(vn, dtype),
            *[jx(a) for a in ring], *[jx(a) for a in sink], *tail_j,
            layer_idx=jnp.int32(layer), step_idx=jnp.int32(step),
            ring_slots=R, interpret=True,
            **{k: jx(v) for k, v in scalars.items()})
        before = tqa.sink_launches
        out_t, *tail_t = tqa.sink_fused_decode_attention(
            tt(q, dtype), tt(qs, dtype), tt(kn, dtype), tt(vn, dtype),
            *[tt(a) for a in ring], *[tt(a) for a in sink], *tail_t,
            layer_idx=layer, step_idx=torch.tensor([step], dtype=torch.int32),
            ring_slots=R, **{k: tt(v) for k, v in scalars.items()})
        assert tqa.sink_launches == before, "no kernel runs on the CPU"
        np.testing.assert_allclose(
            out_t.float().numpy(), np.asarray(out_j, np.float32),
            atol=ATOL[dtype], rtol=0)
        for got, want in zip(tail_t, tail_j):
            want = np.asarray(want)
            if want.dtype != np.int8:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=0)
            elif dtype == "float32":
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                diff = np.abs(got.numpy().astype(np.int32) - want)
                assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
        tail_len += alive
        alive[3] = 0


# (type, query heads per kv head, sinks): every value of each axis.
@pytest.mark.parametrize("dtype,g,sinks", [
    ("float32", 1, 2), ("float32", 2, 2), ("float32", 2, 0),
    ("bfloat16", 2, 2)])
def test_sink_fused_decode_attention_matches_jax(dtype, g, sinks):
    check_steps(dtype, g, sinks, seed=10 * g + sinks)


def test_ring_tile_width_follows_the_tpu_kernel():
    assert [tqa.ring_tile_width(t) for t in (32, 64, 96, 1024, 1056, 160)] == [
        32, 64, 96, 256, 96, 160]


def test_ring_piece_width_divides_the_tile():
    for tr in (32, 64, 96, 160, 1024, 1056, 2048):
        tile = tqa.ring_tile_width(tr)
        pw = tqa.ring_piece_width(tile)
        assert tile % pw == 0 and pw in (32, 64), (tr, tile, pw)
    assert [tqa.ring_piece_width(tqa.ring_tile_width(t))
            for t in (1024, 1056)] == [64, 32]


# ---------------------------------------------------------------------------
# #11's one-launch decomposition (csrc/sink_attention.cu, sink::Ring over
# csrc/fused_decode.cuh's cluster kernel): the ring's tiles of
# ring_tile_width slots dealt to the cluster's 7 blocks as pieces of
# ring_piece_width slots below ring_len (never across a tile's edge), then
# the sinks below sink_len and the tail below tail_valid_len, one piece each
# (the sinks scored with q_sink); each piece's max exchanged, each tile
# given the running max at its last piece, each piece's sums scaled by
# exp(m_j - m_last). Held to the sequential walk of
# ``sink_fused_decode_attention_plain`` (every tile's running max EQUAL,
# outputs within 2e-5) and, its tiles all whole, to the JAX kernel in
# interpret mode.
# ---------------------------------------------------------------------------

CLUSTER = 7  # fused::kCluster
NEG = -0.7 * 3.4028234663852886e38


def ring_pieces(ring_len, sink_len, vlen, tr, sp, kt):
    """sink::RingGeo: ``(segment, vlo, n, tile)`` of each piece of a row in
    the walk's order; ring tiles are numbered by their first slot's tile,
    the sinks and the tail by the walk's tiles after the ring."""
    tile = tqa.ring_tile_width(tr)
    pw = tqa.ring_piece_width(tile)
    length = max(0, min(ring_len, tr))
    pieces = [("ring", vlo, min(length, vlo + pw) - vlo, vlo // tile)
              for vlo in range(0, length, pw)]
    nsink, vlen = max(0, min(sink_len, sp)), max(0, min(vlen, kt))
    if nsink:
        pieces.append(("sink", 0, nsink, tr // tile))
    if vlen:
        pieces.append(("tail", 0, vlen, tr // tile + 1))
    return pieces


def ring_cluster_model(q, q_sink, ring, sink, tail, scalars, ring_slots,
                       layer):
    """Output ``[B, Hq, D]`` f32 of the pieces dealt to the cluster's
    blocks, and for every (row, kv head) the running max each tile gets from
    the exchange beside the sequential walk's ``[(tile, exchange, walk)]``.
    ``tail`` holds the step's slot already (the plain version wrote it)."""
    rk, rks, rv, rvs = (x[layer] for x in ring)
    sk, sks, sv, svs = (x[layer] for x in sink)
    tk, tks, tv, tvs = (x[layer] for x in tail)
    b, hq, d = q.shape
    hkv, tr, sp, kt = rk.shape[1], rk.shape[2], sk.shape[2], tk.shape[2]
    g = hq // hkv
    tile = tqa.ring_tile_width(tr)
    neg = torch.full((g,), NEG)
    queries = [x.to(torch.bfloat16).float().reshape(b, hkv, g, d)
               for x in (q, q_sink)]
    ring_len, ring_ptr, evict, sink_len, vlen = (
        [int(v) for v in scalars[k]] for k in
        ("ring_len", "ring_ptr", "evict_len", "sink_len", "tail_valid_len"))
    out = torch.zeros(b, hkv, g, d)
    maxima = []

    def ring_live(r, vlo, n):
        slot = torch.arange(vlo, vlo + n)
        dd = slot - ring_ptr[r]
        dd = dd + torch.where(dd < 0, ring_slots, 0)
        return (slot < ring_len[r]) & (dd >= evict[r])

    for r in range(b):
        pieces = ring_pieces(ring_len[r], sink_len[r], vlen[r], tr, sp, kt)
        for h in range(hkv):
            data = []
            for seg, vlo, n, _ in pieces:
                sl = slice(vlo, vlo + n)
                planes = {"ring": (rk, rks, rv, rvs), "sink": (sk, sks, sv, svs),
                          "tail": (tk, tks, tv, tvs)}[seg]
                live = (ring_live(r, vlo, n) if seg == "ring"
                        else torch.ones(n, dtype=torch.bool))
                data.append((*(x[r, h, sl] for x in planes), live,
                             queries[seg == "sink"][r, h]))
            # 1. scores of each piece (masked slots kNegInf), its max
            scores = []
            for k, ks, _, _, live, qb in data:
                s = tqa._lane_order_dot(qb[None, None], k[None, None])[0, 0]
                scores.append(torch.where(live[None], s * ks[None] * d**-0.5,
                                          NEG))
            # 2. running maxima over the pieces; each tile takes the one at
            #    its last piece
            run, m = [], neg
            for s in scores:
                m = torch.maximum(m, s.amax(-1))
                run.append(m)
            tile_max = {}
            for k, piece in enumerate(pieces):
                tile_max[piece[3]] = run[k]
            # the sequential walk's running max after each tile, over whole
            # tiles as the plain version walks them
            walk, m = {}, neg
            for j in range(tr // tile + 2):
                if j < tr // tile:
                    sl, qb = slice(j * tile, (j + 1) * tile), queries[0][r, h]
                    k, ks = rk[r, h, sl], rks[r, h, sl]
                    live = ring_live(r, j * tile, tile)
                elif j == tr // tile:
                    qb, k, ks = queries[1][r, h], sk[r, h], sks[r, h]
                    live = torch.arange(sp) < sink_len[r]
                else:
                    qb, k, ks = queries[0][r, h], tk[r, h], tks[r, h]
                    live = torch.arange(kt) < vlen[r]
                s = tqa._lane_order_dot(qb[None, None], k[None, None])[0, 0]
                s = torch.where(live[None], s * ks[None] * d**-0.5, NEG)
                m = torch.maximum(m, s.amax(-1))
                walk[j] = m
            maxima.append([(j, tile_max[j], walk[j]) for j in sorted(tile_max)])
            # 3. each block's sums (piece k on block k % 7), each piece under
            #    its tile's max, scaled by exp(m_j - m_last); 4. the
            #    cluster's sum of the blocks'
            num, den = torch.zeros(g, d), torch.zeros(g)
            m_last = run[-1] if run else neg
            for rank in range(CLUSTER):
                bnum, bden = torch.zeros(g, d), torch.zeros(g)
                for k in range(rank, len(pieces), CLUSTER):
                    _, _, v, vs, live, _ = data[k]
                    mj = tile_max[pieces[k][3]]
                    p = torch.where(live[None], torch.exp(scores[k] - mj[:, None]),
                                    0.0)
                    pw = (p * vs[None, :]).to(torch.bfloat16).float()
                    w = torch.exp(mj - m_last)
                    bnum += w[:, None] * (pw @ v.float())
                    bden += w * p.sum(-1)
                num += bnum
                den += bden
            out[r, h] = num / den.clamp_min(1e-20)[:, None]
    return out.reshape(b, hq, d), maxima


# (tr, sinks, g, d): 1 and 4 query heads a kv head over both rings, with
# sinks and without; the groupings 3, 7, 8 and head_dim 64 with sinks.
RING_CASES = [(tr, sinks, g, D) for g in (1, 4) for sinks in (4, 0)
              for tr in (1024, 1056)] + [
    (tr, 4, g, d) for (g, d), tr in zip(((3, D), (7, D), (8, D), (4, 64)),
                                        (1056, 1024, 1056, 1024))]


@pytest.mark.parametrize(
    "tr,sinks,g,d", RING_CASES,
    ids=[f"{g if d == D else f'{g}d{d}'}-{sinks}-{tr}"
         for tr, sinks, g, d in RING_CASES])
def test_ring_cluster_split_matches_the_walk(tr, sinks, g, d):
    """Rows: empty (nothing cached, no tail), sink-only (no ring, no tail),
    tail-only, short (one or two pieces), full with the pointer 3 slots
    before the ring's end (the evicted range wraps past it), and full with
    the pointer on a piece's edge and an in-flight tail of 71 that evicts
    that piece whole (every slot of it masked: an exact no-op); 1 to 8
    query heads per kv head, head_dim 16 and 64; TR = 1024 (256-wide tiles,
    pieces of 64) and 1056 (96-wide tiles, pieces of 32)."""
    rng = np.random.default_rng(tr + 10 * sinks + g + (d != D) * d)
    b, kt = 6, 80
    r = tr - 4 if tr == 1024 else tr - 6     # the ring's span: 1020, 1050
    ring = [tt(x).clone() for x in int8_planes(rng, (L, b, HKV), tr, d)]
    sink = [tt(x).clone() for x in int8_planes(rng, (L, b, HKV), SP, d)]
    tail = [tt(x).clone() for x in int8_planes(rng, (L, b, HKV), kt, d)]
    base = np.asarray([0, 2, 0, sinks + 40, sinks + 3 * r - 3,
                       sinks + r + 128], np.int64)
    tail_len = np.asarray([0, 0, 3, 2, 5, 70], np.int32)
    alive = np.asarray([0, 0, 1, 1, 1, 1], np.int32)
    evict = tail_len + alive
    scalars = {
        "ring_len": np.clip(base - sinks, 0, r).astype(np.int32),
        "ring_ptr": (np.maximum(base - sinks, 0) % r).astype(np.int32),
        "evict_len": evict,
        "sink_len": np.minimum(base, sinks).astype(np.int32),
        "tail_valid_len": evict}
    if sinks == 0:
        assert scalars["sink_len"].max() == 0
    q, qs, kn, vn = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                     for shape in ((b, 1, HKV * g, d), (b, 1, HKV * g, d),
                                   (b, 1, HKV, d), (b, 1, HKV, d)))
    step = 2
    kw = dict(layer_idx=1, step_idx=torch.tensor([step], dtype=torch.int32),
              ring_slots=r, **{k: tt(v) for k, v in scalars.items()})
    want, *tail_w = tqa.sink_fused_decode_attention_plain(
        q, qs, kn, vn, *ring, *sink, *[x.clone() for x in tail], **kw)
    got, maxima = ring_cluster_model(q[:, 0], qs[:, 0], ring, sink, tail_w,
                                     scalars, r, 1)
    np.testing.assert_allclose(got.numpy(), want[:, 0].numpy(), atol=2e-5,
                               rtol=0)
    assert (got[0] == 0).all(), "a row with nothing to attend gives zeros"
    for row in maxima:
        for _, exchange, walk in row:
            assert torch.equal(exchange, walk)
    # The last row's piece from slot 128 lies inside ring_len and is
    # evicted whole (its pointer is 128, its evict_len past a piece).
    pw = tqa.ring_piece_width(tqa.ring_tile_width(tr))
    pieces = ring_pieces(int(scalars["ring_len"][5]), 0, 0, tr, SP, kt)
    assert ("ring", 128, pw, 128 // tqa.ring_tile_width(tr)) in pieces
    assert scalars["ring_ptr"][5] == 128 and evict[5] >= pw
    out_j, *_ = jax_sink_fused(
        jx(q.numpy()), jx(qs.numpy()), jx(kn.numpy()), jx(vn.numpy()),
        *[jx(x.numpy()) for x in ring], *[jx(x.numpy()) for x in sink],
        *[jx(x.numpy()) for x in tail], layer_idx=jnp.int32(1),
        step_idx=jnp.int32(step), ring_slots=r, interpret=True,
        **{k: jx(v) for k, v in scalars.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(out_j)[:, 0],
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("kt", [8, 16])
def test_sink_tail_flush_matches_jax(kt):
    """Rows: a pointer 3 slots before the ring's end (the tail wraps to slot
    0), sink-bound heads of 1 and of kt tokens, an empty tail, a full tail
    from slot 0."""
    rng = np.random.default_rng(kt)
    mk = lambda *s: rng.integers(-100, 100, s).astype(np.int8)
    big = [mk(L, 5, HKV, TR, D), rng.random((L, 5, HKV, TR)).astype(np.float32),
           mk(L, 5, HKV, TR, D), rng.random((L, 5, HKV, TR)).astype(np.float32)]
    tail = [mk(L, 5, HKV, kt, D), rng.random((L, 5, HKV, kt)).astype(np.float32),
            mk(L, 5, HKV, kt, D), rng.random((L, 5, HKV, kt)).astype(np.float32)]
    ring_ptr = np.asarray([R - 3, 0, 0, 17, 0], np.int32)
    skip = np.asarray([0, 1, kt, 0, 0], np.int32)
    tail_len = np.asarray([kt, kt, kt, 0, kt], np.int32)
    want = jax_sink_flush(*[jx(a) for a in big], *[jx(a) for a in tail],
                          jx(ring_ptr), jx(skip), jx(tail_len), R,
                          interpret=True)
    port = [tt(a).clone() for a in big]
    before = tqa.sink_flush_launches
    got = tqa.sink_tail_flush(*port, *[tt(a) for a in tail], tt(ring_ptr),
                              tt(skip), tt(tail_len), R)
    assert tqa.sink_flush_launches == before
    # The cache's own gather-and-select merge, on a cache over copies.
    cache = tsink.QuantizedSinkKVCache(
        *(tt(a).clone() for a in (big[0], big[2], big[1], big[3])),
        *(torch.zeros(1) for _ in range(4)), torch.zeros(5, dtype=torch.int32),
        2, R)
    for plane, tl in zip((cache.k, cache.ks, cache.v, cache.vs), tail):
        cache._ring_flush_rows(plane, tt(tl), tt(tail_len), tt(skip),
                               tt(ring_ptr))
    for g_, w_, c_, a in zip(got, want, (cache.k, cache.ks, cache.v, cache.vs),
                             big):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        np.testing.assert_array_equal(c_.numpy(), np.asarray(w_))
        assert (g_.numpy()[:, :, :, R:] == a[:, :, :, R:]).all(), "padding"
    assert (got[0].numpy() != big[0]).any(), "the flush wrote nothing"


@pytest.mark.parametrize("use_kernel", [True, False])
def test_cache_tail_flush_of_a_wide_tail_matches_jax(use_kernel, monkeypatch):
    """``QuantizedSinkKVCache.tail_flush`` at KT = 48, wider than the TPU
    kernel's 32-slot blocks (the JAX cache takes its gather-and-select
    there): the kernel form still goes through ``sink_tail_flush``, and
    both forms place the bytes the JAX cache places, ring and sink planes
    alike. Rows: empty, in the sink phase (a sink-bound head), a pointer 3
    slots before the ring's end, a wrapped ring."""
    kt, s = 48, 2
    rng = np.random.default_rng(48)
    mk = lambda *sh: rng.integers(-100, 100, sh).astype(np.int8)
    fl = lambda *sh: rng.random(sh).astype(np.float32)
    planes = dict(k=mk(L, B, HKV, TR, D), v=mk(L, B, HKV, TR, D),
                  ks=fl(L, B, HKV, TR), vs=fl(L, B, HKV, TR),
                  sk=mk(L, B, HKV, SP, D), sv=mk(L, B, HKV, SP, D),
                  sks=fl(L, B, HKV, SP), svs=fl(L, B, HKV, SP))
    tail = (mk(L, B, HKV, kt, D), mk(L, B, HKV, kt, D), fl(L, B, HKV, kt),
            fl(L, B, HKV, kt))
    lengths = np.asarray([0, 1, s + R - 3, s + 3 * R + 11], np.int32)
    tail_len = np.asarray([kt, 5, kt, 30], np.int32)
    jc = jsink.QuantizedSinkKVCache.create(L, B, R + s, s, HKV, D)
    jc = jc.replace(lengths=jx(lengths), **{n: jx(a) for n, a in planes.items()})
    want = jc.tail_flush(tuple(jx(a) for a in tail), jx(tail_len))
    tc = tsink.QuantizedSinkKVCache.create(L, B, R + s, s, HKV, D,
                                           use_kernel=use_kernel, device="cpu")
    for name, a in planes.items():
        getattr(tc, name).copy_(tt(a))
    tc.lengths.copy_(tt(lengths))
    seen = []
    real = tqa.sink_tail_flush
    monkeypatch.setattr(tqa, "sink_tail_flush",
                        lambda *a: seen.append(1) or real(*a))
    tc.tail_flush(tuple(tt(a) for a in tail), tt(tail_len))
    assert len(seen) == (1 if use_kernel else 0)
    for name in (*planes, "lengths"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert (tc.sk.numpy() != planes["sk"]).any(), "no sink-bound head"


# ---------------------------------------------------------------------------
# The fused window over the int8 ring
# ---------------------------------------------------------------------------

HQ = 4
MODEL = dict(vocab_size=64, hidden_size=32, intermediate_size=96,
             num_layers=L, num_heads=HQ, num_kv_heads=HKV, head_dim=8)
JCFG, TCFG = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
JPARAMS = jllama.init_params(JCFG, jax.random.PRNGKey(1), dtype=jnp.float32)
TPARAMS = tllama.params_from_numpy(
    TCFG, jax.tree_util.tree_map(np.asarray, JPARAMS), torch.float32, "cpu")


@pytest.fixture
def calls(monkeypatch):
    counts = {}
    for name in ("sink_fused_decode_attention", "sink_tail_flush"):
        real = getattr(tqa, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(tqa, name, spy)
    return counts


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "segments"])
def test_multi_decode_apply_matches_jax(use_kernel, calls):
    """Window 40 with 2 sinks (r = 38, TR = 64), three windows of K = 8
    after a prefill of 30, 1 and 17 tokens: the first row wraps, the second
    flushes its head into the sinks, the third stops two steps into the
    second window and stays idle. Tokens identical every window, planes
    equal at the end."""
    window, sinks, k_steps = 40, 2, 8
    jc = jsink.QuantizedSinkKVCache.create(L, 3, window, sinks, HKV, 8,
                                           use_kernel=use_kernel)
    tc = tsink.QuantizedSinkKVCache.create(L, 3, window, sinks, HKV, 8,
                                           use_kernel=use_kernel, device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 64, (3, 30)).astype(np.int32)
    n = np.asarray([30, 1, 17], np.int32)
    # The JAX side jitted, one program for the three windows (the budget an
    # argument): its tokens and planes equal its eager run's.
    _, jc = jax.jit(lambda c: jllama.model_apply(
        JCFG, JPARAMS, jnp.asarray(tokens), c, jnp.asarray(n)))(jc)
    _, tc = tllama.model_apply(TCFG, TPARAMS, tt(tokens), tc, tt(n))
    first = rng.integers(0, 64, (3, 1)).astype(np.int32)
    jt, ttok = jnp.asarray(first), tt(first)

    @jax.jit
    def jwindow(tok, cache, active, budget):
        def jstep(i, logits, alive):
            nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            emitted = jnp.where(alive, nxt, -1)
            alive = alive & (i + 1 < budget)
            return nxt, alive.astype(jnp.int32), alive, emitted

        return jllama.multi_decode_apply(
            JCFG, JPARAMS, tok, cache, k_steps, jstep, active,
            active.astype(jnp.int32))

    for w in range(3):
        budget = np.asarray([k_steps, k_steps, 2 if w == 1 else
                             (k_steps if w == 0 else 0)], np.int32)
        active = budget > 0

        def tstep(i, logits, alive, _b=tt(budget)):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            emitted = torch.where(alive, nxt, -1)
            alive = alive & (i + 1 < _b)
            return nxt, alive.to(torch.int32), alive, emitted

        want, jc = jwindow(jt, jc, jnp.asarray(active), jnp.asarray(budget))
        got, tc = tllama.multi_decode_apply(
            TCFG, TPARAMS, ttok, tc, k_steps, tstep, tt(active),
            tt(active.astype(np.int32)))
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"window {w}")
        last = np.where(want[-1] >= 0, want[-1], 0)[:, None].astype(np.int32)
        jt, ttok = jnp.asarray(last), tt(last)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    assert tc.lengths.tolist() == [30 + 24, 1 + 24, 17 + 10]
    for name in tsink.QuantizedSinkKVCache.PLANE_FIELDS:
        got, want = getattr(tc, name).numpy(), np.asarray(getattr(jc, name))
        if got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                       err_msg=name)
    if use_kernel:
        assert calls == {"sink_fused_decode_attention": 3 * k_steps * L,
                         "sink_tail_flush": 3}
    else:
        assert calls == {}
