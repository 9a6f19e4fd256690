"""Port parity, the three tail flushes' shared CUDA kernel: a step-by-step
CPU model of ``csrc/tail_flush.cuh``'s ``tail_flush_kernel<WORDS, Dest>``
and of its launch (``launch_tail_flush``), under the three destination
policies of the port's sources: ``PagedDest`` (``paged_tail_flush``, #7,
``csrc/paged_attention.cu``), ``DenseDest`` (``fused_tail_flush``, #10,
``csrc/quant_attention.cu``) and ``sink::RingDest`` (``sink_tail_flush``,
#12, ``csrc/sink_attention.cu``).

The model walks the kernel's grid as the card runs it: blocks ``(kv-head
group, row b, layer l)`` of ``hb`` heads (the launch's rule: as many heads
as one pass of ``WORDS`` 16-byte words of K and of V a thread covers,
within ``[1, Hkv]``), passes ``r0`` over the block's ``hb * KT`` contiguous
tail rows, threads ``t`` and words ``u``; every load first (asserted inside
the tail planes), then the row's scalars read once through the policy,
then each word's destination (``Dest::at``, with C's integer division and
remainder) and its stores. Each policy's index arithmetic is written as the
kernel writes it.

It is held byte for byte against the JAX package's Pallas kernels in
interpret mode (``paged_tail_flush``, ``fused_tail_flush``,
``sink_tail_flush``) and against the port's wrappers on the CPU (their plain
versions), and every live (layer, row, kv head, slot, 16-byte chunk) and
scale must be written exactly once, nothing else. Cases: KT = 1, 16, 48
and 80 (one head a block and passes of up to five a block), Hkv = 3 with 2
heads a block (a partial last group), D = 64, 128 and 256; rows in-block,
block-spanning, empty, edge-partial, at and past the buffer's end; ring
pointers near the ring's end, sink-bound heads (``skip > 0``), rings with
padding slots (never written); null (0) and out-of-pool page ids, and rows
past the table's width. The JAX paged kernel writes a null entry's slot
into page 0, and an out-of-pool id's into the last page (its block index
clamps): both pages are left out of that comparison, and no row maps the
last page. The JAX ring kernel visits the pointer's 32-slot block, the
next and block 0: its cases use rings that those visits cover.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.ops.paged_attention import (
    paged_tail_flush as jax_paged_flush,
)
from distributed_llm_inference_tpu.ops.quant_attention import (
    fused_tail_flush as jax_dense_flush,
    sink_tail_flush as jax_sink_flush,
)
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa
from distributed_llm_inference_tpu_torch.ops import quant_attention as tqa

torch.set_num_threads(1)

K_THREADS = 128  # flush::kThreads
WORDS = 2        # FLUSH_WORDS
L = 2
# (KT, Hkv, D) of each case: one head a block at KT = 48 and 80 in 2-5
# passes, a partial last group (3 heads, 2 a block), 3 and 4 heads a block.
WIDTHS = [(1, 3, 128), (16, 3, 128), (16, 4, 64), (48, 2, 128),
          (80, 2, 64), (16, 2, 256), (80, 1, 256)]
# tools/torch_cluster_sweep.py's FLUSH_FORMS: (words a thread, heads a block).
FLUSH_FORMS = ((2, 0), (1, 1), (2, 1), (4, 1), (4, 2), (4, 4), (8, 8))


def c_div(a, b):
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def c_mod(a, b):
    """C's remainder (the sign of the dividend)."""
    return a - b * c_div(a, b)


def heads_a_block(hkv, kt, d, words=WORDS, heads=0):
    """``flush::heads_a_block``: ``heads`` (FLUSH_HEADS) or as many kv
    heads as one pass of ``words`` words a thread covers, in [1, Hkv]."""
    per_head = kt * (d // 16)
    hb = heads if heads > 0 else words * K_THREADS // per_head
    return 1 if hb < 1 else hkv if hb > hkv else hb


class PagedDest:
    """``PagedDest`` (csrc/paged_attention.cu)."""

    def __init__(self, table, base_len, tail_len, num_p, hkv, ps):
        self.table, self.base_len, self.tail_len = table, base_len, tail_len
        self.P, self.Hkv, self.PS, self.Tw = num_p, hkv, ps, table.shape[1]

    def row(self, b):
        return int(self.base_len[b]), int(self.tail_len[b])

    def at(self, r, l, b, h, i):
        start, n = r
        pos = start + i
        slot = c_div(pos, self.PS)
        if i >= n or slot >= self.Tw:
            return -1
        page = int(self.table.reshape(-1)[b * self.Tw + slot])
        if page <= 0 or page >= self.P:
            return -1
        return ((l * self.P + page) * self.Hkv + h) * self.PS + c_mod(pos, self.PS)


class DenseDest:
    """``DenseDest`` (csrc/quant_attention.cu)."""

    def __init__(self, base_len, tail_len, b, hkv, t):
        self.base_len, self.tail_len = base_len, tail_len
        self.B, self.Hkv, self.T = b, hkv, t

    def row(self, b):
        return int(self.base_len[b]), int(self.tail_len[b])

    def at(self, r, l, b, h, i):
        start, n = r
        pos = start + i
        if i >= n or pos < 0 or pos >= self.T:
            return -1
        return ((l * self.B + b) * self.Hkv + h) * self.T + pos


class RingDest:
    """``sink::RingDest`` (csrc/sink_attention.cu)."""

    def __init__(self, ring_ptr, skip, tail_len, b, hkv, tr, ring_slots):
        self.ring_ptr, self.skip, self.tail_len = ring_ptr, skip, tail_len
        self.B, self.Hkv, self.TR, self.ring_slots = b, hkv, tr, ring_slots

    def row(self, b):
        return max(int(self.skip[b]), 0), int(self.tail_len[b]), int(self.ring_ptr[b])

    def at(self, r, l, b, h, i):
        first, end, ptr = r
        if i < first or i >= end:
            return -1
        slot = c_mod(ptr + i - first, self.ring_slots)
        if slot < 0:
            return -1
        return ((l * self.B + b) * self.Hkv + h) * self.TR + slot


def model_flush(dst, tail, dest, words=WORDS, heads=0):
    """``launch_tail_flush`` + ``tail_flush_kernel<words, Dest>`` on copies
    of the destination planes ``dst`` (k, ks, v, vs). Returns the new
    planes and the count of stores to each ("kv" word, "s" scale) index."""
    num_l, b, hkv, kt, d = tail[0].shape
    assert d % 16 == 0 and d // 16 <= words * K_THREADS and b <= 65535
    chunks = d // 16
    out = [np.array(a) for a in dst]
    ok = out[0].reshape(-1, 16)          # 16-byte words
    ov = out[2].reshape(-1, 16)
    oks, ovs = out[1].reshape(-1), out[3].reshape(-1)
    tk, tv = tail[0].reshape(-1, 16), tail[2].reshape(-1, 16)
    tks, tvs = tail[1].reshape(-1), tail[3].reshape(-1)
    hb = heads_a_block(hkv, kt, d, words, heads)
    rows = K_THREADS * words // chunks   # tail rows a pass
    stores = collections.Counter()
    for l in range(num_l):
        for bi in range(b):
            for x in range(-(-hkv // hb)):
                h0 = x * hb
                total = min(hb, hkv - h0) * kt
                src0 = ((l * b + bi) * hkv + h0) * kt
                row = None
                for r0 in range(0, total, rows):
                    nwords = min(rows, total - r0) * chunks
                    loaded = {}
                    for t in range(K_THREADS):
                        for u in range(words):
                            w = u * K_THREADS + t
                            if w < nwords:
                                src = (src0 + r0) * chunks + w
                                assert src < tk.shape[0]
                                loaded[t, u] = [tk[src], tv[src]]
                            if w < rows and r0 + w < total:
                                assert src0 + r0 + w < tks.shape[0]
                                loaded.setdefault((t, u), [None, None]).extend(
                                    [tks[src0 + r0 + w], tvs[src0 + r0 + w]])
                    if r0 == 0:
                        row = dest.row(bi)
                    for t in range(K_THREADS):
                        for u in range(words):
                            w = u * K_THREADS + t
                            if w < nwords:
                                j = r0 + w // chunks
                                at = dest.at(row, l, bi, h0 + j // kt, j % kt)
                                if at >= 0:
                                    word = at * chunks + w % chunks
                                    ok[word], ov[word] = loaded[t, u][:2]
                                    stores["kv", word] += 1
                            if w < rows and r0 + w < total:
                                j = r0 + w
                                at = dest.at(row, l, bi, h0 + j // kt, j % kt)
                                if at >= 0:
                                    oks[at], ovs[at] = loaded[t, u][2:]
                                    stores["s", at] += 1
    return out, stores


def assert_written_once(stores, live, chunks):
    """``live``: the destination rows the flush's contract names (each a
    (layer, row, head, slot)'s). Every word and scale of them is stored
    exactly once, nothing else."""
    assert live, "the case writes nothing"
    want = {("s", at) for at in live}
    want |= {("kv", at * chunks + c) for at in live for c in range(chunks)}
    assert set(stores) == want and set(stores.values()) == {1}


def planes(rng, lead, n, d):
    mk = lambda: rng.integers(-128, 128, (*lead, n, d)).astype(np.int8)
    sc = lambda: rng.random((*lead, n)).astype(np.float32)
    return [mk(), sc(), mk(), sc()]


def jx(a):
    return jnp.asarray(a)


def tt(a):
    return torch.from_numpy(np.array(a))


def assert_planes_equal(got, want, keep=Ellipsis):
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g_)[keep], np.asarray(w_)[keep])


@pytest.mark.parametrize("kt,hkv,d", WIDTHS)
def test_paged_flush_model_matches_jax(kt, hkv, d):
    """#7: a fresh row, one across a page edge, an empty tail, a window
    over a null table entry, one over an out-of-pool id, one past the
    table's width, a partial tail. Pages of at least KT slots (the JAX
    kernel's limit)."""
    rng = np.random.default_rng(kt * 1000 + hkv * 10 + d)
    ps = 16 if kt <= 16 else 64 if kt <= 64 else 128
    b, width = 7, 6
    num_p = b * width + 2                        # page num_p - 1: unmapped
    table = (1 + rng.permutation(b * width)).reshape(b, width).astype(np.int32)
    base = np.asarray([0, ps - 3, 5, 2 * ps + 1, ps - 1, width * ps - 2, 7],
                      np.int32)
    tl = np.asarray([kt, kt, 0, kt, kt, kt, max(kt // 2, 1)], np.int32)
    table[3, 2] = 0                              # a null entry in the window
    table[4, 1] = num_p                          # an id outside the pool
    dst = planes(rng, (L, num_p, hkv), ps, d)
    tail = planes(rng, (L, b, hkv), kt, d)
    got, stores = model_flush(dst, tail, PagedDest(table, base, tl, num_p, hkv, ps))
    live = [((l * num_p + table[bi, (base[bi] + i) // ps]) * hkv + h) * ps
            + (base[bi] + i) % ps
            for l in range(L) for bi in range(b) for h in range(hkv)
            for i in range(tl[bi]) if (base[bi] + i) // ps < width
            and 0 < table[bi, (base[bi] + i) // ps] < num_p]
    assert_written_once(stores, live, d // 16)
    want = jax_paged_flush(*[jx(a) for a in dst], *[jx(a) for a in tail],
                           jx(table), jx(base), jx(tl), interpret=True)
    assert_planes_equal(got, want, np.s_[:, 1:num_p - 1])
    # Pages 0 and num_p - 1 keep their bytes.
    assert_planes_equal(got, dst, np.s_[:, [0, num_p - 1]])
    port = [tt(a) for a in dst]
    before = tpa.flush_launches
    tpa.paged_tail_flush(*port, *[tt(a) for a in tail],
                         tt(np.where(table >= num_p, 0, table)), tt(base),
                         tt(tl))
    assert tpa.flush_launches == before
    assert_planes_equal(got, [p.numpy() for p in port])


@pytest.mark.parametrize("kt,hkv,d", WIDTHS)
def test_dense_flush_model_matches_jax(kt, hkv, d):
    """#10: windows in one 32-slot block, across blocks, empty,
    edge-partial, ending at the buffer's end, running past it, and past it
    whole."""
    rng = np.random.default_rng(kt * 1000 + hkv * 10 + d + 1)
    t = 160 if kt <= 48 else 256
    base = np.asarray([33, 30, 70, t - 10, t - kt, t - 5, t + 3], np.int32)
    tl = np.asarray([kt, kt, 0, min(10, kt), kt, kt, kt], np.int32)
    b = len(base)
    dst = planes(rng, (L, b, hkv), t, d)
    tail = planes(rng, (L, b, hkv), kt, d)
    got, stores = model_flush(dst, tail, DenseDest(base, tl, b, hkv, t))
    live = [((l * b + bi) * hkv + h) * t + base[bi] + i
            for l in range(L) for bi in range(b) for h in range(hkv)
            for i in range(tl[bi]) if base[bi] + i < t]
    assert_written_once(stores, live, d // 16)
    want = jax_dense_flush(*[jx(a) for a in dst], *[jx(a) for a in tail],
                           jx(base), jx(tl), interpret=True)
    assert_planes_equal(got, want)
    port = [tt(a) for a in dst]
    before = tqa.flush_launches
    tqa.fused_tail_flush(*port, *[tt(a) for a in tail], tt(base), tt(tl))
    assert tqa.flush_launches == before
    assert_planes_equal(got, [p.numpy() for p in port])


# Rings (ring_slots, TR) of each case: 1020 of 1024 at the widths of
# Llama-3-8B's cases, 50 and 90 with padding, 64 without.
RINGS = {(1, 3, 128): (1020, 1024), (16, 3, 128): (1020, 1024),
         (16, 4, 64): (50, 64), (48, 2, 128): (50, 64), (80, 2, 64): (64, 64),
         (16, 2, 256): (90, 96), (80, 1, 256): (50, 64)}


@pytest.mark.parametrize("kt,hkv,d", WIDTHS)
def test_sink_flush_model_matches_jax(kt, hkv, d):
    """#12: a window 3 slots before the ring's end (it wraps), 1 before,
    sink-bound heads of 1 and of KT tokens, an empty tail, a window that
    ends at the ring's end, a partial tail; every tail at most
    ring_slots past its sink-bound head."""
    r, tr = RINGS[kt, hkv, d]
    rng = np.random.default_rng(kt * 1000 + hkv * 10 + d + 2)
    ptr = np.asarray([r - 3, r - 1, 0, 0, 17, (r - kt) % r, 5], np.int32)
    skip = np.asarray([0, 0, 1, kt, 0, 0, 0], np.int32)
    tl = np.minimum(np.asarray([kt, kt, kt, kt, 0, kt, max(kt // 2, 1)]),
                    skip + r).astype(np.int32)
    b = len(ptr)
    dst = planes(rng, (L, b, hkv), tr, d)
    tail = planes(rng, (L, b, hkv), kt, d)
    got, stores = model_flush(dst, tail, RingDest(ptr, skip, tl, b, hkv, tr, r))
    live = [((l * b + bi) * hkv + h) * tr + (ptr[bi] + i - skip[bi]) % r
            for l in range(L) for bi in range(b) for h in range(hkv)
            for i in range(skip[bi], tl[bi])]
    assert_written_once(stores, live, d // 16)
    assert_planes_equal(got, dst, np.s_[:, :, :, r:])      # padding untouched
    want = jax_sink_flush(*[jx(a) for a in dst], *[jx(a) for a in tail],
                          jx(ptr), jx(skip), jx(tl), r, interpret=True)
    assert_planes_equal(got, want)
    port = [tt(a) for a in dst]
    before = tqa.sink_flush_launches
    tqa.sink_tail_flush(*port, *[tt(a) for a in tail], tt(ptr), tt(skip),
                        tt(tl), r)
    assert tqa.sink_flush_launches == before
    assert_planes_equal(got, [p.numpy() for p in port])


@pytest.mark.parametrize("words,heads", FLUSH_FORMS)
def test_every_flush_form_writes_the_same_bytes(words, heads):
    """The sweep's forms (other words a thread and heads a block, rebuilt
    with FLUSH_WORDS / FLUSH_HEADS) move the same bytes as the rule, each
    live word once: the three policies over 3 kv heads, KT = 48, D = 64."""
    rng = np.random.default_rng(words * 10 + heads)
    kt, hkv, d, b, t, ps, r = 48, 3, 64, 3, 160, 64, 50
    tail = planes(rng, (L, b, hkv), kt, d)
    table = (1 + rng.permutation(b * 3)).reshape(b, 3).astype(np.int32)
    lens, tl = np.asarray([0, 40, 100], np.int32), np.asarray([kt, 30, kt], np.int32)
    ptr, skip = np.asarray([r - 3, 0, 9], np.int32), np.asarray([0, 2, 0], np.int32)
    for dst, dest in (
            (planes(rng, (L, b * 3 + 1, hkv), ps, d),
             PagedDest(table, lens, tl, b * 3 + 1, hkv, ps)),
            (planes(rng, (L, b, hkv), t, d), DenseDest(lens, tl, b, hkv, t)),
            (planes(rng, (L, b, hkv), 64, d),
             RingDest(ptr, skip, tl, b, hkv, 64, r))):
        rule, rule_stores = model_flush(dst, tail, dest)
        got, stores = model_flush(dst, tail, dest, words, heads)
        assert_planes_equal(got, rule)
        assert stores == rule_stores and set(stores.values()) == {1}


def test_launch_rule_at_the_main_path_shape():
    """One window of Llama-3-8B (Hkv = 8, D = 128, KT = 16) takes 2 heads a
    block: at L = 32, B = 8, 1024 blocks of one pass each; the rule's
    heads a block at the other widths, and the forms' explicit heads
    clamped to Hkv."""
    hb = heads_a_block(8, 16, 128)
    assert hb == 2 and -(-8 // hb) * 8 * 32 == 1024
    assert 2 * K_THREADS // (128 // 16) == hb * 16       # one pass a block
    assert [heads_a_block(h, kt, d) for kt, h, d in WIDTHS] == [3, 2, 4, 1, 1, 1, 1]
    assert heads_a_block(3, 16, 128, 8, 8) == 3 and heads_a_block(3, 80, 64, 1) == 1
