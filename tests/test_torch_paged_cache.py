"""Port parity: the paged KV cache and its page allocator against the JAX
package's, on the same numpy inputs (f32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.cache.paged import (
    PageAllocator as JaxAllocator,
    PagedKVCache as JaxCache,
)
from distributed_llm_inference_tpu.ops import attention as jattn
from distributed_llm_inference_tpu.ops import rotary as jrot
from distributed_llm_inference_tpu_torch.cache.base import window_ladder
from distributed_llm_inference_tpu_torch.cache.paged import (
    PageAllocator,
    PagedKVCache,
)
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa
from distributed_llm_inference_tpu_torch.ops import ragged_attention as tra
from distributed_llm_inference_tpu_torch.ops import rotary as trot
from distributed_llm_inference_tpu_torch.ops.attention import gqa_attention

torch.set_num_threads(1)
L, B, P, PS, T, HKV, HQ, D = 2, 3, 24, 8, 4, 2, 4, 16


def test_allocator_scripted_sequence_matches_jax():
    """One scripted alloc/free/register/lookup sequence through both
    allocators: same pages, same counts, same errors."""
    a, j = PageAllocator(12), JaxAllocator(12)
    log = []

    def both(name, *args):
        outs = []
        for alloc in (a, j):
            try:
                outs.append(getattr(alloc, name)(*args))
            except (MemoryError, ValueError) as e:
                outs.append(type(e).__name__)
        assert outs[0] == outs[1], (name, args, outs)
        assert a.free_count == j.free_count
        log.append(outs[0])
        return outs[0]

    tokens = list(range(40))
    keys = PageAllocator.chain_keys(tokens, 8)
    assert keys == JaxAllocator.chain_keys(tokens, 8) and len(keys) == 5
    first = both("alloc", 4)
    assert 0 not in first and first == [1, 2, 3, 4]
    second = both("alloc", 3)
    for page, key in zip(first, keys):
        both("register", page, key)
    both("free", first)                 # registered: evictable, not free
    assert both("lookup", keys[:3]) == first[:3]
    both("free", second)
    both("free", second)                # double free -> ValueError
    both("free", [0])                   # the null page -> ValueError
    both("alloc", 9)                    # more than free + evictable
    both("alloc", 8)                    # evicts the unreferenced cached page
    assert both("peek", keys[3]) is None
    assert both("lookup_one", keys[0]) == first[0]
    both("registered_keys")
    both("alloc", 1)                    # exhausted -> MemoryError
    assert "MemoryError" in log and "ValueError" in log


def test_window_ladder_matches_jax():
    from distributed_llm_inference_tpu.cache.base import window_ladder as jl

    for cap, custom, strict in [(4096, None, True), (100, None, True),
                                (64, (16, 200), True), (64, (), True),
                                (64, (128,), False)]:
        assert window_ladder(cap, custom, strict) == jl(cap, custom, strict)
    with pytest.raises(ValueError):
        window_ladder(64, (128,), True)


def make_pair(use_kernel, use_ragged, lengths, pages_per_row):
    """A torch cache and a JAX cache with the same tables and lengths."""
    tc = PagedKVCache.create(L, B, P, PS, T, HKV, D, torch.float32,
                             use_kernel=use_kernel, use_ragged=use_ragged,
                             device="cpu")
    jc = JaxCache.create(L, B, P, PS, T, HKV, D, jnp.float32)
    nxt = 1
    for row, n in enumerate(pages_per_row):
        pages = list(range(nxt, nxt + n))
        nxt += n
        tc.assign_pages(row, pages)
        jc = jc.assign_pages(row, pages)
    tc.lengths.copy_(torch.as_tensor(np.asarray(lengths, np.int32)))
    jc = jc.replace(lengths=jnp.asarray(lengths, jnp.int32))
    return tc, jc


def attend_both(tc, jc, layer, q, k, v, num_new):
    s = q.shape[1]
    nn_t = torch.as_tensor(num_new)
    inv = trot.rope_inv_freq(D, 10000.0)
    qpos = tc.q_positions(s)
    cos, sin = trot.rope_cos_sin(tc.rope_positions(s, nn_t), inv)
    out_t, _ = tc.attend(
        (tc.k_pages[layer], tc.v_pages[layer]), torch.as_tensor(q),
        torch.as_tensor(k), torch.as_tensor(v), trot.RopeAngles(inv, cos, sin),
        qpos, nn_t, None, gqa_attention, D**-0.5)
    jinv = jrot.rope_inv_freq(D, 10000.0)
    jqpos = jc.q_positions(s)
    jcos, jsin = jrot.rope_cos_sin(jqpos, jinv)
    out_j, (nk, nv) = jc.attend(
        (jc.k_pages[layer], jc.v_pages[layer]), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v), jrot.RopeAngles(jinv, jcos, jsin), jqpos,
        jnp.asarray(num_new), None, jattn.gqa_attention, D**-0.5)
    return out_t, out_j, nk, nv


@pytest.mark.parametrize("s", [1, 6])
def test_attend_kernel_route_equals_gather_route_and_jax(s):
    rng = np.random.default_rng(0)
    lengths = [9, 0, 3]
    num_new = np.asarray([s, min(s, 2), 0], np.int32)  # row 2 inactive
    q = rng.standard_normal((B, s, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    kern, jc = make_pair(True, True, lengths, [3, 2, 1])
    gath, _ = make_pair(False, False, lengths, [3, 2, 1])
    # Some history in the pool, the same on all three.
    hist = rng.standard_normal((2, L, P, HKV, PS, D)).astype(np.float32)
    for c in (kern, gath):
        c.k_pages.copy_(torch.as_tensor(hist[0]))
        c.v_pages.copy_(torch.as_tensor(hist[1]))
    jc = jc.replace(k_pages=jnp.asarray(hist[0]), v_pages=jnp.asarray(hist[1]))

    out_k, out_j, nk, nv = attend_both(kern, jc, 1, q, k, v, num_new)
    out_g, _, _, _ = attend_both(gath, jc, 1, q, k, v, num_new)
    valid = np.arange(s)[None, :] < num_new[:, None]
    for out in (out_k, out_g):
        np.testing.assert_allclose(
            out.numpy()[valid], np.asarray(out_j)[valid], atol=2e-5)
    np.testing.assert_allclose(
        out_k.numpy()[valid], out_g.numpy()[valid], atol=2e-5)
    # The pool after the write: live pages equal the JAX cache's; only the
    # null page may differ (pad writes land there in any order).
    for mine, theirs in ((kern.k_pages[1], nk), (kern.v_pages[1], nv),
                         (gath.k_pages[1], nk), (gath.v_pages[1], nv)):
        np.testing.assert_allclose(
            mine.numpy()[1:], np.asarray(theirs)[1:], atol=1e-6)
    # Layer 0 was not touched.
    np.testing.assert_array_equal(kern.k_pages[0].numpy(), hist[0][0])


def test_attend_routes_through_the_wrappers(monkeypatch):
    calls = []
    real_r, real_p = tra.ragged_paged_attention, tpa.paged_attention
    monkeypatch.setattr(
        tra, "ragged_paged_attention",
        lambda *a, **k: calls.append("ragged") or real_r(*a, **k))
    monkeypatch.setattr(
        tpa, "paged_attention",
        lambda *a, **k: calls.append("paged") or real_p(*a, **k))
    rng = np.random.default_rng(1)
    for s, kernel, ragged, want in [(1, True, True, ["paged"]),
                                    (4, True, True, ["ragged"]),
                                    (1, False, True, []),
                                    (4, True, False, [])]:
        calls.clear()
        tc, jc = make_pair(kernel, ragged, [5, 0, 0], [2, 1, 1])
        q = rng.standard_normal((B, s, HQ, D)).astype(np.float32)
        kv = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
        attend_both(tc, jc, 0, q, kv, kv, np.asarray([s, 0, 0], np.int32))
        assert calls == want, (s, kernel, ragged)


def test_inactive_and_pad_writes_land_on_the_null_page_only():
    rng = np.random.default_rng(2)
    tc, _ = make_pair(True, True, [4, 7, 0], [2, 2, 1])
    before_k = tc.k_pages.clone()
    s = 5
    k = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    num_new = torch.as_tensor(np.asarray([0, 3, 0], np.int32))
    qpos = tc.q_positions(s)
    page, off = tc._slot_pages(qpos, num_new)
    # Row 1 owns pages 3, 4: its 3 real tokens sit at positions 7, 8, 9.
    assert page[1, :3].tolist() == [3, 4, 4] and off[1, :3].tolist() == [7, 0, 1]
    assert page[0].tolist() == [0] * s and page[2].tolist() == [0] * s
    assert page[1, 3:].tolist() == [0, 0]
    tc._scatter(tc.k_pages[0], tc.v_pages[0], torch.as_tensor(k),
                torch.as_tensor(k), qpos, num_new)
    changed = (tc.k_pages[0] != before_k[0]).flatten(1).any(dim=1)
    assert sorted(torch.nonzero(changed).flatten().tolist()) == [0, 3, 4]
    # Positions past the table divert too, instead of wrapping or clamping
    # onto a live page.
    far = torch.full((B, 1), T * PS + 3, dtype=torch.int32)
    page, _ = tc._slot_pages(far, torch.ones(B, dtype=torch.int32))
    assert page.flatten().tolist() == [0, 0, 0]


def test_row_views_share_the_pool_and_merge_tables_only():
    tc, jc = make_pair(False, False, [4, 7, 2], [2, 2, 1])
    sub = tc.select_rows([2, 0, B])          # B = out-of-range padding row
    jsub = jc.select_rows(jnp.asarray([2, 0, B]))
    np.testing.assert_array_equal(sub.page_table.numpy(), np.asarray(jsub.page_table))
    np.testing.assert_array_equal(sub.lengths.numpy(), np.asarray(jsub.lengths))
    assert sub.k_pages is tc.k_pages
    add = np.asarray([3, 1, 5], np.int32)
    sub.advance(torch.as_tensor(add))
    jsub = jsub.advance(jnp.asarray(add))
    assert tc.lengths.tolist() == [4, 7, 2], "the view owns its lengths"
    tc.merge_rows(sub, [2, 0, B])
    jc = jc.merge_rows(jsub, jnp.asarray([2, 0, B]))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tc.page_table.numpy(), np.asarray(jc.page_table))
    one = tc.select_row(1)
    one.advance(torch.as_tensor(np.asarray([2], np.int32)))
    tc.merge_row(one, 1)
    assert tc.lengths.tolist() == [5, 9, 5]
    tc.reset_rows(torch.arange(B) == 1)
    jc = jc.reset_rows(jnp.arange(B) == 1)
    assert tc.lengths.tolist() == [5, 0, 5] and tc.page_table[1].tolist() == [0] * T
    np.testing.assert_array_equal(tc.page_table.numpy(), np.asarray(jc.page_table))
    tc.assign_pages_batch([1, 1, 0], [0, 1, 2], [9, 10, 11])
    jc = jc.assign_pages_batch([1, 1, 0], [0, 1, 2], [9, 10, 11], pad_to=4)
    np.testing.assert_array_equal(tc.page_table.numpy(), np.asarray(jc.page_table))
    assert bool(tc.fits(torch.as_tensor(np.asarray([27, 32, 28], np.int32))).tolist() == [True, True, False])


def test_create_requires_the_device_it_names():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        PagedKVCache.create(L, B, P, PS, T, HKV, D)
