"""Port parity: attention over int8 pages — ``quantized_paged_attention``,
``quantized_ragged_paged_attention`` (on CPU tensors, so their plain
versions) against the JAX package's Pallas kernels in interpret mode and its
oracle, and ``QuantizedPagedKVCache`` (scatter, attend, gather) against the
JAX cache, on the same numpy inputs. atol 2e-5: float32 on both sides,
another order of summation. Pool bytes written from the same rotated keys
are identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.cache.dense import _quantize_kv as jax_quantize_kv
from distributed_llm_inference_tpu.cache.paged import (
    QuantizedPagedKVCache as JaxQCache,
)
from distributed_llm_inference_tpu.ops import attention as jattn
from distributed_llm_inference_tpu.ops import rotary as jrot
from distributed_llm_inference_tpu.ops.paged_attention import (
    quantized_paged_attention as jax_qpaged,
)
from distributed_llm_inference_tpu.ops.ragged_attention import (
    quantized_ragged_paged_attention as jax_qragged,
    ragged_attention_reference as jax_reference,
)
from distributed_llm_inference_tpu_torch.cache.paged import QuantizedPagedKVCache
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa
from distributed_llm_inference_tpu_torch.ops import ragged_attention as tra
from distributed_llm_inference_tpu_torch.ops import rotary as trot
from distributed_llm_inference_tpu_torch.ops.attention import _NEG_INF, gqa_attention

torch.set_num_threads(1)
ATOL = 2e-5


def int8_pool(rng, pages, hkv, ps, d):
    """int8 pages and f32 scale planes as the cache stores them."""
    x = rng.standard_normal((2, pages, hkv, ps, d)).astype(np.float32)
    q, s = jax_quantize_kv(jnp.asarray(x))
    return tuple(np.array(a) for a in (q[0], s[0], q[1], s[1]))


def paged_inputs(seed, hq, hkv, lens, d=16, ps=8, width=5, pages=48):
    rng = np.random.default_rng(seed)
    b = len(lens)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    kp, ksp, vp, vsp = int8_pool(rng, pages, hkv, ps, d)
    table = (rng.permutation(pages - 1)[: b * width].reshape(b, width) + 1)
    return (q, kp, ksp, vp, vsp, table.astype(np.int32),
            np.asarray(lens, np.int32))


def convert(kw, fn):
    return {k: (fn(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


def paged_both(args, **kw):
    want = jax_qpaged(*[jnp.asarray(a) for a in args], interpret=True,
                      **convert(kw, jnp.asarray))
    before = tpa.quantized_launches
    got = tpa.quantized_paged_attention(*[torch.as_tensor(a) for a in args],
                                        **convert(kw, torch.as_tensor))
    assert tpa.quantized_launches == before, "a CPU call must not count"
    return got, want


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["G1", "G4"])
def test_paged_matches_jax_kernel_mixed_lengths_and_empty_row(hq, hkv):
    got, want = paged_both(paged_inputs(0, hq, hkv, [40, 17, 0, 8, 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(got[2].abs().max()) == 0.0


@pytest.mark.parametrize("past", [0, 5])
def test_paged_sliding_window_and_return_stats(past):
    args = paged_inputs(1, 8, 2, [40, 0, 9])
    kw = dict(sliding_window=12, return_stats=True)
    if past:
        kw["q_positions"] = (args[-1] - 1 + past).astype(np.int32)
    got, want = paged_both(args, **kw)
    for g, w, name in zip(got, want, ("out", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=1e-6, err_msg=name)
    out, m, l = got
    assert m.shape == (3, 2, 4) and float(l[1].max()) == 0.0
    assert np.allclose(m[1].numpy(), _NEG_INF)


def ragged_inputs(seed=0, hq=4, hkv=2):
    """A decode row, a chunked row, a full prefill, a short prefill and an
    empty row in one call."""
    rng = np.random.default_rng(seed)
    B, S, D, PS, P, T = 5, 16, 16, 8, 40, 6
    q = rng.standard_normal((B, S, hq, D)).astype(np.float32)
    kp, ksp, vp, vsp = int8_pool(rng, P, hkv, PS, D)
    table = (rng.permutation(P - 1)[: B * T].reshape(B, T) + 1).astype(np.int32)
    kv_len = np.asarray([40, 33, 16, 5, 0], np.int32)
    num_new = np.asarray([1, 16, 16, 5, 0], np.int32)
    return q, kp, ksp, vp, vsp, table, kv_len, num_new


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["G1", "G4"])
@pytest.mark.parametrize("sliding_window", [None, 12])
def test_ragged_matches_jax_kernel_and_oracle(hq, hkv, sliding_window):
    args = ragged_inputs(2, hq, hkv)
    q, kp, ksp, vp, vsp, table, kv_len, num_new = args
    kw = dict(sliding_window=sliding_window)
    before = tra.quantized_launches
    got = tra.quantized_ragged_paged_attention(
        *[torch.as_tensor(a) for a in args], **kw).numpy()
    assert tra.quantized_launches == before
    want = np.asarray(jax_qragged(*[jnp.asarray(a) for a in args],
                                  interpret=True, **kw))
    oracle = np.asarray(jax_reference(
        *[jnp.asarray(a) for a in (q, kp, vp, table, kv_len, num_new)],
        ks_pages=jnp.asarray(ksp), vs_pages=jnp.asarray(vsp), **kw))
    mine = tra.ragged_attention_reference(
        *[torch.as_tensor(a) for a in (q, kp, vp, table, kv_len, num_new)],
        ks_pages=torch.as_tensor(ksp), vs_pages=torch.as_tensor(vsp),
        **kw).numpy()
    for name, other in (("jax_kernel", want), ("jax_reference", oracle),
                        ("torch_reference", mine)):
        np.testing.assert_allclose(got, other, atol=ATOL, err_msg=name)
    pad = np.arange(q.shape[1])[None, :] >= num_new[:, None]
    assert np.abs(got[pad]).max() == 0.0


def test_ragged_explicit_q_start():
    args = ragged_inputs(3)
    q_start = np.asarray([39, 10, 0, 0, 0], np.int32)
    got = tra.quantized_ragged_paged_attention(
        *[torch.as_tensor(a) for a in args], q_start=torch.as_tensor(q_start))
    want = jax_qragged(*[jnp.asarray(a) for a in args],
                       q_start=jnp.asarray(q_start), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("page_size", [16, 48, 128])
def test_ragged_page_sizes_match_jax_kernel(page_size):
    """The page sizes whose TMA boxes the CUDA kernel cuts differently
    (gcd(PS, 64) rows), with rows off its 128-slot step: a 20-query prompt
    over 200 slots, a 17-query chunk, a decode row and an empty row, and a
    window of 40 that starts inside a step; atol 2e-5, f32 on both sides."""
    rng = np.random.default_rng(page_size)
    B, S, hq, hkv, D = 4, 20, 4, 2, 16
    kv_len = np.asarray([200, 150, 133, 0], np.int32)
    T = -(-int(kv_len.max()) // page_size) + 1
    P = B * T + 1
    q = rng.standard_normal((B, S, hq, D)).astype(np.float32)
    pool = int8_pool(rng, P, hkv, page_size, D)
    table = (rng.permutation(P - 1)[: B * T].reshape(B, T) + 1).astype(np.int32)
    args = (q, *pool, table, kv_len, np.asarray([20, 17, 1, 0], np.int32))
    got = tra.quantized_ragged_paged_attention(
        *[torch.as_tensor(a) for a in args], sliding_window=40).numpy()
    want = np.asarray(jax_qragged(*[jnp.asarray(a) for a in args],
                                  interpret=True, sliding_window=40))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(got[3]).max() == 0.0 and np.abs(got[2, 1:]).max() == 0.0


def test_wrappers_never_fall_back_for_other_devices():
    meta = [torch.as_tensor(a).to("meta") for a in paged_inputs(4, 4, 2, [5])]
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.quantized_paged_attention(*meta)
    rmeta = [torch.as_tensor(a).to("meta") for a in ragged_inputs(4)]
    with pytest.raises(ValueError, match="unsupported device"):
        tra.quantized_ragged_paged_attention(*rmeta)


def test_kernel_input_checks_for_int8_pools():
    check = tpa.check_kernel_inputs
    q = torch.zeros(1, 1, 8, 128)
    pool = torch.zeros(8, 2, 8, 128, dtype=torch.int8)
    sc = torch.zeros(8, 2, 8)
    table = torch.zeros(1, 4, dtype=torch.int32)
    vec = (("kv_lengths", torch.zeros(1, dtype=torch.int32)),)
    scales = (("ks_pages", sc), ("vs_pages", sc))
    assert check("t", q, pool, pool, table, vec, scales) == 1
    assert check("t", q.bfloat16(), pool, pool, table, vec, scales) == 0
    with pytest.raises(TypeError, match="int8"):
        check("t", q, pool.float(), pool.float(), table, vec, scales)
    with pytest.raises(TypeError):
        check("t", q, pool, pool, table, vec)  # int8 pools need scales
    with pytest.raises(ValueError, match="ks_pages"):
        check("t", q, pool, pool, table, vec,
              (("ks_pages", sc.bfloat16()), ("vs_pages", sc)))
    with pytest.raises(ValueError, match="vs_pages"):
        check("t", q, pool, pool, table, vec,
              (("ks_pages", sc), ("vs_pages", sc[:, :1].contiguous())))


# ---------------------------------------------------------------------------
# QuantizedPagedKVCache
# ---------------------------------------------------------------------------

L, B, P, PS, T, HKV, HQ, D = 2, 3, 24, 8, 4, 2, 4, 16


def make_pair(use_kernel, use_ragged, lengths, pages_per_row, hist):
    tc = QuantizedPagedKVCache.create(L, B, P, PS, T, HKV, D, torch.float32,
                                      use_kernel=use_kernel,
                                      use_ragged=use_ragged, device="cpu")
    jc = JaxQCache.create(L, B, P, PS, T, HKV, D, jnp.float32)
    nxt = 1
    for row, n in enumerate(pages_per_row):
        pages = list(range(nxt, nxt + n))
        nxt += n
        tc.assign_pages(row, pages)
        jc = jc.assign_pages(row, pages)
    tc.lengths.copy_(torch.as_tensor(np.asarray(lengths, np.int32)))
    planes = dict(zip(("k_pages", "ks_pages", "v_pages", "vs_pages"), hist))
    for name, plane in planes.items():
        getattr(tc, name).copy_(torch.as_tensor(plane))
    jc = jc.replace(lengths=jnp.asarray(lengths, jnp.int32),
                    **{k: jnp.asarray(v) for k, v in planes.items()})
    return tc, jc


def history(rng):
    x = rng.standard_normal((2, L, P, HKV, PS, D)).astype(np.float32)
    q, s = jax_quantize_kv(jnp.asarray(x))
    return [np.array(a) for a in (q[0], s[0], q[1], s[1])]


def attend_both(tc, jc, layer, q, k, v, num_new):
    s = q.shape[1]
    nn_t = torch.as_tensor(num_new)
    inv = trot.rope_inv_freq(D, 10000.0)
    qpos = tc.q_positions(s)
    cos, sin = trot.rope_cos_sin(tc.rope_positions(s, nn_t), inv)
    state = tuple(stack[layer] for stack in tc.layer_stacks)
    out_t, _ = tc.attend(
        state, torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        trot.RopeAngles(inv, cos, sin), qpos, nn_t, None, gqa_attention,
        D**-0.5)
    jinv = jrot.rope_inv_freq(D, 10000.0)
    jqpos = jc.q_positions(s)
    jcos, jsin = jrot.rope_cos_sin(jqpos, jinv)
    out_j, new = jc.attend(
        tuple(stack[layer] for stack in jc.layer_stacks), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v), jrot.RopeAngles(jinv, jcos, jsin),
        jqpos, jnp.asarray(num_new), None, jattn.gqa_attention, D**-0.5)
    return out_t, out_j, new


@pytest.mark.parametrize("s", [1, 6])
def test_cache_attend_kernel_route_gather_route_and_jax(s):
    rng = np.random.default_rng(0)
    lengths = [9, 0, 3]
    num_new = np.asarray([s, min(s, 2), 0], np.int32)  # row 2 inactive
    q = rng.standard_normal((B, s, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    hist = history(rng)
    kern, jc = make_pair(True, True, lengths, [3, 2, 1], hist)
    gath, _ = make_pair(False, False, lengths, [3, 2, 1], hist)
    out_k, out_j, new = attend_both(kern, jc, 1, q, k, v, num_new)
    out_g, _, _ = attend_both(gath, jc, 1, q, k, v, num_new)
    valid = np.arange(s)[None, :] < num_new[:, None]
    for out in (out_k, out_g):
        np.testing.assert_allclose(
            out.numpy()[valid], np.asarray(out_j)[valid], atol=ATOL)
    # The pool after the write: live pages equal the JAX cache's (values to
    # one step where rope rounds differently, scales to f32 rounding); only
    # the null page may differ (pad writes land there in any order).
    for cache in (kern, gath):
        for mine, theirs in zip(cache.layer_stacks, new):
            mine, theirs = mine[1].numpy()[1:], np.asarray(theirs)[1:]
            if mine.dtype == np.int8:
                assert np.abs(mine.astype(int) - theirs).max() <= 1
            else:
                np.testing.assert_allclose(mine, theirs, rtol=1e-6)
    # Layer 0 was not touched.
    np.testing.assert_array_equal(kern.k_pages[0].numpy(), hist[0][0])


def test_scatter_writes_the_jax_pool_bytes():
    """The same rotated keys and values in: identical int8 pages and f32
    scales out, on every page but the null one."""
    rng = np.random.default_rng(1)
    s = 5
    hist = history(rng)
    tc, jc = make_pair(True, True, [4, 7, 0], [2, 2, 1], hist)
    k = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    num_new = np.asarray([5, 3, 0], np.int32)
    planes = tuple(stack[0] for stack in tc.layer_stacks)
    tc._scatter_q(*planes, torch.as_tensor(k), torch.as_tensor(v),
                  tc.q_positions(s), torch.as_tensor(num_new))
    new = jc._scatter_q(*(stack[0] for stack in jc.layer_stacks),
                        jnp.asarray(k), jnp.asarray(v), jc.q_positions(s),
                        jnp.asarray(num_new))
    for mine, theirs in zip(planes, new):
        np.testing.assert_array_equal(mine.numpy()[1:], np.asarray(theirs)[1:])


def test_cache_routes_through_the_int8_wrappers(monkeypatch):
    calls = []
    real_r = tra.quantized_ragged_paged_attention
    real_p = tpa.quantized_paged_attention
    monkeypatch.setattr(
        tra, "quantized_ragged_paged_attention",
        lambda *a, **k: calls.append("ragged") or real_r(*a, **k))
    monkeypatch.setattr(
        tpa, "quantized_paged_attention",
        lambda *a, **k: calls.append("paged") or real_p(*a, **k))
    rng = np.random.default_rng(2)
    hist = history(rng)
    for s, kernel, ragged, want in [(1, True, True, ["paged"]),
                                    (4, True, True, ["ragged"]),
                                    (1, False, True, []),
                                    (4, True, False, [])]:
        calls.clear()
        tc, jc = make_pair(kernel, ragged, [5, 0, 0], [2, 1, 1], hist)
        q = rng.standard_normal((B, s, HQ, D)).astype(np.float32)
        kv = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
        attend_both(tc, jc, 0, q, kv, kv, np.asarray([s, 0, 0], np.int32))
        assert calls == want, (s, kernel, ragged)


def test_views_carry_all_four_planes():
    tc, _ = make_pair(False, False, [4, 7, 2], [2, 2, 1],
                      history(np.random.default_rng(3)))
    for sub in (tc.select_row(1), tc.select_rows([2, 0, B])):
        assert type(sub) is QuantizedPagedKVCache
        assert all(a is b for a, b in zip(sub.layer_stacks, tc.layer_stacks))
        assert len(sub.layer_stacks) == 4
    assert tc.ks_pages.dtype == torch.float32 and tc.k_pages.dtype == torch.int8
    assert tuple(tc.ks_pages.shape) == (L, P, HKV, PS)
