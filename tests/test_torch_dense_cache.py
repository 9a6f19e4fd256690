"""Port parity, the dense caches: ``cache/dense.py`` (``DenseKVCache`` in the
model dtype, ``QuantizedDenseKVCache`` int8 head-major) against the JAX
package's classes, and the int8 cache's two new kernels' plain versions
(``quantized_decode_attention``, #8; ``fused_tail_flush``, #10) against the
Pallas kernels in interpret mode, on the same numpy inputs (f32, CPU).

Covered: ``_write`` at S=1 with inactive rows (one at a full buffer's end)
and a padded prefill that runs past the buffer's end; ``grow_to``;
``select_rows``/``merge_rows`` with out-of-range padding rows;
``reset_rows`` and ``fits``; ``attend`` through ``model_apply`` on the
int8-score path, on the decode kernel's route, on the gather path and, for
a prefill of 1024 tokens, through the flash kernel; both forms of the
write-behind tail through ``multi_decode_apply`` (the kernel form over the
whole buffers, and the per-layer segments form); and the plain attention
functions ``gqa_attention_quantized`` / ``gqa_attention_segments``.

Tolerances: buffers that only move values (writes, growth, row ops, the
flush) are byte-equal; logits and attention outputs 2e-5 absolute (the same
f32 products, summed in another order); K/V the model computed within
1e-5 in the model dtype (its projections sum in another order), and, int8,
within 1 LSB with scales within 1e-6 relative (those sums, and XLA's jit
may rewrite ``_quantize_kv``'s division, so a rounding tie can fall the
other way). Emitted tokens of the fused window must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.cache import dense as jdense
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu.ops import attention as jattn
from distributed_llm_inference_tpu.ops import quant_attention as jqa
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache import dense as tdense
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import attention as tattn
from distributed_llm_inference_tpu_torch.ops import flash_attention as tfa
from distributed_llm_inference_tpu_torch.ops import quant_attention as tqa

torch.set_num_threads(1)
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
JCFG, TCFG = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
JPARAMS = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
TPARAMS = tllama.params_from_numpy(
    TCFG, jax.tree_util.tree_map(np.asarray, JPARAMS), torch.float32, "cpu")
L, B, H, D = 2, 4, 2, 16
ATOL = 2e-5
KINDS = ["model_dtype", "int8"]


def tt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_caches(kind, t, lengths, seed=0):
    """A JAX cache and the port's of ``kind`` over the same random
    contents, width ``t``, ``lengths`` [B]."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lengths, np.int32)
    if kind == "model_dtype":
        k, v = (rng.standard_normal((L, B, t, H, D)).astype(np.float32)
                for _ in range(2))
        return (jdense.DenseKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                    lengths=jnp.asarray(lens)),
                tdense.DenseKVCache(tt(k).clone(), tt(v).clone(), tt(lens)))
    k, v = (rng.integers(-127, 128, (L, B, H, t, D)).astype(np.int8)
            for _ in range(2))
    ks, vs = (rng.random((L, B, H, t)).astype(np.float32) for _ in range(2))
    j = jdense.QuantizedDenseKVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), ks=jnp.asarray(ks),
        vs=jnp.asarray(vs), lengths=jnp.asarray(lens))
    p = tdense.QuantizedDenseKVCache(tt(k).clone(), tt(v).clone(),
                                     tt(ks).clone(), tt(vs).clone(), tt(lens))
    return j, p


def assert_same(jc, tc, computed=False):
    """Every plane and the lengths: byte-equal, or, for K/V the model
    computed, int8 values within 1 LSB, their scales within 1e-6 relative
    and model-dtype values within 1e-5."""
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for name in tc.PLANE_FIELDS:
        got = getattr(tc, name).numpy()
        want = np.asarray(getattr(jc, name))
        assert got.shape == want.shape, name
        if not computed:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
        elif name in ("ks", "vs"):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Writes and row operations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_decode_write_inactive_rows_write_nothing(kind):
    """S=1: active rows write at their offset; inactive rows write nothing,
    including row 2, whose offset sits at a full buffer's end (a clamped
    write there would overwrite its last token)."""
    t = 16
    jc, tc = random_caches(kind, t, [0, 5, t, 9])
    num_new = np.asarray([1, 0, 0, 1], np.int32)
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    if kind == "int8":
        vals = (vals * 50).astype(np.int8)
        scales = rng.random((B, 1, H)).astype(np.float32)
    for i, name in enumerate(tc.PLANE_FIELDS):
        new = scales if name in ("ks", "vs") else vals
        want = jc._write(getattr(jc, name)[i % L], jnp.asarray(new),
                         jnp.asarray(num_new))
        got = tc._write(getattr(tc, name)[i % L], tt(new), tt(num_new))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.data_ptr() == getattr(tc, name)[i % L].data_ptr()


@pytest.mark.parametrize("kind", KINDS)
def test_padded_prefill_past_the_buffer_end(kind):
    """A chunk padded to 8 tokens: row 1's runs past the buffer's end (only
    the positions below T are written), row 2 writes 2 of its 8, row 3
    (full, inactive) nothing."""
    t = 16
    jc, tc = random_caches(kind, t, [0, t - 3, 5, t])
    num_new = np.asarray([8, 8, 2, 0], np.int32)
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((B, 8, H, D)).astype(np.float32)
    if kind == "int8":
        vals = (vals * 50).astype(np.int8)
        scales = rng.random((B, 8, H)).astype(np.float32)
    for name in tc.PLANE_FIELDS:
        new = scales if name in ("ks", "vs") else vals
        want = jc._write(getattr(jc, name)[1], jnp.asarray(new),
                         jnp.asarray(num_new))
        got = tc._write(getattr(tc, name)[1], tt(new), tt(num_new))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
def test_grow_to_pads_every_plane(kind):
    jc, tc = random_caches(kind, 32, [3, 32, 0, 17])
    anchor = tc.window_anchor
    jc = jc.grow_to(64)
    assert tc.grow_to(64) is tc and tc.max_len == 64 == jc.max_len
    assert tc.window_anchor is not anchor, "growth replaces the buffers"
    assert_same(jc, tc)
    assert tc.grow_to(48) is tc and tc.max_len == 64  # never shrinks


@pytest.mark.parametrize("kind", KINDS)
def test_select_merge_rows_with_padding(kind):
    """A compact copy of rows 2 and 0 padded with two out-of-range rows:
    the gather clamps them, the merge drops them, as the JAX cache does."""
    jc, tc = random_caches(kind, 16, [4, 7, 11, 2])
    rows = np.asarray([2, 0, B, B], np.int32)
    jsub, tsub = jc.select_rows(jnp.asarray(rows)), tc.select_rows(rows)
    assert_same(jsub, tsub)
    # Change every row of the copies the same way, then merge back.
    jsub = jsub.replace(
        lengths=jsub.lengths + 3,
        **{n: getattr(jsub, n) * 2 for n in tsub.PLANE_FIELDS})
    tsub.lengths += 3
    for n in tsub.PLANE_FIELDS:
        getattr(tsub, n).mul_(2)
    assert_same(jc.merge_rows(jsub, jnp.asarray(rows)),
                tc.merge_rows(tsub, rows))


@pytest.mark.parametrize("kind", KINDS)
def test_select_row_writes_in_place(kind):
    """A single-row view shares the buffers: a prefill through it lands in
    the cache; its lengths come back by ``merge_row``."""
    jc, tc = random_caches(kind, 16, [4, 7, 11, 2])
    jsub, tsub = jc.select_row(1), tc.select_row(1)
    assert_same(jsub, tsub)
    tokens = np.arange(8, dtype=np.int32)[None] + 3
    n = np.asarray([6], np.int32)
    _, jsub = jllama.model_apply(JCFG, JPARAMS, jnp.asarray(tokens), jsub,
                                 jnp.asarray(n))
    _, tsub = tllama.model_apply(TCFG, TPARAMS, tt(tokens), tsub, tt(n))
    jc = jc.merge_row(jsub, 1)
    tc.merge_row(tsub, 1)
    assert_same(jc, tc, computed=True)
    assert int(tc.lengths[1]) == 13


@pytest.mark.parametrize("kind", KINDS)
def test_reset_rows_and_fits(kind):
    jc, tc = random_caches(kind, 16, [4, 16, 11, 2])
    mask = np.asarray([False, True, False, True])
    jc, tc = jc.reset_rows(jnp.asarray(mask)), tc.reset_rows(tt(mask))
    assert_same(jc, tc)
    for n in (0, 5, 12):
        np.testing.assert_array_equal(tc.fits(n).numpy(),
                                      np.asarray(jc.fits(n)))


# ---------------------------------------------------------------------------
# attend through the model
# ---------------------------------------------------------------------------


def empty_caches(kind, t, use_kernel=False):
    args = (L, B, t, H, D)
    if kind == "model_dtype":
        return (jdense.DenseKVCache.create(*args, jnp.float32),
                tdense.DenseKVCache.create(*args, torch.float32, device="cpu"))
    return (jdense.QuantizedDenseKVCache.create(*args, jnp.float32,
                                                use_kernel=use_kernel),
            tdense.QuantizedDenseKVCache.create(*args, torch.float32,
                                                use_kernel=use_kernel,
                                                device="cpu"))


def prefill_then_decode(kind, t, jattn_fn=None, tattn_fn=None,
                        use_kernel=False, s=16, lens=(9, 16, 3, 0)):
    """A padded prefill (row 3 empty), then three decode steps (row 2 idle
    in the second): logits within ATOL, caches equal (int8 within 1 LSB)."""
    jc, tc = empty_caches(kind, t, use_kernel)
    jkw = {} if jattn_fn is None else {"attention_fn": jattn_fn}
    tkw = {} if tattn_fn is None else {"attention_fn": tattn_fn}
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, size=(B, s)).astype(np.int32)
    steps = [np.asarray(lens, np.int32), np.asarray([1, 1, 1, 1], np.int32),
             np.asarray([1, 1, 0, 1], np.int32),
             np.asarray([1, 0, 1, 1], np.int32)]
    for i, n in enumerate(steps):
        tok = tokens if i == 0 else rng.integers(0, 256, (B, 1)).astype(np.int32)
        want, jc = jllama.model_apply(JCFG, JPARAMS, jnp.asarray(tok), jc,
                                      jnp.asarray(n), **jkw)
        got, tc = tllama.model_apply(TCFG, TPARAMS, tt(tok), tc, tt(n), **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    assert_same(jc, tc, computed=True)
    return tc


@pytest.fixture
def calls(monkeypatch):
    """Calls of the new kernel wrappers, by name."""
    counts = {}
    for mod, name in ((tqa, "quantized_decode_attention"),
                      (tqa, "quantized_fused_decode_attention"),
                      (tqa, "fused_tail_flush"), (tfa, "flash_attention")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return counts


def test_model_dtype_cache_through_the_model():
    prefill_then_decode("model_dtype", 32)


def test_model_dtype_cache_with_flash(calls):
    """The engine's route for this cache under ``use_pallas_attention``:
    flash for the prefill, its S=1 fallback for decode steps."""
    def jflash(q, k, v, mask, scale=None):
        from distributed_llm_inference_tpu.ops.flash_attention import (
            flash_attention,
        )
        return flash_attention(q, k, v, mask, scale, block_q=8, block_k=8,
                               interpret=True)

    def tflash(q, k, v, mask, scale=None):
        return tfa.flash_attention(q, k, v, mask, scale, block_q=8, block_k=8)

    prefill_then_decode("model_dtype", 32, jflash, tflash)


def test_int8_cache_int8_score_path(calls):
    prefill_then_decode("int8", 32)
    assert calls == {}


def test_int8_cache_decode_kernel_route(calls):
    """``use_kernel``: decode steps through #8 (the JAX kernel in interpret
    mode, the port's plain version)."""
    prefill_then_decode("int8", 32, use_kernel=True)
    assert calls == {"quantized_decode_attention": 3 * L}


def test_int8_cache_gather_path(calls):
    """A non-default attention function takes the dequantizing gather
    path (time-major views of the head-major buffers)."""
    def jfn(q, k, v, mask, scale=None):
        return jattn.gqa_attention(q, k, v, mask, scale)

    def tfn(q, k, v, mask, scale=None):
        return tattn.gqa_attention(q, k, v, mask, scale)

    prefill_then_decode("int8", 32, jfn, tfn, use_kernel=True)
    assert calls == {}


def test_int8_cache_long_prefill_takes_flash(calls):
    """A 1024-token prefill over a 1024-wide buffer: the flash route of the
    gather path in both packages (``flash_prefill_fn``), one layer."""
    cfg = dict(MODEL, num_layers=1)
    jparams = jllama.init_params(jcfg.ModelConfig(**cfg), jax.random.PRNGKey(1),
                                 dtype=jnp.float32)
    tparams = tllama.params_from_numpy(
        tcfg.ModelConfig(**cfg), jax.tree_util.tree_map(np.asarray, jparams),
        torch.float32, "cpu")
    jc = jdense.QuantizedDenseKVCache.create(1, 1, 1024, H, D, jnp.float32)
    tc = tdense.QuantizedDenseKVCache.create(1, 1, 1024, H, D, torch.float32,
                                             device="cpu")
    tokens = np.random.default_rng(4).integers(0, 256, (1, 1024)).astype(np.int32)
    n = np.asarray([1000], np.int32)
    want, jc = jllama.model_apply(jcfg.ModelConfig(**cfg), jparams,
                                  jnp.asarray(tokens), jc, jnp.asarray(n),
                                  head="last")
    got, tc = tllama.model_apply(tcfg.ModelConfig(**cfg), tparams, tt(tokens),
                                 tc, tt(n), head="last")
    assert calls == {"flash_attention": 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert_same(jc, tc, computed=True)


# ---------------------------------------------------------------------------
# The write-behind tail
# ---------------------------------------------------------------------------


def run_window(kind, t, use_kernel, k_steps=4):
    """Prefill, then one fused window of ``k_steps`` through
    ``multi_decode_apply`` in both packages (row 1 stops after 2 steps, row
    3 is idle): identical tokens, equal caches."""
    jc, tc = empty_caches(kind, t, use_kernel)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, size=(B, 16)).astype(np.int32)
    n = np.asarray([9, 16, 3, 0], np.int32)
    _, jc = jllama.model_apply(JCFG, JPARAMS, jnp.asarray(tokens), jc,
                               jnp.asarray(n))
    _, tc = tllama.model_apply(TCFG, TPARAMS, tt(tokens), tc, tt(n))
    budget = np.asarray([k_steps, 2, k_steps, 0], np.int32)
    active = budget > 0
    first = rng.integers(0, 256, size=(B, 1)).astype(np.int32)

    def jstep(i, logits, alive):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        emitted = jnp.where(alive, nxt, -1)
        alive = alive & (i + 1 < budget)
        return nxt, alive.astype(jnp.int32), alive, emitted

    budget_t = tt(budget)

    def tstep(i, logits, alive):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        emitted = torch.where(alive, nxt, -1)
        alive = alive & (i + 1 < budget_t)
        return nxt, alive.to(torch.int32), alive, emitted

    want, jc = jllama.multi_decode_apply(
        JCFG, JPARAMS, jnp.asarray(first), jc, k_steps, jstep,
        jnp.asarray(active), jnp.asarray(active.astype(np.int32)))
    got, tc = tllama.multi_decode_apply(
        TCFG, TPARAMS, tt(first), tc, k_steps, tstep, tt(active),
        tt(active.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_same(jc, tc, computed=True)
    np.testing.assert_array_equal(tc.lengths.numpy(), [9 + k_steps, 18, 3 + k_steps, 0])


def test_model_dtype_window(calls):
    run_window("model_dtype", 32, False)
    assert calls == {}


def test_int8_window_kernel_form(calls):
    """``use_kernel`` at a 32-aligned width: the whole buffers through #9
    each (layer, step), the tail merged by #10 once."""
    run_window("int8", 64, True)
    assert calls == {"quantized_fused_decode_attention": 4 * L,
                     "fused_tail_flush": 1}


@pytest.mark.parametrize("use_kernel,t", [(False, 64), (True, 40)],
                         ids=["no_kernel", "width_not_32_aligned"])
def test_int8_window_segments_form(use_kernel, t, calls):
    run_window("int8", t, use_kernel)
    assert calls == {}


# ---------------------------------------------------------------------------
# The new kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,g", [(None, 2), (5, 2), (None, 1), (40, 1)])
def test_quantized_decode_attention_matches_jax(window, g):
    """#8 over T = 256 (two 128-wide tiles): rows of 0, 1, 130 and 256
    live positions, with and without a sliding window."""
    t = 256
    rng = np.random.default_rng(6 + g)
    q = rng.standard_normal((B, 1, H * g, D)).astype(np.float32)
    x = rng.standard_normal((2, B, t, H, D)).astype(np.float32)
    kq, ks = (np.asarray(a) for a in jdense._quantize_kv(jnp.asarray(x[0])))
    vq, vs = (np.asarray(a) for a in jdense._quantize_kv(jnp.asarray(x[1])))
    planes = [np.ascontiguousarray(np.moveaxis(a, 1, 2)) for a in (kq, ks, vq, vs)]
    lens = np.asarray([0, 1, 130, 256], np.int32)
    want = jqa.quantized_decode_attention(
        jnp.asarray(q), *[jnp.asarray(a) for a in planes], jnp.asarray(lens),
        sliding_window=window, interpret=True)
    before = tqa.decode_launches
    got = tqa.quantized_decode_attention(
        tt(q), *[tt(a) for a in planes], tt(lens), sliding_window=window)
    assert tqa.decode_launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("kt", [16, 48])
def test_fused_tail_flush_matches_jax(kt):
    """#10 byte for byte against the Pallas kernel and against
    ``_tail_flush_rows``: in-block, block-spanning, empty, edge-partial and
    buffer-end windows (the rows of ``tests/test_kv_quant.py``)."""
    t = 160
    rng = np.random.default_rng(0)
    mk = lambda *s: rng.integers(-100, 100, s).astype(np.int8)
    big = [mk(L, 5, 3, t, D), rng.random((L, 5, 3, t)).astype(np.float32),
           mk(L, 5, 3, t, D), rng.random((L, 5, 3, t)).astype(np.float32)]
    tail = [mk(L, 5, 3, kt, D), rng.random((L, 5, 3, kt)).astype(np.float32),
            mk(L, 5, 3, kt, D), rng.random((L, 5, 3, kt)).astype(np.float32)]
    base = np.asarray([10, 30, 70, t - 10, t - kt], np.int32)
    tl = np.asarray([kt, kt, 0, 10, kt], np.int32)
    want = jqa.fused_tail_flush(*[jnp.asarray(a) for a in big],
                                *[jnp.asarray(a) for a in tail],
                                jnp.asarray(base), jnp.asarray(tl),
                                interpret=True)
    port = [tt(a).clone() for a in big]
    before = tqa.flush_launches
    got = tqa.fused_tail_flush(*port, *[tt(a) for a in tail], tt(base), tt(tl))
    assert tqa.flush_launches == before
    rows_ref = [tt(a).clone() for a in big]
    for plane, tl_plane in zip(rows_ref, tail):
        tdense._tail_flush_rows(plane, tt(tl_plane), tt(base), tt(tl), axis=2)
    for g_, w_, r_, a in zip(got, want, rows_ref, big):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        np.testing.assert_array_equal(r_.numpy(), np.asarray(w_))
        assert g_.data_ptr() in {p.data_ptr() for p in port}, "in place"
    assert (got[0].numpy() != big[0]).any(), "the flush wrote nothing"


def test_gqa_attention_quantized_matches_jax():
    """The int8-score attention over head-major int8 K/V, a fully masked
    row among random masks. (f32: the JAX CPU backend has no bf16 x bf16 ->
    f32 product.)"""
    rng = np.random.default_rng(8)
    s, t, g = 5, 24, 2
    q = rng.standard_normal((B, s, H * g, D)).astype(np.float32)
    kq = rng.integers(-127, 128, (B, H, t, D)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, H, t, D)).astype(np.int8)
    ks, vs = (rng.random((B, H, t)).astype(np.float32) * 0.02 for _ in range(2))
    mask = rng.random((B, s, t)) < 0.7
    mask[0] = False
    want = jattn.gqa_attention_quantized(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), jnp.asarray(mask))
    got = tattn.gqa_attention_quantized(tt(q), tt(kq), tt(ks), tt(vq), tt(vs),
                                        tt(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[0] == 0).all()


def test_gqa_attention_segments_matches_jax():
    """Two time-major segments under one softmax, one query, a row with
    nothing valid."""
    rng = np.random.default_rng(9)
    t, g = 24, 2
    q = rng.standard_normal((B, 1, H * g, D)).astype(np.float32)
    k = rng.standard_normal((2, B, t, H, D)).astype(np.float32)
    v = rng.standard_normal((2, B, t, H, D)).astype(np.float32)
    valid = rng.random((2, B, t)) < 0.6
    valid[:, 1] = False
    want = jattn.gqa_attention_segments(
        jnp.asarray(q), [(jnp.asarray(k[i]), jnp.asarray(v[i]),
                          jnp.asarray(valid[i])) for i in range(2)])
    got = tattn.gqa_attention_segments(
        tt(q), [(tt(k[i]), tt(v[i]), tt(valid[i])) for i in range(2)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[1] == 0).all()
