"""Port parity, the StreamingLLM sink ring: ``cache/sink.py``
(``SinkKVCache`` in the model dtype, ``QuantizedSinkKVCache`` int8) against
the JAX package's classes on the same numpy inputs (f32, CPU), and the
plain attention function they share with the int8 ring's tail,
``gqa_attention_quantized_multi_q_segments``.

Covered: logits through ``model_apply`` over a padded prefill and then per
step decode past several wraps of the ring (rows of different lengths, a
row idle on some steps); a prefill in chunks past the window; the ring and
sink writes themselves in the sink phase, across the ring's end and for an
idle row; ``select_rows``/``merge_rows`` with padding rows, ``select_row``
in place, ``reset_rows``, ``fits`` and the fixed size (``grow_to``
raises).

Tolerances: logits 2e-5 absolute (the same f32 products summed in another
order); planes that only move values, and the stream lengths, are
byte-equal. K/V that the model computes differ by the order of its
projections' sums (about 1e-7): model-dtype planes within 1e-5, int8
values within 1 LSB and their scales within 1e-6 relative, the tolerances
of ``test_torch_dense_cache.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.cache import sink as jsink
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu.ops import attention as jattn
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache import sink as tsink
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)
HKV, HQ, D = 2, 4, 8
MODEL = dict(vocab_size=64, hidden_size=32, intermediate_size=96,
             num_layers=2, num_heads=HQ, num_kv_heads=HKV, head_dim=D)
JCFG, TCFG = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
JPARAMS = jllama.init_params(JCFG, jax.random.PRNGKey(1), dtype=jnp.float32)
TPARAMS = tllama.params_from_numpy(
    TCFG, jax.tree_util.tree_map(np.asarray, JPARAMS), torch.float32, "cpu")
L, ATOL = 2, 2e-5
W, S = 16, 2
KINDS = ["model_dtype", "int8"]


def tt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def empty_caches(kind, batch, window=W, sinks=S):
    args = (L, batch, window, sinks, HKV, D)
    if kind == "model_dtype":
        return (jsink.SinkKVCache.create(*args, dtype=jnp.float32),
                tsink.SinkKVCache.create(*args, dtype=torch.float32,
                                         device="cpu"))
    return (jsink.QuantizedSinkKVCache.create(*args),
            tsink.QuantizedSinkKVCache.create(*args, device="cpu"))


def fields(kind):
    if kind == "model_dtype":
        return ("k", "v")
    return tsink.QuantizedSinkKVCache.PLANE_FIELDS


def assert_same(kind, jc, tc, computed=False):
    """Every plane and the stream lengths EQUAL; with ``computed``, K/V the
    model computed within the tolerances of the module docstring."""
    np.testing.assert_array_equal(tc.seen.numpy(), np.asarray(jc.seen))
    for name in fields(kind):
        got, want = getattr(tc, name).numpy(), np.asarray(getattr(jc, name))
        assert got.shape == want.shape, name
        if computed and got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
        elif computed and kind == "int8":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=name)
        elif computed:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


# Compiled once a shape: eager JAX dispatches every op of every step.
JAX_APPLY = jax.jit(jllama.model_apply, static_argnums=0,
                    static_argnames=("head",))


def step_both(jc, tc, tokens, num_new, **kw):
    want, jc = JAX_APPLY(JCFG, JPARAMS, jnp.asarray(tokens), jc,
                         jnp.asarray(num_new), **kw)
    got, tc = tllama.model_apply(TCFG, TPARAMS, tt(tokens), tc, tt(num_new),
                                 **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    return jc, tc


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_then_decode_through_wraps(kind):
    """A padded prefill of rows of 10, 7 and 1 tokens (the last one still in
    the sink phase), then 3 W decode steps: row 1 idles on every third
    step, so the rows wrap at different steps."""
    jc, tc = empty_caches(kind, 3)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, (3, 10)).astype(np.int32)
    jc, tc = step_both(jc, tc, tokens, np.asarray([10, 7, 1], np.int32))
    assert_same(kind, jc, tc, computed=True)
    for i in range(3 * W):
        tok = rng.integers(0, 64, (3, 1)).astype(np.int32)
        n = np.asarray([1, 0 if i % 3 == 2 else 1, 1], np.int32)
        jc, tc = step_both(jc, tc, tok, n)
    assert_same(kind, jc, tc, computed=True)
    assert tc.seen.tolist() == [10 + 3 * W, 7 + 2 * W, 1 + 3 * W]


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_prefill_past_the_window(kind):
    """40 tokens in chunks of 10 (each within the ring span, the stream
    well past the window: eviction at chunk granularity), then decode."""
    jc, tc = empty_caches(kind, 1)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 64, (1, 40)).astype(np.int32)
    for lo in range(0, 40, 10):
        jc, tc = step_both(jc, tc, tokens[:, lo:lo + 10],
                           np.asarray([10], np.int32), head="last")
    for _ in range(5):
        jc, tc = step_both(jc, tc, rng.integers(0, 64, (1, 1)).astype(np.int32),
                           np.asarray([1], np.int32))
    assert_same(kind, jc, tc, computed=True)


def random_quantized(batch, lengths, window=W, sinks=S, seed=0):
    """The int8 ring of both packages over the same random contents."""
    rng = np.random.default_rng(seed)
    jc = jsink.QuantizedSinkKVCache.create(L, batch, window, sinks, HKV, D)
    planes = {}
    for name in tsink.QuantizedSinkKVCache.PLANE_FIELDS:
        shape = np.asarray(getattr(jc, name)).shape
        planes[name] = (rng.integers(-127, 128, shape).astype(np.int8)
                        if name in ("k", "v", "sk", "sv")
                        else rng.random(shape).astype(np.float32))
    lens = np.asarray(lengths, np.int32)
    jc = jc.replace(lengths=jnp.asarray(lens),
                    **{n: jnp.asarray(a) for n, a in planes.items()})
    tc = tsink.QuantizedSinkKVCache(
        *(tt(planes[n]).clone()
          for n in tsink.QuantizedSinkKVCache.PLANE_FIELDS),
        tt(lens).clone(), sinks, window - sinks)
    return jc, tc


def test_ring_and_sink_writes():
    """Writes of S = 6 incoming tokens: a row in the sink phase (its head
    goes to the sinks, the rest to the ring), a row wrapping across the
    ring's end, a row far past several wraps, an idle row. Values and
    scales, ring and sink planes, byte-equal."""
    jc, tc = random_quantized(4, [1, 12, 101, 30])
    rng = np.random.default_rng(2)
    num_new = np.asarray([6, 6, 4, 0], np.int32)
    vals = rng.integers(-127, 128, (4, 6, HKV, D)).astype(np.int8)
    scales = rng.random((4, 6, HKV)).astype(np.float32)
    for name in tsink.QuantizedSinkKVCache.PLANE_FIELDS:
        new = scales if name in ("ks", "vs", "sks", "svs") else vals
        ring = name in ("k", "v", "ks", "vs")
        jw = jc._ring_write if ring else jc._sink_write
        tw = tc._ring_write if ring else tc._sink_write
        want = jw(getattr(jc, name)[1], jnp.asarray(new), jnp.asarray(num_new))
        buf = getattr(tc, name)[1]
        got = tw(buf, tt(new), tt(num_new))
        assert got.data_ptr() == buf.data_ptr(), "in place"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)


def test_model_dtype_ring_writes_and_keys():
    """The model-dtype ring's ``update_and_gather``: its slot writes (sink
    phase, a wrap, an idle row), the keys re-rotated to window-relative
    positions, and the mask."""
    rng = np.random.default_rng(3)
    jc, tc = empty_caches("model_dtype", 3)
    k = rng.standard_normal((L, 3, W, HKV, D)).astype(np.float32)
    v = rng.standard_normal((L, 3, W, HKV, D)).astype(np.float32)
    seen = np.asarray([1, 20, 9], np.int32)
    jc = jc.replace(k=jnp.asarray(k), v=jnp.asarray(v), seen=jnp.asarray(seen))
    tc = tsink.SinkKVCache(tt(k).clone(), tt(v).clone(), tt(seen).clone(), S)
    num_new = np.asarray([5, 5, 0], np.int32)
    q, kn, vn = (rng.standard_normal((3, 5, h, D)).astype(np.float32)
                 for h in (HQ, HKV, HKV))
    from distributed_llm_inference_tpu.ops.rotary import (
        RopeAngles as JRope, rope_cos_sin as jcs, rope_inv_freq as jinv)
    from distributed_llm_inference_tpu_torch.ops.rotary import (
        RopeAngles as TRope, rope_cos_sin as tcs, rope_inv_freq as tinv)

    ji = jinv(D, 10000.0)
    jpos = jc.rope_positions(5, jnp.asarray(num_new))
    jrope = JRope(ji, *jcs(jpos, ji))
    ti = tinv(D, 10000.0)
    tpos = tc.rope_positions(5, tt(num_new))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    trope = TRope(ti, *tcs(tpos, ti))
    want = jc.update_and_gather(
        (jc.k[0], jc.v[0]), jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jrope, jc.q_positions(5), jnp.asarray(num_new))
    got = tc.update_and_gather(
        (tc.k[0], tc.v[0]), tt(q), tt(kn), tt(vn), trope, tc.q_positions(5),
        tt(num_new))
    for g_, w_ in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-6,
                                   rtol=0)
    np.testing.assert_array_equal(tc.k[0].numpy(), np.asarray(want[4][0]))
    np.testing.assert_array_equal(tc.v[0].numpy(), np.asarray(want[4][1]))


def test_rows_reset_fits_and_fixed_size():
    jc, tc = random_quantized(4, [3, 40, 0, 17])
    rows = np.asarray([2, 0, 4, 4], np.int32)
    jsub, tsub = jc.select_rows(jnp.asarray(rows)), tc.select_rows(rows)
    assert_same("int8", jsub, tsub)
    jsub = jsub.replace(
        lengths=jsub.lengths + 3,
        **{n: getattr(jsub, n) * 2 for n in tsub.PLANE_FIELDS})
    tsub.lengths += 3
    for n in tsub.PLANE_FIELDS:
        getattr(tsub, n).mul_(2)
    jc, tc = jc.merge_rows(jsub, jnp.asarray(rows)), tc.merge_rows(tsub, rows)
    assert_same("int8", jc, tc)
    mask = np.asarray([False, True, False, True])
    assert_same("int8", jc.reset_rows(jnp.asarray(mask)),
                tc.reset_rows(tt(mask)))
    for n in (0, 14, 15):
        np.testing.assert_array_equal(tc.fits(n).numpy(), np.asarray(jc.fits(n)))
    assert tc.max_len == 32 and tc.window == W and tc.ring_slots == W - S
    with pytest.raises(TypeError, match="fixed-size"):
        tc.grow_to(64)
    anchor = tc.window_anchor
    assert anchor is tc.k


@pytest.mark.parametrize("kind", KINDS)
def test_select_row_prefills_in_place(kind):
    """A batch-1 view shares the planes: a prefill through it lands in the
    cache, its length comes back by ``merge_row``."""
    jc, tc = empty_caches(kind, 3)
    tokens = np.arange(8, dtype=np.int32)[None] + 5
    n = np.asarray([8], np.int32)
    jsub, tsub = jc.select_row(1), tc.select_row(1)
    _, jsub = jllama.model_apply(JCFG, JPARAMS, jnp.asarray(tokens), jsub,
                                 jnp.asarray(n))
    _, tsub = tllama.model_apply(TCFG, TPARAMS, tt(tokens), tsub, tt(n))
    assert_same(kind, jc.merge_row(jsub, 1), tc.merge_row(tsub, 1),
                computed=True)
    assert tc.seen.tolist() == [0, 8, 0]


def test_multi_q_segments_matches_jax():
    """Three int8 segments, each with its own query and mask (one [B, S, T],
    two broadcast [B, 1, T]), a row with nothing valid."""
    rng = np.random.default_rng(4)
    b, s = 3, 4
    segs_j, segs_t = [], []
    for t, full in ((5, True), (24, False), (7, False)):
        q = rng.standard_normal((b, s, HQ, D)).astype(np.float32)
        kq, vq = (rng.integers(-127, 128, (b, HKV, t, D)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.random((b, HKV, t)).astype(np.float32) * 0.05
                  for _ in range(2))
        mask = rng.random((b, s if full else 1, t)) < 0.6
        mask[1] = False
        segs_j.append(tuple(jnp.asarray(a) for a in (q, kq, ks, vq, vs, mask)))
        segs_t.append(tuple(tt(a) for a in (q, kq, ks, vq, vs, mask)))
    want = jattn.gqa_attention_quantized_multi_q_segments(segs_j)
    got = tattn.gqa_attention_quantized_multi_q_segments(segs_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[1] == 0).all()
