"""Port parity: weight quantization (``ops/quant.py``), the int4 packing and
matmul (``ops/quant_matmul.py``, on CPU tensors, so the plain versions) and
the int8 KV quantizer (``cache/dense.py:_quantize_kv``) against the JAX
package's, on the same numpy inputs. Quantized values and scales must be
byte-identical; products agree to atol 2e-5 relative to the output's
largest magnitude (float32 on both sides, another order of summation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.cache.dense import _quantize_kv as jax_quantize_kv
from distributed_llm_inference_tpu.ops import quant as jq
from distributed_llm_inference_tpu.ops import quant_matmul as jqm
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache.dense import _quantize_kv
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import quant as tq
from distributed_llm_inference_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)
RTOL = 2e-5  # of max |out|: f32 sums in another order


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * max(1.0, np.abs(want).max()), err


def as_np(t):
    """A torch tensor as numpy, bf16 by its bits (numpy has no bf16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def jax_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def weights(seed, *shape):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0, :] *= 8.0       # an input row that sets the channel scale
    w[..., 3] = 0.0           # an all-zero output channel (scale floor)
    return w


@pytest.mark.parametrize("shape", [(40, 24), (3, 40, 24), (2, 1030, 6)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_values_and_scales_are_byte_identical(bits, shape):
    w = weights(0, *shape)
    if bits == 8:
        got = tq.quantize_int8(torch.as_tensor(w))
        want = jq.quantize_int8(jnp.asarray(w))
        pairs = [(got.q, want.q), (got.scale, want.scale)]
        assert got.scale.dtype == torch.bfloat16
    else:
        got = tq.quantize_int4_split(torch.as_tensor(w))
        want = jq.quantize_int4_split(jnp.asarray(w))
        pairs = [(got.q, want.q), (got.scale_lo, want.scale_lo),
                 (got.scale_hi, want.scale_hi)]
        assert (got.in_dim, got.out_dim) == (want.in_dim, want.out_dim)
        assert got.q.shape[-2:] == (1024 * -(-shape[-2] // 1024), 512)
    for mine, theirs in pairs:
        np.testing.assert_array_equal(as_np(mine), jax_bits(theirs))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_matches_jax_and_crosses_over(bits):
    """``quantize_params`` over a whole tree equals the JAX one leaf for
    leaf, and ``params_from_numpy`` carries the JAX-quantized tree over
    unchanged (int8 stays int8, scales keep their dtype)."""
    layers = {n: weights(i, 2, 32, 48) for i, n in enumerate(
        ("wq", "wk", "wv", "wo", "wg", "wu", "wd"))}
    layers["attn_norm"] = np.ones((2, 32), np.float32)
    layers["mlp_norm"] = np.ones((2, 32), np.float32)
    tree = {"embed": weights(9, 64, 32), "layers": layers,
            "final_norm": np.ones((32,), np.float32),
            "lm_head": weights(10, 32, 63)}      # odd width: stays int8
    kw = dict(int4_layout="split") if bits == 4 else {}
    want = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree),
                              bits=bits, **kw)
    got = tq.quantize_params(
        jax.tree_util.tree_map(torch.as_tensor, tree), bits=bits)
    carried = tllama.params_from_numpy(
        tcfg.ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                         num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=8),
        jax.tree_util.tree_map(np.asarray, want), torch.float32, "cpu")
    kind = tq.QuantizedTensor4Split if bits == 4 else tq.QuantizedTensor
    assert isinstance(got["layers"]["wq"], kind)
    assert isinstance(got["lm_head"], tq.QuantizedTensor)
    assert isinstance(got["embed"], torch.Tensor)
    for name in ("wq", "wd", "lm_head"):
        mine = got["layers"].get(name, got.get(name))
        theirs = want["layers"].get(name, want.get(name))
        ported = carried["layers"].get(name, carried.get(name))
        assert type(ported) is type(mine)
        for field in ("q", "scale", "scale_lo", "scale_hi"):
            if not hasattr(theirs, field):
                continue
            for t in (getattr(mine, field), getattr(ported, field)):
                np.testing.assert_array_equal(
                    as_np(t), jax_bits(getattr(theirs, field)), err_msg=field)
            assert getattr(ported, field).dtype == getattr(mine, field).dtype
    if bits == 4:
        assert (carried["layers"]["wq"].in_dim,
                carried["layers"]["wq"].out_dim) == (32, 48)
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        tq.quantize_params({}, bits=4, int4_layout="grouped")


def test_pack_unpack_round_trip_and_jax_bytes():
    rng = np.random.default_rng(1)
    q = rng.integers(-7, 8, size=(2, 30, 50)).astype(np.int8)
    packed = tqm.pack_int4_split(torch.as_tensor(q))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jqm.pack_int4_split(jnp.asarray(q))))
    assert packed.shape == (2, 1024, 512)
    back = tqm.unpack_int4_split(packed)
    np.testing.assert_array_equal(back[:, :30, :50].numpy(), q)
    assert int(back[:, 30:].abs().max()) == 0 and int(back[:, :, 50:].abs().max()) == 0
    # Every nibble value, both halves: shift-and-sign-extend is exact.
    vals = np.arange(-7, 8, dtype=np.int8)
    grid = np.stack(np.meshgrid(vals, vals), -1).reshape(-1, 2)
    q2 = np.zeros((1, 1024), np.int8)
    q2[0, : len(grid)] = grid[:, 0]
    q2[0, 512: 512 + len(grid)] = grid[:, 1]
    back2 = tqm.unpack_int4_split(tqm.pack_int4_split(torch.as_tensor(q2)))
    np.testing.assert_array_equal(back2[:1].numpy(), q2)
    np.testing.assert_array_equal(
        back2.numpy(), np.asarray(jqm.unpack_int4_split(
            jqm.pack_int4_split(jnp.asarray(q2)))))


def split_weight(seed, lead, in_dim, out_dim):
    w = weights(seed, *lead, in_dim, out_dim)
    return (tq.quantize_int4_split(torch.as_tensor(w)),
            jq.quantize_int4_split(jnp.asarray(w)))


@pytest.mark.parametrize("rows,in_dim,out_dim", [(1, 40, 24), (5, 72, 1030)])
def test_int4_matmul_plain_matches_jax_kernel(rows, in_dim, out_dim):
    tw, jw = split_weight(2, (), in_dim, out_dim)
    x = np.random.default_rng(3).standard_normal((rows, in_dim)).astype(np.float32)
    before = tqm.launches
    got = tqm.int4_matmul(torch.as_tensor(x), tw.q, tw.scale_lo, tw.scale_hi,
                          out_dim)
    assert tqm.launches == before, "a CPU call must not count as a launch"
    want = jqm.int4_matmul(jnp.asarray(x), jw.q, jw.scale_lo, jw.scale_hi,
                           out_dim, interpret=True)
    close(got.numpy(), want)


@pytest.mark.parametrize("layer", [0, 1, 3])
def test_int4_matmul_stacked_plain_matches_jax_kernel(layer):
    tw, jw = split_weight(4, (4,), 48, 40)
    x = np.random.default_rng(layer).standard_normal((2, 1, 48)).astype(np.float32)
    before = tqm.stacked_launches
    got = tqm.int4_matmul_stacked(torch.as_tensor(x), tw.q, tw.scale_lo,
                                  tw.scale_hi, layer, 40)
    assert tqm.stacked_launches == before
    want = jqm.int4_matmul_stacked(jnp.asarray(x), jw.q, jw.scale_lo,
                                   jw.scale_hi, jnp.int32(layer), 40,
                                   interpret=True)
    assert got.shape == (2, 1, 40)
    close(got.numpy(), want)


MATMUL_CASES = ["int8_decode", "int8_prefill_cpu", "int4_rows", "int4_many_rows",
                "int4_view_decode", "int4_view_many_rows"]


@pytest.mark.parametrize("case", MATMUL_CASES)
def test_matmul_matches_jax_for_each_branch(case):
    rng = np.random.default_rng(5)
    seq = {"int8_decode": 1, "int8_prefill_cpu": 130, "int4_rows": 3,
           "int4_many_rows": 300, "int4_view_decode": 1,
           "int4_view_many_rows": 300}[case]
    x = rng.standard_normal((2, seq, 40)).astype(np.float32)
    if case.startswith("int8"):
        # On the CPU neither package takes W8A8 (gated on the device).
        w = weights(6, 40, 24)
        tw, jw = tq.quantize_int8(torch.as_tensor(w)), jq.quantize_int8(jnp.asarray(w))
    elif case.startswith("int4_view"):
        tw, jw = split_weight(7, (3,), 40, 24)
        tw = tq.QuantizedTensor4SplitView(tw.q, tw.scale_lo, tw.scale_hi, 2,
                                          tw.in_dim, tw.out_dim)
        jw = jq.QuantizedTensor4SplitView(jw.q, jw.scale_lo, jw.scale_hi,
                                          jnp.int32(2), jw.in_dim, jw.out_dim)
    else:
        tw, jw = split_weight(8, (), 40, 24)
    got = tq.matmul(torch.as_tensor(x), tw)
    want = jq.matmul(jnp.asarray(x), jw)
    assert tuple(got.shape) == (2, seq, 24)
    close(got.numpy(), want)


def test_w8a8_matmul_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 24, 40)).astype(np.float32)
    x[0, 3] = 0.0  # a zero row: the activation scale floor
    w = weights(10, 40, 32)
    got = tq.w8a8_matmul(torch.as_tensor(x), tq.quantize_int8(torch.as_tensor(w)))
    want = jq.w8a8_matmul(jnp.asarray(x), jq.quantize_int8(jnp.asarray(w)))
    # int32 accumulation is exact and the scales apply in the same order.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_quantize_kv_is_byte_identical():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 5, 2, 16)) * 3).astype(np.float32)
    x[1, 2, 0] = 0.0
    x[2, 0, 1, 4] = 127.5 * np.abs(x[2, 0, 1]).max() / 127.0  # a .5 tie scale
    for dtype in (np.float32,):
        q, s = _quantize_kv(torch.as_tensor(x.astype(dtype)))
        jq_, js = jax_quantize_kv(jnp.asarray(x.astype(dtype)))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    bq, bs = _quantize_kv(torch.as_tensor(x).bfloat16())
    jbq, jbs = jax_quantize_kv(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(bq.numpy(), np.asarray(jbq))
    np.testing.assert_array_equal(bs.numpy(), np.asarray(jbs))


def test_wrappers_never_fall_back_for_other_devices():
    """Only CPU tensors reach the plain versions; any other device type
    launches or raises."""
    tw, _ = split_weight(12, (2,), 40, 24)
    meta = lambda t: t.to("meta")  # noqa: E731
    x = torch.zeros(1, 40, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tqm.int4_matmul(x, meta(tw.q[0]), meta(tw.scale_lo[0]),
                        meta(tw.scale_hi[0]), 24)
    with pytest.raises(ValueError, match="unsupported device"):
        tqm.int4_matmul_stacked(x, meta(tw.q), meta(tw.scale_lo),
                                meta(tw.scale_hi), 1, 24)
