"""Port parity, int8 weights with fp outlier channels
(``EngineConfig(quantization="int8_outlier")``, the JAX package's
``QuantizedTensorOutlier``): the same weights through the JAX
``quantize_int8_outlier`` / ``quantize_params`` and the port's give the
same outlier channels, and int8 values, scales and outlier rows within one
rounding step; ``matmul`` agrees; the engines' greedy streams over int8
pages are IDENTICAL at ``decode_steps`` 1 and 4 (float32, the plain
attention route on both), and at 16 on the plain route and the kernels'."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from distributed_llm_inference_tpu.engine.sampling import SamplingOptions as JaxOptions
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu.ops import quant as jquant
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.engine.sampling import SamplingOptions
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
JPARAMS = jllama.init_params(
    jcfg.ModelConfig(**MODEL), jax.random.PRNGKey(0), dtype=jnp.float32)
TPARAMS = tllama.params_from_numpy(
    tcfg.ModelConfig(**MODEL), jax.tree_util.tree_map(np.asarray, JPARAMS),
    torch.float32, "cpu")


def _weight(shape, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    # A few heavy input rows, as outlier features make them.
    w[..., [3, 17, 40], :] *= 8.0
    return w


def _assert_same_quantization(got, want):
    """Same channels; int8 values within one rounding step; scales and
    outlier rows (bf16) within one bf16 step."""
    np.testing.assert_array_equal(got.outlier_idx.numpy(),
                                  np.asarray(want.outlier_idx))
    assert got.outlier_idx.dtype == torch.int32 and got.q.dtype == torch.int8
    diff = np.abs(got.q.numpy().astype(np.int32)
                  - np.asarray(want.q).astype(np.int32))
    assert diff.max() <= 1
    for name in ("scale", "outlier_w"):
        a = getattr(got, name).float().numpy()
        b = np.asarray(getattr(want, name)).astype(np.float32)
        np.testing.assert_allclose(a, b, rtol=2 ** -7, err_msg=name)


@pytest.mark.parametrize("calib", [None, "shared", "stacked"])
def test_quantize_int8_outlier_matches_the_reference(calib):
    w = _weight((2, 64, 48))
    act = None
    if calib == "shared":
        act = np.abs(np.random.default_rng(1).standard_normal(64)).astype(
            np.float32)
    elif calib == "stacked":
        act = np.abs(np.random.default_rng(1).standard_normal((2, 64))).astype(
            np.float32)
    want = jquant.quantize_int8_outlier(
        jnp.asarray(w), 8, None if act is None else jnp.asarray(act))
    got = tquant.quantize_int8_outlier(
        torch.from_numpy(w), 8, None if act is None else torch.from_numpy(act))
    _assert_same_quantization(got, want)
    if act is None:
        # Without calibration the heavy rows are the channels.
        assert {3, 17, 40} <= set(got.outlier_idx[0].tolist())
    # The outlier rows are zero in the int8 body.
    rows = got.q.gather(
        1, got.outlier_idx.long()[..., None].expand(-1, -1, 48))
    assert not rows.any()


def test_matmul_matches_the_reference_and_never_takes_w8a8():
    w = _weight((64, 48), seed=2)
    x = np.random.default_rng(3).standard_normal((2, 130, 64)).astype(
        np.float32)
    jw = jquant.quantize_int8_outlier(jnp.asarray(w), 8)
    tw = tquant.quantize_int8_outlier(torch.from_numpy(w), 8)
    assert not isinstance(tw, tquant.QuantizedTensor)
    got = tquant.matmul(torch.from_numpy(x), tw).numpy()
    want = np.asarray(jquant.matmul(jnp.asarray(x), jw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    # The outlier channels carry the heavy rows: closer to x @ w than plain
    # int8 is.
    exact = x @ w
    plain = tquant.matmul(torch.from_numpy(x),
                          tquant.quantize_int8(torch.from_numpy(w))).numpy()
    assert np.abs(got - exact).max() < np.abs(plain - exact).max()


def test_quantize_params_matches_the_reference():
    act = {"wq": np.abs(np.random.default_rng(4).standard_normal(64)).astype(
        np.float32)}
    want = jquant.quantize_params(JPARAMS, outlier_channels=8,
                                  act_scales={"wq": jnp.asarray(act["wq"])})
    got = tquant.quantize_params(TPARAMS, outlier_channels=8, act_scales=act)
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        assert isinstance(got["layers"][name], tquant.QuantizedTensorOutlier)
        _assert_same_quantization(got["layers"][name], want["layers"][name])
        # One layer of the stack, as the model slices it.
        one = got["layers"][name][1]
        assert one.q.ndim == 2 and one.outlier_idx.shape == (8,)
    _assert_same_quantization(got["lm_head"], want["lm_head"])
    assert torch.equal(got["embed"], TPARAMS["embed"])


def test_moe_expert_stacks_stay_plain_int8():
    layers = {"we_g": torch.randn(2, 4, 16, 24), "wq": torch.randn(2, 16, 16)}
    got = tquant.quantize_params({"layers": layers}, outlier_channels=4)
    assert type(got["layers"]["we_g"]) is tquant.QuantizedTensor
    assert isinstance(got["layers"]["wq"], tquant.QuantizedTensorOutlier)


def test_params_from_numpy_takes_the_reference_leaf():
    jq = jquant.quantize_params(JPARAMS, outlier_channels=8)
    tree = jax.tree_util.tree_map(np.asarray, jq)
    port = tllama.params_from_numpy(tcfg.ModelConfig(**MODEL), tree,
                                    torch.float32, "cpu")
    leaf = port["layers"]["wq"]
    assert isinstance(leaf, tquant.QuantizedTensorOutlier)
    np.testing.assert_array_equal(leaf.outlier_idx.numpy(),
                                  np.asarray(jq["layers"]["wq"].outlier_idx))


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_engine_streams_equal_the_jax_engine(decode_steps):
    e = dict(max_batch_size=4, prefill_buckets=(8, 16, 32), max_seq_len=64,
             dtype="float32", ragged_attention=True, decode_steps=decode_steps,
             quantization="int8_outlier", outlier_channels=8)
    c = dict(kind="paged", page_size=8, num_pages=48,
             max_pages_per_session=8, kv_quant="int8")
    jax_engine = JaxEngine(jcfg.ModelConfig(**MODEL), JPARAMS,
                           jcfg.EngineConfig(**e), jcfg.CacheConfig(**c))
    port = InferenceEngine(tcfg.ModelConfig(**MODEL), TPARAMS,
                           tcfg.EngineConfig(**e), tcfg.CacheConfig(**c),
                           device="cpu")
    assert isinstance(port.params["layers"]["wo"],
                      tquant.QuantizedTensorOutlier)
    assert port.decode_steps == jax_engine.decode_steps == decode_steps
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 19, 11)]
    want = jax_engine.generate(prompts, JaxOptions(max_new_tokens=9,
                                                   eos_token_id=-1))
    got = port.generate(prompts, SamplingOptions(max_new_tokens=9,
                                                 eos_token_id=-1))
    assert got == want


@pytest.mark.parametrize("kernels", [False, True])
def test_engine_k16_streams_equal_the_jax_engine(kernels):
    """The fused window at its default K = 16 over int8 pages: the port's
    greedy streams equal the JAX engine's, on the plain attention route and
    on the kernels' (``use_pallas_attention`` on both: the Pallas kernels
    in interpret mode, the port's wrappers' plain versions). A K = 16
    stream that departs from K = 1 on the card is the reference's int8-tail
    behaviour, not the port's."""
    e = dict(max_batch_size=4, prefill_buckets=(8, 16, 32), max_seq_len=64,
             dtype="float32", ragged_attention=True, decode_steps=16,
             quantization="int8_outlier", outlier_channels=8,
             use_pallas_attention=kernels)
    c = dict(kind="paged", page_size=8, num_pages=48,
             max_pages_per_session=8, kv_quant="int8")
    jax_engine = JaxEngine(jcfg.ModelConfig(**MODEL), JPARAMS,
                           jcfg.EngineConfig(**e), jcfg.CacheConfig(**c))
    port = InferenceEngine(tcfg.ModelConfig(**MODEL), TPARAMS,
                           tcfg.EngineConfig(**e), tcfg.CacheConfig(**c),
                           device="cpu",
                           attention_backend="cuda" if kernels else None)
    assert port.cache.use_kernel == kernels and port._fused is not None
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 19, 11)]
    want = jax_engine.generate(prompts, JaxOptions(max_new_tokens=20,
                                                   eos_token_id=-1))
    got = port.generate(prompts, SamplingOptions(max_new_tokens=20,
                                                 eos_token_id=-1))
    assert got == want
