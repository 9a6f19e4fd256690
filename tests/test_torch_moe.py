"""Port parity, Mixtral's MoE MLP (``ops/moe.py``) and the model around it:
the same numpy inputs, drawn from a seed, go through the JAX package's
functions and the port's, in float32. ``router_weights``, ``moe_mlp`` (the
dense combine) and ``moe_mlp_dispatch`` (the sorted capacity dispatch)
within atol/rtol 1e-5: ties routed to the lowest expert index, full
capacity equal to the dense combine, the default capacity, padding that
never evicts a real token, int8 expert stacks (quantized bytes equal, and
kept int8 under int4 quantization). Then a tiny Mixtral's logits: the port
against the JAX ``model_apply`` through ``params_from_numpy`` (2e-5), and
against ``transformers``' ``MixtralForCausalLM`` through
``convert_hf_state_dict`` (the JAX MoE tests' 2e-4)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.cache.dense import DenseKVCache as JaxDense
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu.ops import moe as jmoe
from distributed_llm_inference_tpu.ops import quant as jquant
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache.dense import DenseKVCache
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import moe as tmoe
from distributed_llm_inference_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)
# transformers is used with torch only: loading TensorFlow costs seconds.
os.environ.setdefault("USE_TF", "0")
# bench.py's TINY_MOE.
TINY_MOE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                num_experts=4, num_experts_per_tok=2, family="mixtral",
                max_position_embeddings=256)
JCFG = jcfg.ModelConfig(**TINY_MOE)
TCFG = tcfg.ModelConfig(**TINY_MOE)
TOL = dict(atol=1e-5, rtol=1e-5)
H, F_, E = TINY_MOE["hidden_size"], TINY_MOE["intermediate_size"], 4


def layer_np(seed=0):
    """One MoE layer's router and expert stacks, scaled so that the
    outputs are of order 1 (a tolerance of 1e-5 then means something)."""
    r = np.random.default_rng(seed)
    return {
        "router": r.standard_normal((H, E)) / np.sqrt(H),
        "we_g": r.standard_normal((E, H, F_)) / np.sqrt(H),
        "we_u": r.standard_normal((E, H, F_)) / np.sqrt(H),
        "we_d": r.standard_normal((E, F_, H)) / np.sqrt(F_),
    }


def as_jax(tree):
    return {k: jnp.asarray(np.float32(v)) for k, v in tree.items()}


def as_torch(tree):
    return {k: torch.from_numpy(np.float32(v)) for k, v in tree.items()}


def x_np(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(kw or TOL))


@pytest.mark.parametrize("router", ["random", "zero"])
def test_router_weights_match_jax(router):
    """The combine matrix, f32: the selected experts and their weights. A
    zero router ties all experts: both pick the lowest indices."""
    p = layer_np()
    if router == "zero":
        p["router"] = np.zeros_like(p["router"])
    x = x_np((3, 5, H))
    want = jmoe.router_weights(JCFG, jnp.asarray(x), as_jax(p)["router"])
    got = tmoe.router_weights(TCFG, torch.from_numpy(x), as_torch(p)["router"])
    assert got.dtype == torch.float32 and got.shape == (3, 5, E)
    np.testing.assert_array_equal(got.numpy() != 0, np.asarray(want) != 0)
    close(got, want)
    if router == "zero":
        assert (got[..., :2] == 0.5).all() and (got[..., 2:] == 0).all()


@pytest.mark.parametrize("shape", [(3, 1), (2, 20)], ids=["decode", "prefill"])
def test_moe_mlp_dense_combine_matches_jax(shape):
    p, x = layer_np(), x_np((*shape, H))
    want = jmoe.moe_mlp(JCFG, as_jax(p), jnp.asarray(x))
    got = tmoe.moe_mlp(TCFG, as_torch(p), torch.from_numpy(x))
    close(got, want)


@pytest.mark.parametrize("factor", [float(E), 2.0, 1.0],
                         ids=["full", "default", "tight"])
def test_dispatch_matches_jax(factor):
    """Sorted dispatch at full capacity (no drops), the default factor and
    a tight one (drops), with bucket padding in the batch."""
    p, x = layer_np(), x_np((2, 16, H))
    valid = np.arange(16)[None, :] < np.asarray([[16], [11]])
    want = jmoe.moe_mlp_dispatch(JCFG, as_jax(p), jnp.asarray(x), factor,
                                 jnp.asarray(valid))
    got = tmoe.moe_mlp_dispatch(TCFG, as_torch(p), torch.from_numpy(x),
                                factor, torch.from_numpy(valid))
    close(got, want)


def test_dispatch_at_full_capacity_equals_the_dense_combine():
    p, x = as_torch(layer_np()), torch.from_numpy(x_np((2, 9, H)))
    dense = tmoe.moe_mlp(TCFG, p, x.reshape(-1, 1, H)).reshape(x.shape)
    full = tmoe.moe_mlp_dispatch(TCFG, p, x, capacity_factor=float(E))
    torch.testing.assert_close(full, dense, **TOL)
    cfg = dataclasses.replace(TCFG, moe_capacity_factor=float(E))
    x16 = torch.from_numpy(x_np((1, 16, H)))
    torch.testing.assert_close(       # S >= 16 takes the dispatch
        tmoe.moe_mlp(cfg, p, x16),
        tmoe.moe_mlp(TCFG, p, x16.reshape(-1, 1, H)).reshape(x16.shape),
        **TOL)


def test_dispatch_padding_never_evicts_real_tokens():
    """Padding routes to the sentinel expert: the real tokens' outputs are
    the same with and without junk padding at a tight capacity."""
    p, x = as_torch(layer_np()), torch.from_numpy(x_np((1, 16, H), seed=10))
    n_real = 9
    valid = torch.arange(16)[None, :] < n_real
    junk = x[:, :1].expand_as(x) * 5.0
    padded = torch.where(valid[..., None], x, junk)
    out_padded = tmoe.moe_mlp_dispatch(TCFG, p, padded, valid=valid,
                                       capacity=6)
    out_clean = tmoe.moe_mlp_dispatch(
        TCFG, p, x[:, :n_real], valid=torch.ones((1, n_real), dtype=bool),
        capacity=6)
    torch.testing.assert_close(out_padded[:, :n_real], out_clean, **TOL)
    want = jmoe.moe_mlp_dispatch(JCFG, as_jax(layer_np()),
                                 jnp.asarray(padded.numpy()),
                                 valid=jnp.asarray(valid.numpy()), capacity=6)
    close(out_padded, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_int8_expert_stacks_match_jax(bits):
    """``quantize_params`` over ``[L, E, in, out]`` stacks: the expert
    stacks int8 under both widths (bytes and scales equal to the JAX
    package's), the router untouched; under int4 only the four attention
    projections are half-split int4. Then ``moe_mlp`` and the dispatch on
    one layer's int8 stacks."""
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(JCFG, jax.random.PRNGKey(2),
                                       jnp.float32))
    layers = {**tree["layers"], **{
        k: np.stack([layer_np(s)[k] for s in (3, 4)]).astype(np.float32)
        for k in ("router", "we_g", "we_u", "we_d")}}
    jq = jquant.quantize_params({"layers": {k: jnp.asarray(v) for k, v in
                                            layers.items()}},
                                scale_dtype=jnp.float32, bits=bits,
                                int4_layout="split")["layers"]
    tq = tquant.quantize_params({"layers": {k: torch.from_numpy(np.array(v))
                                            for k, v in layers.items()}},
                                scale_dtype=torch.float32, bits=bits)["layers"]
    int4 = {k for k, v in tq.items()
            if isinstance(v, tquant.QuantizedTensor4Split)}
    assert int4 == (set(tllama.int4_projections(TCFG)) if bits == 4 else set())
    assert tllama.int4_projections(TCFG) == ("wq", "wk", "wv", "wo")
    for k in ("we_g", "we_u", "we_d"):
        assert isinstance(tq[k], tquant.QuantizedTensor)
        assert tq[k].q.dtype == torch.int8
        assert tq[k].scale.shape == (2, E, layers[k].shape[-1])
        np.testing.assert_array_equal(tq[k].q.numpy(), np.asarray(jq[k].q))
        np.testing.assert_array_equal(tq[k].scale.numpy(),
                                      np.asarray(jq[k].scale))
    assert torch.equal(tq["router"], torch.from_numpy(layers["router"]))
    tp = {k: tq[k][1] for k in ("we_g", "we_u", "we_d")}   # __getitem__
    tp["router"] = tq["router"][1]
    jp = {k: jax.tree_util.tree_map(lambda a: a[1], jq[k])
          for k in ("router", "we_g", "we_u", "we_d")}
    x = x_np((2, 16, H), seed=9)
    close(tmoe.moe_mlp(TCFG, tp, torch.from_numpy(x)),
          jmoe.moe_mlp(JCFG, jp, jnp.asarray(x)))
    close(tmoe.moe_mlp_dispatch(TCFG, tp, torch.from_numpy(x), 2.0),
          jmoe.moe_mlp_dispatch(JCFG, jp, jnp.asarray(x), 2.0))


def test_init_params_shapes_match_jax():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    tp = tllama.init_params(TCFG, None, torch.float32, "cpu")
    assert set(tp["layers"]) == set(jp["layers"])
    for k, v in jp["layers"].items():
        assert tuple(tp["layers"][k].shape) == v.shape, k
    assert tp["layers"]["we_g"].shape == (2, E, H, F_)
    assert tp["layers"]["router"].dtype == torch.float32


@pytest.mark.parametrize("capacity", [None, 2.0], ids=["dense", "dispatch"])
def test_tiny_mixtral_logits_match_jax(capacity):
    """``model_apply`` over the dense cache: a prefill of rows of 16, 9 and
    1 valid tokens (bucket padding behind them), then a decode step."""
    jc = dataclasses.replace(JCFG, moe_capacity_factor=capacity)
    tc = dataclasses.replace(TCFG, moe_capacity_factor=capacity)
    jparams = jllama.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    # Larger than init's 0.02 so that the MLP moves the logits.
    jparams["layers"] = {k: v * 10 if k.startswith("we_") else v
                         for k, v in jparams["layers"].items()}
    tparams = tllama.params_from_numpy(
        tc, jax.tree_util.tree_map(np.asarray, jparams), torch.float32, "cpu")
    b = 3
    jcache = JaxDense.create(2, b, 32, 2, 16, jnp.float32)
    tcache = DenseKVCache.create(2, b, 32, 2, 16, torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(b, 16)).astype(np.int32)
    num_new = np.asarray([16, 9, 1], np.int32)
    for step in range(2):
        jl, jcache = jllama.model_apply(jc, jparams, jnp.asarray(tokens),
                                        jcache, jnp.asarray(num_new))
        tl, tcache = tllama.model_apply(tc, tparams, torch.from_numpy(tokens),
                                        tcache, torch.from_numpy(num_new))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                                   rtol=2e-5)
        tokens = rng.integers(0, 256, size=(b, 1)).astype(np.int32)
        num_new = np.ones(b, np.int32)


def test_tiny_mixtral_logits_match_hf():
    """``transformers``' Mixtral (its ``block_sparse_moe`` keys) through
    ``convert_hf_state_dict``: the port's parameters equal the JAX
    conversion's, and its prefill logits match HF's."""
    transformers = pytest.importorskip("transformers")
    cfg = dataclasses.replace(TCFG, vocab_size=128, hidden_size=32,
                              intermediate_size=64, head_dim=8)
    jc = dataclasses.replace(JCFG, vocab_size=128, hidden_size=32,
                             intermediate_size=64, head_dim=8)
    hf_cfg = transformers.MixtralConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, num_local_experts=E,
        num_experts_per_tok=2,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        attention_dropout=0.0, attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.MixtralForCausalLM(hf_cfg).eval()
    state = {k: v.detach() for k, v in model.state_dict().items()}
    params = tllama.convert_hf_state_dict(cfg, state, None, torch.float32,
                                          "cpu")
    want = tllama.params_from_numpy(cfg, jax.tree_util.tree_map(
        np.asarray, jllama.convert_hf_state_dict(
            jc, {k: v.numpy() for k, v in state.items()}, None,
            jnp.float32)), torch.float32, "cpu")
    assert set(params["layers"]) == set(want["layers"]) == {
        "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router", "we_g",
        "we_u", "we_d"}
    for k, v in want["layers"].items():
        assert torch.equal(params["layers"][k], v), k
    assert params["layers"]["we_d"].shape == (2, E, 64, 32)
    tokens = np.array([[3, 17, 42, 7, 99, 5]], dtype=np.int32)
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens.astype(np.int64))).logits
    cache = DenseKVCache.create(2, 1, 16, 2, 8, torch.float32, device="cpu")
    logits, _ = tllama.model_apply(cfg, params, torch.from_numpy(tokens),
                                   cache, torch.full((1,), 6,
                                                     dtype=torch.int32))
    torch.testing.assert_close(logits, ref, atol=2e-4, rtol=2e-4)
