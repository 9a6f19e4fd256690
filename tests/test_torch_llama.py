"""Port parity: the Llama stack. The JAX package's random parameters cross
over through numpy (``params_from_numpy``), and ``model_apply`` logits of a
prefill and three decode steps match the JAX ``model_apply`` on the paged
cache, for ``head`` in all/last, through the gather path and through the
kernel wrappers. atol 1e-4 on float32 logits of magnitude ~1: the two
frameworks sum matrix products in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.cache.paged import PagedKVCache as JaxCache
from distributed_llm_inference_tpu.config import LatentConfig as JaxLatentConfig
from distributed_llm_inference_tpu.config import ModelConfig as JaxModelConfig
from distributed_llm_inference_tpu.config import RopeScaling as JaxRopeScaling
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu_torch.cache.paged import PagedKVCache
from distributed_llm_inference_tpu_torch.config import (
    LatentConfig,
    ModelConfig,
    RopeScaling,
)
from distributed_llm_inference_tpu_torch.models import llama as tllama

torch.set_num_threads(1)
ATOL = 1e-4
KW = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=3,
          num_heads=4, num_kv_heads=2, head_dim=16)
B, P, PS, T = 3, 32, 8, 5


def models(**extra):
    jkw, tkw = dict(KW, **extra), dict(KW, **extra)
    if "rope_scaling" in extra:
        jkw["rope_scaling"] = JaxRopeScaling(**extra["rope_scaling"])
        tkw["rope_scaling"] = RopeScaling(**extra["rope_scaling"])
    jcfg, tcfg = JaxModelConfig(**jkw), ModelConfig(**tkw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    if jcfg.qkv_bias:  # init leaves biases at zero: give them content
        rng = np.random.default_rng(5)
        for name in ("bq", "bk", "bv"):
            shape = jparams["layers"][name].shape
            jparams["layers"][name] = jnp.asarray(
                rng.standard_normal(shape).astype(np.float32) * 0.1)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = tllama.params_from_numpy(tcfg, tree, torch.float32, "cpu")
    return jcfg, jparams, tcfg, tparams


def caches(cfg, use_kernels):
    tc = PagedKVCache.create(
        cfg.num_layers, B, P, PS, T, cfg.num_kv_heads, cfg.head_dim,
        torch.float32, use_kernel=use_kernels, use_ragged=use_kernels,
        device="cpu")
    jc = JaxCache.create(
        cfg.num_layers, B, P, PS, T, cfg.num_kv_heads, cfg.head_dim,
        jnp.float32)
    for row in range(B):
        pages = list(range(1 + row * T, 1 + (row + 1) * T))
        tc.assign_pages(row, pages)
        jc = jc.assign_pages(row, pages)
    return tc, jc


def test_params_cross_over_unchanged():
    jcfg, jparams, tcfg, tparams = models()
    assert set(tparams) == set(jparams)
    assert set(tparams["layers"]) == set(jparams["layers"])
    for name, w in jparams["layers"].items():
        got = tparams["layers"][name]
        assert tuple(got.shape) == tuple(w.shape) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tparams["lm_head"].numpy(), np.asarray(jparams["lm_head"]))
    # init_params of the port has the same tree, shapes and layout.
    mine = tllama.init_params(
        tcfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in mine["layers"].items()} == {
        k: tuple(v.shape) for k, v in jparams["layers"].items()}
    assert tuple(mine["embed"].shape) == tuple(jparams["embed"].shape)
    again = tllama.init_params(
        tcfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert torch.equal(mine["layers"]["wq"], again["layers"]["wq"])
    assert abs(float(mine["layers"]["wd"].std()) - 0.02) < 2e-3


@pytest.mark.parametrize("head", ["all", "last"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_logits_prefill_then_decode(head, use_kernels):
    jcfg, jparams, tcfg, tparams = models()
    tc, jc = caches(tcfg, use_kernels)
    rng = np.random.default_rng(1)
    s = 12
    tokens = rng.integers(0, 256, size=(B, s)).astype(np.int32)
    num_new = np.asarray([12, 5, 0], np.int32)  # a full, a short, an idle row
    jl, jc = jllama.model_apply(
        jcfg, jparams, jnp.asarray(tokens), jc, jnp.asarray(num_new), head=head)
    tl, tc2 = tllama.model_apply(
        tcfg, tparams, torch.as_tensor(tokens), tc, torch.as_tensor(num_new),
        head=head)
    assert tc2 is tc, "the cache is updated in place"
    assert tl.dtype == torch.float32
    assert tl.shape == (B, s if head == "all" else 1, 256)
    valid = (np.arange(s)[None, :] < num_new[:, None]) if head == "all" else (
        np.ones((B, 1), bool))
    np.testing.assert_allclose(
        tl.numpy()[valid], np.asarray(jl)[valid], atol=ATOL)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for step in range(3):
        tok = rng.integers(0, 256, size=(B, 1)).astype(np.int32)
        active = np.asarray([1, 1, 0], np.int32)
        jl, jc = jllama.model_apply(
            jcfg, jparams, jnp.asarray(tok), jc, jnp.asarray(active))
        tl, _ = tllama.model_apply(
            tcfg, tparams, torch.as_tensor(tok), tc, torch.as_tensor(active))
        np.testing.assert_allclose(
            tl.numpy()[:2], np.asarray(jl)[:2], atol=ATOL, err_msg=f"step {step}")
    assert tc.lengths.tolist() == [15, 8, 0]


def test_head_none_fills_the_cache_only():
    jcfg, jparams, tcfg, tparams = models()
    tc, jc = caches(tcfg, True)
    tokens = np.random.default_rng(2).integers(0, 256, size=(B, 8)).astype(np.int32)
    num_new = np.asarray([8, 8, 3], np.int32)
    logits, _ = tllama.model_apply(
        tcfg, tparams, torch.as_tensor(tokens), tc, torch.as_tensor(num_new),
        head="none")
    _, jc = jllama.model_apply(
        jcfg, jparams, jnp.asarray(tokens), jc, jnp.asarray(num_new), head="none")
    assert logits is None and tc.lengths.tolist() == [8, 8, 3]
    np.testing.assert_allclose(
        tc.k_pages.numpy()[:, 1:], np.asarray(jc.k_pages)[:, 1:], atol=1e-5)
    np.testing.assert_allclose(
        tc.v_pages.numpy()[:, 1:], np.asarray(jc.v_pages)[:, 1:], atol=1e-5)


@pytest.mark.parametrize("extra", [
    dict(sliding_window=6),
    dict(qkv_bias=True),
    dict(tie_word_embeddings=True),
    dict(rope_scaling=dict(rope_type="llama3", factor=8.0,
                           original_max_position_embeddings=16)),
], ids=["sliding_window", "qkv_bias", "tied", "llama3_rope"])
def test_config_variants(extra):
    jcfg, jparams, tcfg, tparams = models(**extra)
    tc, jc = caches(tcfg, True)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, size=(B, 16)).astype(np.int32)
    num_new = np.asarray([16, 9, 1], np.int32)
    jl, jc = jllama.model_apply(
        jcfg, jparams, jnp.asarray(tokens), jc, jnp.asarray(num_new), head="last")
    tl, _ = tllama.model_apply(
        tcfg, tparams, torch.as_tensor(tokens), tc, torch.as_tensor(num_new),
        head="last")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    tok = rng.integers(0, 256, size=(B, 1)).astype(np.int32)
    one = np.ones(B, np.int32)
    jl, _ = jllama.model_apply(jcfg, jparams, jnp.asarray(tok), jc, jnp.asarray(one))
    tl, _ = tllama.model_apply(
        tcfg, tparams, torch.as_tensor(tok), tc, torch.as_tensor(one))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_families_that_wait_raise():
    """The latent family runs now: its init is the JAX package's MLA
    parameter set, shape for shape. Without a card the default device
    still raises."""
    lat = LatentConfig()
    cfg = ModelConfig(**KW, latent=lat, family="mla")
    params = tllama.init_params(cfg, None, torch.float32, "cpu")
    jp = jllama.init_params(
        JaxModelConfig(**KW, latent=JaxLatentConfig(), family="mla"),
        jax.random.PRNGKey(0), jnp.float32)
    assert {k: tuple(v.shape) for k, v in params["layers"].items()} == {
        k: tuple(v.shape) for k, v in jp["layers"].items()}
    assert params["layers"]["wk_b"].shape[2:] == (
        KW["num_heads"], KW["head_dim"]) and lat.lat_dim == 80
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tllama.init_params(ModelConfig(**KW))
