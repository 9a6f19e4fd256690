"""Port parity, the latent (MLA) family below the engine: the same inputs,
made from a numpy seed, through the JAX package and the port on the CPU.

* The four latent wrappers (``latent_ragged_paged_attention``,
  ``quantized_latent_ragged_paged_attention``, ``latent_paged_attention``,
  ``quantized_latent_paged_attention``) against the JAX ones in interpret
  mode, over f32 and int8 latent pools, f32 and bf16 queries, a window, m
  and l, at lat_dim 24 (``tests/test_latent.py``'s ``MLA_CFG``: rank 16 +
  rope 8) and 80 (the ``LatentConfig`` defaults). Tolerance: f32 1e-5
  (both sum in f32, in another order); bf16 queries give bf16 outputs
  computed in f32 and rounded once: one bf16 step of an output under 2,
  2^-7.
* Both latent caches' ``attend`` (gather path and the wrappers' route) and
  ``update_and_gather``, pools included, against the JAX caches.
* ``model_apply`` logits of the absorbed-MLA model (weights moved over by
  ``params_from_numpy``), atol 1e-4 on f32 logits of magnitude ~1.
* ``convert_hf_layer`` on DeepSeek-V2 keys, equal to the JAX conversion;
  ``load_config`` of DeepSeek-V2-Lite's ``config.json`` equal to JAX's.

The wrappers on the card (a stub library) and the engine's refusal of
latent widths no kernel takes are in ``test_torch_kernel_widths.py``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.cache import latent as jlatent
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu.ops import paged_attention as jpa
from distributed_llm_inference_tpu.ops import ragged_attention as jra
from distributed_llm_inference_tpu.ops import rotary as jrotary
from distributed_llm_inference_tpu.utils import checkpoint as jcheckpoint
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache import latent as tlatent
from distributed_llm_inference_tpu_torch.cache.dense import _quantize_kv
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa
from distributed_llm_inference_tpu_torch.ops import ragged_attention as tra
from distributed_llm_inference_tpu_torch.ops import rotary as trotary
from distributed_llm_inference_tpu_torch.utils import checkpoint as tcheckpoint

torch.set_num_threads(1)
F32_TOL = 1e-5
BF16_TOL = 2.0**-7
B, PS, T = 3, 4, 5          # rows, page size, table width
P = 1 + B * T               # pages (0 = the null page)
WIDTHS = [(4, 24), (3, 80)]  # (query heads over the latent, lat_dim)


def _pool(rng, d, int8):
    """A latent pool [P, 1, PS, d] as numpy, f32 or int8 + f32 scales
    (quantized by the port's ``_quantize_kv``, byte for byte JAX's)."""
    c = rng.standard_normal((P, 1, PS, d)).astype(np.float32)
    if not int8:
        return c, None
    q, s = _quantize_kv(torch.from_numpy(c))
    return q.numpy(), s.numpy()


def _table(rng):
    return (1 + rng.permutation(P - 1)[:B * T].reshape(B, T)).astype(np.int32)


def _close(got, want, bf16, what=""):
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(
        torch.as_tensor(got).float().numpy(),
        np.asarray(jnp.asarray(want, jnp.float32)), atol=tol, rtol=0,
        err_msg=what)


def _jq(q, bf16):
    return jnp.asarray(q, jnp.bfloat16 if bf16 else jnp.float32)


def _tq(q, bf16):
    return torch.from_numpy(q).to(torch.bfloat16 if bf16 else torch.float32)


# ---------------------------------------------------------------------------
# the four wrappers against the JAX ones in interpret mode
# ---------------------------------------------------------------------------

CASES = [(g, d, kind, int8, bf16)
         for g, d in WIDTHS for kind in ("ragged", "paged")
         for int8 in (False, True) for bf16 in (False, True)]


@pytest.mark.parametrize(
    "g,d,kind,int8,bf16", CASES,
    ids=[f"g{g}_d{d}_{k}_{'int8' if i else 'f32'}_q{'bf16' if b else 'f32'}"
         for g, d, k, i, b in CASES])
def test_wrappers_match_jax_interpret(g, d, kind, int8, bf16):
    """bf16 queries with a window of 5, f32 queries without; ragged rows: a
    prompt, a chunk from position 11, a row with no queries; decode rows: a
    long one, a full table, an empty one (zeros, m = _NEG_INF, l = 0)."""
    rng = np.random.default_rng(g * 100 + d)
    c, cs = _pool(rng, d, int8)
    table = _table(rng)
    window = 5 if bf16 else None
    jc, tc = jnp.asarray(c), torch.from_numpy(c)
    pools_j = (jc,) if cs is None else (jc, jnp.asarray(cs))
    pools_t = (tc,) if cs is None else (tc, torch.from_numpy(cs))
    if kind == "ragged":
        s = 9
        q = (rng.standard_normal((B, s, g, d)) * 0.3).astype(np.float32)
        q_start = np.array([0, 11, 6], np.int32)
        num_new = np.array([9, 3, 0], np.int32)
        lens = q_start + num_new
        jfn = (jra.quantized_latent_ragged_paged_attention if int8
               else jra.latent_ragged_paged_attention)
        tfn = (tra.quantized_latent_ragged_paged_attention if int8
               else tra.latent_ragged_paged_attention)
        want = jfn(_jq(q, bf16), *pools_j, table, lens, num_new,
                   q_start=q_start, sliding_window=window, interpret=True)
        got = tfn(_tq(q, bf16), *pools_t, torch.from_numpy(table),
                  torch.from_numpy(lens), torch.from_numpy(num_new),
                  q_start=torch.from_numpy(q_start), sliding_window=window)
        assert got.dtype == _tq(q, bf16).dtype and got.shape == q.shape
        _close(got, want, bf16)
        assert not got[2].any() and not got[1, 3:].any()  # pad queries: 0
        return
    q = (rng.standard_normal((B, 1, g, d)) * 0.3).astype(np.float32)
    lens = np.array([17, T * PS, 0], np.int32)
    jfn = (jpa.quantized_latent_paged_attention if int8
           else jpa.latent_paged_attention)
    tfn = (tpa.quantized_latent_paged_attention if int8
           else tpa.latent_paged_attention)
    want = jfn(_jq(q, bf16), *pools_j, table, lens, sliding_window=window,
               interpret=True, return_stats=True)
    got = tfn(_tq(q, bf16), *pools_t, torch.from_numpy(table),
              torch.from_numpy(lens), sliding_window=window,
              return_stats=True)
    _close(got[0], want[0], bf16, "out")
    assert got[1].shape == (B, 1, g) and got[2].shape == (B, 1, g)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5, err_msg="m")
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-5, err_msg="l")
    assert not got[0][2].float().any() and float(got[2][2].sum()) == 0.0


# ---------------------------------------------------------------------------
# the latent caches
# ---------------------------------------------------------------------------


def _caches(int8, kernels, lat_dim=24):
    """One-layer latent caches of both packages over the same pages."""
    jcls = (jlatent.QuantizedLatentPagedKVCache if int8
            else jlatent.LatentPagedKVCache)
    tcls = (tlatent.QuantizedLatentPagedKVCache if int8
            else tlatent.LatentPagedKVCache)
    jc = jcls.create(1, 2, 12, PS, 4, 1, lat_dim, use_kernel=kernels,
                     use_ragged=kernels)
    tc = tcls.create(1, 2, 12, PS, 4, 1, lat_dim, use_kernel=kernels,
                     use_ragged=kernels, device="cpu")
    for row, pages in enumerate(([3, 7, 1, 9], [2, 11, 5, 4])):
        jc = jc.assign_pages(row, pages)
        tc.assign_pages(row, pages)
    return jc, tc


def _state(cache):
    return tuple(stack[0] for stack in cache.layer_stacks)


def _rope(s):
    pos = np.zeros((2, s), np.int32)
    inv = jrotary.rope_inv_freq(8, 10000.0)
    cos, sin = jrotary.rope_cos_sin(jnp.asarray(pos), inv)
    tinv = trotary.rope_inv_freq(8, 10000.0)
    tcos, tsin = trotary.rope_cos_sin(torch.from_numpy(pos), tinv)
    return (jrotary.RopeAngles(inv, cos, sin),
            trotary.RopeAngles(tinv, tcos, tsin))


@pytest.mark.parametrize("int8,kernels", [
    (False, False), (False, True), (True, False), (True, True)],
    ids=["f32_gather", "f32_kernels", "int8_gather", "int8_kernels"])
def test_caches_attend_match_jax(int8, kernels):
    """A prefill (rows of 5 and 3 tokens) then a decode step: the outputs,
    the stored planes (never rotated) and the lengths equal the JAX
    cache's; the JAX cache's kernel route runs its kernels in interpret
    mode, the port's its wrappers' plain versions."""
    from distributed_llm_inference_tpu.ops.attention import gqa_attention as jg
    from distributed_llm_inference_tpu_torch.ops.attention import (
        gqa_attention as tg)

    rng = np.random.default_rng(7)
    jc, tc = _caches(int8, kernels)
    for s, num_new in ((5, [5, 3]), (1, [1, 1])):
        q = (rng.standard_normal((2, s, 4, 24)) * 0.3).astype(np.float32)
        kv = rng.standard_normal((2, s, 1, 24)).astype(np.float32)
        nn = np.array(num_new, np.int32)
        jr, tr = _rope(s)
        jpos = jc.q_positions(s)
        tpos = tc.q_positions(s)
        want, jstate = jc.attend(_state(jc), jnp.asarray(q), jnp.asarray(kv),
                                 jnp.asarray(kv), jr, jpos, jnp.asarray(nn),
                                 None, jg, 24**-0.5)
        got, _ = tc.attend(_state(tc), torch.from_numpy(q),
                           torch.from_numpy(kv), torch.from_numpy(kv), tr,
                           tpos, torch.from_numpy(nn), None, tg, 24**-0.5)
        valid = np.arange(s)[None, :] < nn[:, None]
        np.testing.assert_allclose(got.numpy()[valid],
                                   np.asarray(want)[valid], atol=F32_TOL)
        jc = jc.with_layer_stacks(*(x[None] for x in jstate)).advance(
            jnp.asarray(nn))
        tc.advance(torch.from_numpy(nn))
        for tp, jp in zip(tc.layer_stacks, jc.layer_stacks):
            np.testing.assert_array_equal(tp.numpy()[:, 1:],
                                          np.asarray(jp)[:, 1:])
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [6, 4]
    # The gather view of the next step, unrotated.
    q = (rng.standard_normal((2, 1, 4, 24)) * 0.3).astype(np.float32)
    kv = rng.standard_normal((2, 1, 1, 24)).astype(np.float32)
    jr, tr = _rope(1)
    nn = np.array([1, 1], np.int32)
    jq_, jk, jv, jm, _ = jc.update_and_gather(
        _state(jc), jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), jr,
        jc.q_positions(1), jnp.asarray(nn))
    tq_, tk, tv, tm, _ = tc.update_and_gather(
        _state(tc), torch.from_numpy(q), torch.from_numpy(kv),
        torch.from_numpy(kv), tr, tc.q_positions(1), torch.from_numpy(nn))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tk is tv
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_cache_limits_are_the_jax_ones():
    with pytest.raises(ValueError, match="ONE shared latent head"):
        tlatent.LatentPagedKVCache.create(1, 1, 4, 4, 2, 2, 24, device="cpu")
    _, tc = _caches(True, False)
    assert set(tc.PLANE_FIELDS) == {"c", "cs"}
    with pytest.raises(NotImplementedError, match="no write-behind tail"):
        tc.tail_init(4)
    with pytest.raises(TypeError, match="ingest_latent_row"):
        tc.ingest_row(None, None, 0)
    with pytest.raises(NotImplementedError, match="queue 1, item 14"):
        tc.ingest_latent_row({}, 0)
    view = tc.select_rows([1, 5])
    assert view.cs_pages is tc.cs_pages and view.k_pages is tc.k_pages


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

MLA = dict(vocab_size=128, hidden_size=64, intermediate_size=160,
           num_layers=2, num_heads=4, num_kv_heads=1, head_dim=16,
           family="mla")
LATENTS = {"r16_rope8": dict(rank=16, rope_head_dim=8),
           "defaults_80": dict(nope_head_dim=8)}


def _models(lat):
    jc = jcfg.ModelConfig(**MLA, latent=jcfg.LatentConfig(**LATENTS[lat]))
    tc = tcfg.ModelConfig(**MLA, latent=tcfg.LatentConfig(**LATENTS[lat]))
    jp = jllama.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    tp = tllama.params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                                  torch.float32, "cpu")
    return jc, jp, tc, tp


@pytest.mark.parametrize("lat,int8", [
    ("r16_rope8", False), ("r16_rope8", True), ("defaults_80", False)])
def test_model_logits_match_jax(lat, int8):
    """A prefill (a full row, a short one, an idle one) and two decode
    steps: the port through its kernel route (the wrappers' plain
    versions), the JAX model on its gather path."""
    jc, jp, tc, tp = _models(lat)
    lat_dim = tc.latent.lat_dim
    jcls = (jlatent.QuantizedLatentPagedKVCache if int8
            else jlatent.LatentPagedKVCache)
    tcls = (tlatent.QuantizedLatentPagedKVCache if int8
            else tlatent.LatentPagedKVCache)
    jcache = jcls.create(2, 3, 16, PS, 4, 1, lat_dim)
    tcache = tcls.create(2, 3, 16, PS, 4, 1, lat_dim, use_kernel=True,
                         use_ragged=True, device="cpu")
    for row in range(3):
        pages = list(range(1 + 4 * row, 5 + 4 * row))
        jcache = jcache.assign_pages(row, pages)
        tcache.assign_pages(row, pages)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 128, size=(3, 7)).astype(np.int32)
    nn = np.array([7, 4, 0], np.int32)
    # The JAX model jitted (one program a shape; the logits are held to
    # 1e-4, far above any difference a jit makes).
    japply = jax.jit(lambda t, c, n: jllama.model_apply(jc, jp, t, c, n))
    jl, jcache = japply(jnp.asarray(tokens), jcache, jnp.asarray(nn))
    tl, _ = tllama.model_apply(tc, tp, torch.from_numpy(tokens), tcache,
                               torch.from_numpy(nn))
    valid = np.arange(7)[None, :] < nn[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               atol=1e-4)
    for _ in range(2):
        tok = rng.integers(0, 128, size=(3, 1)).astype(np.int32)
        one = np.array([1, 1, 0], np.int32)
        jl, jcache = japply(jnp.asarray(tok), jcache, jnp.asarray(one))
        tl, _ = tllama.model_apply(tc, tp, torch.from_numpy(tok), tcache,
                                   torch.from_numpy(one))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   atol=1e-4)
    assert tcache.lengths.tolist() == [9, 6, 0]


def test_convert_hf_layer_equals_jax_on_deepseek_v2_keys():
    """One DeepSeek-V2 layer (q_proj, kv_a_proj_with_mqa, kv_a_layernorm,
    kv_b_proj split into wk_b and wv_b, o_proj, the MLP): the port's
    conversion equals the JAX one, tensor for tensor."""
    jc, _, tc, _ = _models("r16_rope8")
    rng = np.random.default_rng(4)
    h, hq, d, rank, dr = 64, 4, 16, 16, 8
    dn = d
    p = "model.layers.0."
    state = {
        p + "input_layernorm.weight": rng.standard_normal(h),
        p + "self_attn.q_proj.weight": rng.standard_normal((hq * (dn + dr), h)),
        p + "self_attn.kv_a_proj_with_mqa.weight":
            rng.standard_normal((rank + dr, h)),
        p + "self_attn.kv_a_layernorm.weight": rng.standard_normal(rank),
        p + "self_attn.kv_b_proj.weight":
            rng.standard_normal((hq * (dn + d), rank)),
        p + "self_attn.o_proj.weight": rng.standard_normal((h, hq * d)),
        p + "post_attention_layernorm.weight": rng.standard_normal(h),
        p + "mlp.gate_proj.weight": rng.standard_normal((160, h)),
        p + "mlp.up_proj.weight": rng.standard_normal((160, h)),
        p + "mlp.down_proj.weight": rng.standard_normal((h, 160)),
    }
    state = {k: v.astype(np.float32) for k, v in state.items()}
    want = jllama.convert_hf_layer(jc, state, 0, jnp.float32)
    got = tllama.convert_hf_layer(
        tc, {k: torch.from_numpy(v) for k, v in state.items()}, 0,
        torch.float32, "cpu")
    assert set(got) == set(want) == {
        "attn_norm", "wq", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo",
        "mlp_norm", "wg", "wu", "wd"}
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w),
                                      err_msg=name)


# deepseek-ai/DeepSeek-V2-Lite's config.json, restated (not downloaded).
DEEPSEEK_V2_LITE = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408,
    "num_hidden_layers": 27, "num_attention_heads": 16,
    "num_key_value_heads": 16, "n_routed_experts": 64, "n_shared_experts": 2,
    "num_experts_per_tok": 6, "first_k_dense_replace": 1,
    "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "rms_norm_eps": 1e-06,
    "rope_theta": 10000, "max_position_embeddings": 163840,
    "tie_word_embeddings": False,
    "rope_scaling": {"type": "yarn", "factor": 40, "beta_fast": 32,
                     "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096}}


def test_load_config_reads_deepseek_v2_as_jax_does(tmp_path):
    """``load_config`` maps ``kv_lora_rank`` to the mla family, reads no
    routed experts (every layer the dense MLP of intermediate_size), and
    keeps yarn, which the rotary tables refuse, as JAX's do."""
    with open(tmp_path / "config.json", "w") as f:
        json.dump(DEEPSEEK_V2_LITE, f)
    got = tcheckpoint.load_config(str(tmp_path))
    want = jcheckpoint.load_config(str(tmp_path))
    gd, wd = dataclasses.asdict(got), dataclasses.asdict(want)
    assert gd == wd
    assert got.family == "mla" and got.num_experts == 0
    assert got.latent.lat_dim == 576 and got.num_heads == 16
    with pytest.raises(ValueError, match="yarn"):
        jrotary.rope_inv_freq(64, 10000.0, want.rope_scaling)
    with pytest.raises(ValueError, match="yarn"):
        trotary.rope_inv_freq(64, 10000.0, got.rope_scaling)
