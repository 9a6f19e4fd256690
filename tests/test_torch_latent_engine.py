"""Port parity, the engine over a latent (MLA) model: the same weights and
submissions go to the JAX ``InferenceEngine`` and to the port's
(``device="cpu"``, float32), and the greedy token streams, the events of
every ``step()`` and the finish reasons must be IDENTICAL, over the f32 and
the int8 latent pools, at ``decode_steps`` None (1: a latent pool has no
write-behind tail) and an explicit 4 (``model_apply`` four times a
dispatch), ragged on and off, with a cancel. ``kv_bytes_per_token`` and
``latent_decompress_dispatches`` equal the JAX engine's. The JAX engine
takes its gather path; the port's takes the latent wrappers' route
(``attention_backend="cuda"``: their plain versions on CPU tensors), or
its gather path where ragged is off and the kernels with it.

Then the command line: ``info`` and ``local`` on a tiny DeepSeek-V2
checkpoint in the HF layout print what the JAX ``cli.main`` prints."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import cli as jcli
from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from distributed_llm_inference_tpu.engine.sampling import SamplingOptions as JaxOptions
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu.utils.checkpoint import save_safetensors
from distributed_llm_inference_tpu_torch import cli
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache.latent import (
    LatentPagedKVCache, QuantizedLatentPagedKVCache)
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.engine.sampling import SamplingOptions
from distributed_llm_inference_tpu_torch.models import llama as tllama

torch.set_num_threads(1)
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
             max_position_embeddings=256, family="mla")
LATENT = dict(rank=16, rope_head_dim=8)


def _configs():
    return (jcfg.ModelConfig(**MODEL, latent=jcfg.LatentConfig(**LATENT)),
            tcfg.ModelConfig(**MODEL, latent=tcfg.LatentConfig(**LATENT)))


PARAMS = {}


def params():
    if not PARAMS:
        jc, tc = _configs()
        jp = jllama.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
        PARAMS["jax"] = jp
        PARAMS["port"] = tllama.params_from_numpy(
            tc, jax.tree_util.tree_map(np.asarray, jp), torch.float32, "cpu")
    return PARAMS["jax"], PARAMS["port"]


def engines(kv_quant, decode_steps, ragged, kernels):
    jc, tc = _configs()
    jp, tp = params()
    e = dict(max_batch_size=3, prefill_buckets=(16,), max_seq_len=64,
             dtype="float32", ragged_attention=ragged,
             decode_steps=decode_steps)
    c = dict(kv_quant=kv_quant, page_size=8, num_pages=48,
             max_pages_per_session=8)
    jax_engine = JaxEngine(jc, jp, jcfg.EngineConfig(**e),
                           jcfg.CacheConfig(**c))
    port = InferenceEngine(
        tc, tp, tcfg.EngineConfig(**e, use_pallas_attention=kernels),
        tcfg.CacheConfig(**c), device="cpu",
        attention_backend="cuda" if kernels else None)
    assert port.decode_steps == jax_engine.decode_steps
    assert port._pipelined == jax_engine._pipelined is False
    assert port._fused is None
    return jax_engine, port


def script():
    """Five greedy streams through 3 rows: prompts of 16-30 tokens (those
    past the 16-token bucket chunked), one of 5; a budget cut mid-dispatch,
    a cancel, a late arrival."""
    rng = np.random.default_rng(7)
    p = [rng.integers(0, 256, size=n).tolist() for n in (30, 16, 5, 23, 19)]
    return [
        {"submit": [(p[0], dict(max_new_tokens=20)),
                    (p[1], dict(max_new_tokens=7)),
                    (p[2], dict(max_new_tokens=18))]},
        {"submit": [(p[3], dict(max_new_tokens=12))]},
        {},
        {"cancel": [2]},
        {"submit": [(p[4], dict(max_new_tokens=9))]},
    ]


def drive(engine, options_cls, max_steps=300):
    """Run :func:`script`, then drain. Returns the streams, the events of
    every tick with generation ids replaced by submission indices, and the
    finish reasons."""
    sessions, index, ticks, step = [], {}, [], 0
    plan = script()
    while step < len(plan) or engine.has_work():
        if step < len(plan):
            for prompt, opts in plan[step].get("submit", []):
                s = engine._submit_session(prompt, options_cls(**opts))
                index[s.generation_id] = len(sessions)
                sessions.append(s)
            for i in plan[step].get("cancel", []):
                engine.cancel(sessions[i].generation_id)
        ticks.append([(index[g], tok, fin) for g, tok, fin in engine.step()])
        step += 1
        assert step < max_steps, "engine did not drain"
    return ([list(s.generated) for s in sessions], ticks,
            [s.finish_reason for s in sessions])


# (id, kv_quant, decode_steps, ragged, the port's kernels route)
CASES = [
    ("f32-k_none-ragged", None, None, True, True),
    ("int8-k4-ragged", "int8", 4, True, True),
    ("f32-k4-decode_kernel", None, 4, False, True),
    ("int8-k_none-gather", "int8", None, False, False),
]


@pytest.mark.parametrize("kv_quant,decode_steps,ragged,kernels",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_engine_matches_jax(kv_quant, decode_steps, ragged, kernels):
    jax_engine, port = engines(kv_quant, decode_steps, ragged, kernels)
    assert isinstance(port.cache, QuantizedLatentPagedKVCache if kv_quant
                      else LatentPagedKVCache)
    assert port.cache.use_kernel == kernels
    assert port.cache.use_ragged == (ragged and kernels)
    want = drive(jax_engine, JaxOptions)
    got = drive(port, SamplingOptions)
    assert got[0] == want[0], "token streams differ"
    assert got[2] == want[2], "finish reasons differ"
    assert got[1] == want[1], "per-tick events differ"
    assert got[2] == ["length", "length", "cancelled", "length", "length"]
    assert port.decode_steps == (decode_steps or 1)
    # The stored form's bytes: 2 layers x 24 f32 latents, or 24 int8 + one
    # f32 scale, a token.
    kv_bytes = port.metrics.get_gauge("kv_bytes_per_token")
    assert kv_bytes == jax_engine.metrics.get_gauge("kv_bytes_per_token") == (
        2 * (24 + 4) if kv_quant else 2 * 24 * 4)
    n = port.metrics.get_counter("latent_decompress_dispatches")
    assert n == jax_engine.metrics.get_counter(
        "latent_decompress_dispatches") > 0


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mla_dir(tmp_path_factory):
    """A tiny DeepSeek-V2 checkpoint in the HF layout (q_proj,
    kv_a_proj_with_mqa, kv_a_layernorm, kv_b_proj, o_proj, the MLP) from
    the JAX package's random init, written by its writer."""
    d = tmp_path_factory.mktemp("mla")
    jc, _ = _configs()
    jp = jllama.init_params(jc, jax.random.PRNGKey(5), dtype=jnp.float32)
    lp, state = jp["layers"], {}
    hq, dn, dv = MODEL["num_heads"], MODEL["head_dim"], MODEL["head_dim"]
    for i in range(MODEL["num_layers"]):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = np.asarray(lp["attn_norm"][i])
        state[p + "self_attn.q_proj.weight"] = np.asarray(lp["wq"][i]).T
        state[p + "self_attn.kv_a_proj_with_mqa.weight"] = np.asarray(
            lp["wkv_a"][i]).T
        state[p + "self_attn.kv_a_layernorm.weight"] = np.asarray(
            lp["kv_norm"][i])
        kvb = np.concatenate([np.asarray(lp["wk_b"][i]),
                              np.asarray(lp["wv_b"][i])], axis=-1)
        state[p + "self_attn.kv_b_proj.weight"] = kvb.reshape(
            LATENT["rank"], hq * (dn + dv)).T
        state[p + "self_attn.o_proj.weight"] = np.asarray(lp["wo"][i]).T
        state[p + "post_attention_layernorm.weight"] = np.asarray(
            lp["mlp_norm"][i])
        for name, key in (("wg", "gate"), ("wu", "up"), ("wd", "down")):
            state[p + f"mlp.{key}_proj.weight"] = np.asarray(lp[name][i]).T
    state["model.embed_tokens.weight"] = np.asarray(jp["embed"])
    state["model.norm.weight"] = np.asarray(jp["final_norm"])
    state["lm_head.weight"] = np.asarray(jp["lm_head"]).T
    save_safetensors(state, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({
            "model_type": "deepseek_v2", "vocab_size": MODEL["vocab_size"],
            "hidden_size": MODEL["hidden_size"],
            "intermediate_size": MODEL["intermediate_size"],
            "num_hidden_layers": MODEL["num_layers"],
            "num_attention_heads": hq, "num_key_value_heads": hq,
            "kv_lora_rank": LATENT["rank"],
            "qk_rope_head_dim": LATENT["rope_head_dim"],
            "qk_nope_head_dim": dn, "v_head_dim": dv,
            "max_position_embeddings": MODEL["max_position_embeddings"],
        }, f)
    return str(d)


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_info_on_a_deepseek_v2_checkpoint_equals_the_jax_cli(mla_dir, capsys):
    argv = ["info", "--model", mla_dir]
    got, want = _run(cli.main, argv, capsys), _run(jcli.main, argv, capsys)
    assert got == want
    assert got["supported"] and got["family"] == "mla"


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_local_on_a_deepseek_v2_checkpoint_equals_the_jax_cli(
        mla_dir, capsys, kv_quant):
    argv = ["local", "--model", mla_dir, "--prompt-ids", "5,11,42,7",
            "--max-new", "6", "--dtype", "float32", "--max-seq-len", "64"]
    if kv_quant:
        argv += ["--kv-quant", kv_quant]
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    want = _run(jcli.main, argv, capsys)
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 6
    assert got["metrics"]["latent_decompress_dispatches"] == want["metrics"][
        "latent_decompress_dispatches"] > 0
