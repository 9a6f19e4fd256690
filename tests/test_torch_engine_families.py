"""Port parity, the engine over the model families beyond plain Llama: the
same weights and submissions go to the JAX ``InferenceEngine`` and to the
port's (``device="cpu"``, float32), and the greedy token streams, the
events of every ``step()`` and the finish reasons must be IDENTICAL.

This file holds Mixtral (``bench.py``'s ``TINY_MOE`` shapes: 4 experts,
top-2) on bf16 pages, int8 pages, the int8 dense cache and the int8 sink
ring at ``decode_steps`` None (16 where the window composes) and 1, int4
weights over int8 pages (the experts stay int8), the model-dtype dense
cache at K = 4 without pipelining and the model-dtype sink ring (K = 1),
and the helpers;
``test_torch_engine_families_attention.py`` holds Mistral's sliding
window, Qwen2's q/k/v biases and Llama's o_proj bias (the two files run
on two workers).

The model-dtype pool takes its decode kernel's route on both engines
(``use_pallas_attention``; the port's wrappers take their plain versions on
CPU tensors), the Mistral pools too, so that the window's masks go through
the wrappers; the other caches take their default CPU plan. The JAX
oracles are built once a module; every prompt fits one engine's table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from distributed_llm_inference_tpu.engine.sampling import SamplingOptions as JaxOptions
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.engine.sampling import SamplingOptions
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)
BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position_embeddings=256)
FAMILIES = {
    "mixtral": dict(BASE, num_experts=4, num_experts_per_tok=2,
                    family="mixtral"),
    "mistral": dict(BASE, sliding_window=8, family="mistral"),
    "qwen2": dict(BASE, qkv_bias=True, rope_theta=1e6, family="qwen2"),
    "llama_bo": dict(BASE),
    # 7 query heads over one kv head (Qwen2.5-7B's grouping): the kernels'
    # padded group at tiny widths.
    "gqa7": dict(BASE, num_heads=7, num_kv_heads=1),
}


def _params(family):
    """The JAX package's random init (seeded), with the experts scaled up
    so that routing moves the logits, and random q/k/v/o biases where the
    family has them; the port's copy through ``params_from_numpy``."""
    kw = FAMILIES[family]
    jp = jllama.init_params(jcfg.ModelConfig(**kw), jax.random.PRNGKey(0),
                            dtype=jnp.float32)
    layers = dict(jp["layers"])
    rng = np.random.default_rng(1)
    for k in ("we_g", "we_u", "we_d"):
        if k in layers:
            layers[k] = layers[k] * 10
    bias = {"qwen2": ("bq", "bk", "bv"), "llama_bo": ("bo",)}.get(family, ())
    for k in bias:
        width = layers["wo"].shape[-1] if k == "bo" else layers[
            "w" + k[1]].shape[-1]
        layers[k] = jnp.asarray(
            rng.standard_normal((BASE["num_layers"], width)) * 0.5, jnp.float32)
    jp = {**jp, "layers": layers}
    tp = tllama.params_from_numpy(
        tcfg.ModelConfig(**kw), jax.tree_util.tree_map(np.asarray, jp),
        torch.float32, "cpu")
    return jp, tp


PARAMS = {}


def params(family):
    if family not in PARAMS:
        PARAMS[family] = _params(family)
    return PARAMS[family]


def engines(family, kind="paged", kv_quant=None, kernels=False, **ekw):
    """The JAX engine and the port's on one configuration."""
    kw = FAMILIES[family]
    jp, tp = params(family)
    e = dict(max_batch_size=3, prefill_buckets=(16,), max_seq_len=64,
             dtype="float32", use_pallas_attention=kernels,
             ragged_attention=True, **ekw)
    c = dict(kind=kind, kv_quant=kv_quant)
    if kind == "paged":
        c.update(page_size=8, num_pages=48, max_pages_per_session=8)
    elif kind == "sink":
        c.update(window_length=40, num_sink_tokens=2)
    jax_engine = JaxEngine(jcfg.ModelConfig(**kw), jp, jcfg.EngineConfig(**e),
                           jcfg.CacheConfig(**c))
    port = InferenceEngine(
        tcfg.ModelConfig(**kw), tp, tcfg.EngineConfig(**e),
        tcfg.CacheConfig(**c), device="cpu",
        attention_backend="cuda" if kernels else None)
    assert port.decode_steps == jax_engine.decode_steps
    assert port._pipelined == jax_engine._pipelined
    return jax_engine, port


def script():
    """Five greedy streams through 3 rows: prompts of 16-30 tokens (those
    past the 16-token bucket chunk-admitted), one of 5; an EOS-free stream
    cut by its budget mid-window, a cancel, a late arrival."""
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


def check(family, k_want, **kw):
    jax_engine, port = engines(family, **kw)
    want = drive(jax_engine, JaxOptions)
    got = drive(port, SamplingOptions)
    assert got[0] == want[0], "token streams differ"
    assert got[2] == want[2], "finish reasons differ"
    assert got[1] == want[1], "per-tick events differ"
    assert got[2] == ["length", "length", "cancelled", "length", "length"]
    assert port.decode_steps == k_want
    return port


# (id, family, expected K, engine keywords)
MIXTRAL = [
    ("mixtral-bf16_pages-k_none", "mixtral", 16, dict(kernels=True)),
    ("mixtral-bf16_pages-k1", "mixtral", 1,
     dict(kernels=True, decode_steps=1)),
    ("mixtral-int8_pages-k_none", "mixtral", 16, dict(kv_quant="int8")),
    ("mixtral-int8_pages-k1", "mixtral", 1,
     dict(kv_quant="int8", decode_steps=1)),
    ("mixtral-int8_dense-k_none", "mixtral", 16,
     dict(kind="dense", kv_quant="int8")),
    ("mixtral-int8_dense-k1", "mixtral", 1,
     dict(kind="dense", kv_quant="int8", decode_steps=1)),
    ("mixtral-int8_sink-k_none", "mixtral", 16,
     dict(kind="sink", kv_quant="int8")),
    ("mixtral-int8_sink-k1", "mixtral", 1,
     dict(kind="sink", kv_quant="int8", decode_steps=1)),
    ("mixtral-int4_weights-int8_pages", "mixtral", 16,
     dict(kv_quant="int8", quantization="int4")),
    ("mixtral-bf16_dense-k4_sync", "mixtral", 4,
     dict(kind="dense", decode_steps=4, pipelined_ticks=False)),
    ("mixtral-bf16_sink-k_none", "mixtral", 1, dict(kind="sink")),
]


@pytest.mark.parametrize("family,k_want,kw", [c[1:] for c in MIXTRAL],
                         ids=[c[0] for c in MIXTRAL])
def test_engine_matches_jax(family, k_want, kw):
    port = check(family, k_want, **kw)
    if kw.get("quantization") == "int4":
        layer = port.params["layers"]
        assert tllama.int4_projections(port.cfg) == ("wq", "wk", "wv", "wo")
        assert {k for k, v in layer.items() if hasattr(v, "scale_lo")} == {
            "wq", "wk", "wv", "wo"}
        assert layer["we_g"].q.dtype == torch.int8


def test_int4_mixtral_calls_four_int4_projections_a_layer(monkeypatch):
    """The int4 layer-stacked matmul (through its wrapper, its plain version
    on CPU tensors): four calls a layer in the prefill and in each of the
    window's 16 steps, the experts through the int8 product."""
    layers = []
    real = tqm.int4_matmul_stacked

    def spy(*a, **k):
        layers.append(a[4])
        return real(*a, **k)

    monkeypatch.setattr(tqm, "int4_matmul_stacked", spy)
    _, port = engines("mixtral", kv_quant="int8", quantization="int4")
    out = port.generate([[5, 6, 7]], SamplingOptions(max_new_tokens=17))
    assert len(out[0]) == 17 and port.decode_steps == 16
    n = BASE["num_layers"]
    assert layers == [i for _ in range(17) for i in range(n) for _ in range(4)]
