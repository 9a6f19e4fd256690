"""Port parity, the engine over the StreamingLLM sink ring: the same weights
and submissions go to the JAX ``InferenceEngine`` and to the port's (on
``device="cpu"``, float32) with ``CacheConfig(kind="sink")`` in the model
dtype and with ``kv_quant="int8"`` (window 24, 2 sinks: a ring span of 22,
planes 32 wide), at ``decode_steps`` None, 4 and 1, with the attention
kernels (``use_pallas_attention``) on and off. With them, the JAX engine
runs its Pallas kernels in interpret mode and the port
(``attention_backend="cuda"``) its wrappers, which take their plain
versions on CPU tensors: flash prefill for the model-dtype ring (K = 1 at
None: it has no tail), and for the int8 ring the fused window's step (#11)
and flush (#12). Greedy token streams, the events of every ``step()`` and
the finish reasons must be IDENTICAL in every case.

The script (the JAX package's ``test_engine_quantized_sink_kernel_matches_xla``
prompts, 40 new tokens, two slots) runs every stream far past the window,
adds a prompt longer than the ring span (chunked at 22 tokens), one whose
``max_new_tokens`` is not a multiple of K, and a cancel while decoding.
Spies show which kernel wrappers ran."""

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
from distributed_llm_inference_tpu_torch.cache.sink import (
    QuantizedSinkKVCache,
    SinkKVCache,
)
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.engine.sampling import SamplingOptions
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import flash_attention as tfa
from distributed_llm_inference_tpu_torch.ops import quant_attention as tqa

torch.set_num_threads(1)
MODEL = dict(vocab_size=64, hidden_size=32, intermediate_size=96,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8)
JPARAMS = jllama.init_params(jcfg.ModelConfig(**MODEL), jax.random.PRNGKey(1),
                             dtype=jnp.float32)
TPARAMS = tllama.params_from_numpy(
    tcfg.ModelConfig(**MODEL), jax.tree_util.tree_map(np.asarray, JPARAMS),
    torch.float32, "cpu")
WINDOW, SINKS = 24, 2


def engines(kv_quant, kernels, decode_steps):
    e = dict(max_batch_size=2, max_seq_len=128, dtype="float32",
             use_pallas_attention=kernels, decode_steps=decode_steps)
    c = dict(kind="sink", window_length=WINDOW, num_sink_tokens=SINKS,
             kv_quant=kv_quant)
    jax_engine = JaxEngine(jcfg.ModelConfig(**MODEL), JPARAMS,
                           jcfg.EngineConfig(**e), jcfg.CacheConfig(**c))
    port = InferenceEngine(
        tcfg.ModelConfig(**MODEL), TPARAMS, tcfg.EngineConfig(**e),
        tcfg.CacheConfig(**c), device="cpu",
        attention_backend="cuda" if kernels else None)
    assert port.decode_steps == jax_engine.decode_steps
    assert port._pipelined == jax_engine._pipelined
    return jax_engine, port


def script():
    rng = np.random.default_rng(7)
    long_prompt = rng.integers(0, 64, size=30).tolist()
    return [
        {"submit": [([1, 2, 3, 4, 5, 6, 7], dict(max_new_tokens=40)),
                    ([9, 8, 7], dict(max_new_tokens=40)),
                    (list(range(11, 27)), dict(max_new_tokens=40))]},
        {"submit": [(long_prompt, dict(max_new_tokens=13)),
                    ([5], dict(max_new_tokens=30))]},
        {}, {}, {},
        {"cancel": [4]},
    ]


def drive(engine, options_cls, max_steps=400):
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


@pytest.fixture
def spies(monkeypatch):
    counts = {}
    for owner, name in ((tfa, "flash_attention"),
                        (tqa, "sink_fused_decode_attention"),
                        (tqa, "sink_tail_flush")):
        real = getattr(owner, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(owner, name, spy)
    return counts


CASES = [(kv, kernels, k) for kv in (None, "int8") for kernels in (False, True)
         for k in (None, 4, 1)]


@pytest.mark.parametrize(
    "kv_quant,kernels,decode_steps", CASES,
    ids=[f"{kv or 'model_dtype'}-{'kernels' if kn else 'plain'}-k{k}"
         for kv, kn, k in CASES])
def test_engine_matches_jax(kv_quant, kernels, decode_steps, spies):
    jax_engine, port = engines(kv_quant, kernels, decode_steps)
    want = drive(jax_engine, JaxOptions)
    spies.clear()
    got = drive(port, SamplingOptions)
    assert got[0] == want[0], "token streams differ"
    assert got[2] == want[2], "finish reasons differ"
    assert got[1] == want[1], "per-tick events differ"
    assert got[2] == ["length", "length", "length", "length", "cancelled"]
    assert [len(g) for g in got[0][:4]] == [40, 40, 40, 13]
    cls = QuantizedSinkKVCache if kv_quant else SinkKVCache
    assert type(port.cache) is cls
    k = port.decode_steps
    assert k == (decode_steps or (16 if kv_quant else 1))
    layers = MODEL["num_layers"]
    if kv_quant and kernels and k > 1:
        steps = spies["sink_fused_decode_attention"] // layers
        assert spies["sink_fused_decode_attention"] == layers * steps > 0
        assert steps % k == 0 and spies["sink_tail_flush"] == steps // k
        assert "flash_attention" not in spies
    elif kernels and not kv_quant:
        assert set(spies) == {"flash_attention"}
    else:
        assert spies == {}
