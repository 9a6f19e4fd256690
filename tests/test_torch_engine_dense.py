"""Port parity, the engine over the dense caches: the same weights and
submissions go to the JAX ``InferenceEngine`` and to the port's (on
``device="cpu"``, float32) with ``CacheConfig(kind="dense")`` in the model
dtype and with ``kv_quant="int8"``, at ``decode_steps`` None (16 where the
tail composes), 1 and 4, with pipelined ticks and overlapped admission on
and off, and with the attention kernels (``use_pallas_attention``) on and
off. With them, the JAX engine runs its Pallas kernels in interpret mode
and the port (``attention_backend="cuda"``) its wrappers, which take their
plain versions on CPU tensors: flash prefill for the model-dtype cache
(K = 1 there, as in the JAX engine), and for the int8 cache #8 at K = 1,
#9 and #10 in the window. Greedy token streams, the events of every
``step()`` and the finish reasons must be IDENTICAL in every case: the
port's K-step path and the JAX one do not diverge on these inputs (the
kernels' plain versions repeat the TPU kernels' roundings).

The widths stay at or below 128 (the ladder 32, 64, 96, 128): the JAX
fused kernel tiles min(256, T) positions, so every tile is whole (in
interpret mode a partial last tile reads NaN padding).

The scripts end streams inside a window by EOS, ``max_new_tokens``, a
cancel, a deadline and the buffer's capacity, reject a prompt too long for
the cache, chunk a prompt past the largest bucket, grow the buffers along
two rungs of the ladder, and re-create them at the first rung when the
engine is idle. Spies show which kernel wrappers ran."""

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
from distributed_llm_inference_tpu_torch.cache.dense import (
    DenseKVCache,
    QuantizedDenseKVCache,
)
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.engine.sampling import SamplingOptions
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import flash_attention as tfa
from distributed_llm_inference_tpu_torch.ops import quant_attention as tqa

torch.set_num_threads(1)
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
JPARAMS = jllama.init_params(
    jcfg.ModelConfig(**MODEL), jax.random.PRNGKey(0), dtype=jnp.float32)
TPARAMS = tllama.params_from_numpy(
    tcfg.ModelConfig(**MODEL), jax.tree_util.tree_map(np.asarray, JPARAMS),
    torch.float32, "cpu")


def configs(kv_quant=None, kernels=False, max_seq_len=128, **ekw):
    """Engine and cache keywords of one dense configuration. ``kernels``:
    ``use_pallas_attention`` on both engines (the port's wrappers on the
    path), else off on both."""
    e = dict(max_batch_size=4, prefill_buckets=(8, 16, 32),
             max_seq_len=max_seq_len, dtype="float32",
             use_pallas_attention=kernels, **ekw)
    return e, dict(kind="dense", kv_quant=kv_quant), kernels


def port_engine(**kw):
    e, c, kernels = configs(**kw)
    return InferenceEngine(
        tcfg.ModelConfig(**MODEL), TPARAMS, tcfg.EngineConfig(**e),
        tcfg.CacheConfig(**c), device="cpu",
        attention_backend="cuda" if kernels else None)


def engines(**kw):
    """The JAX engine and the port's over one dense configuration
    (:func:`configs`)."""
    e, c, _ = configs(**kw)
    jax_engine = JaxEngine(
        jcfg.ModelConfig(**MODEL), JPARAMS, jcfg.EngineConfig(**e),
        jcfg.CacheConfig(**c))
    port = port_engine(**kw)
    assert port.decode_steps == jax_engine.decode_steps
    assert port._pipelined == jax_engine._pipelined
    assert port.cache.max_len == jax_engine.cache.max_len == 32
    return jax_engine, port


def prompts(n, lo=3, hi=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def drive(engine, options_cls, script, max_steps=400):
    """Run ``script`` — per tick, prompts to submit (with option fields),
    submission indices to cancel and to expire (deadline now) — then drain.
    Returns the streams, the events of every tick with generation ids
    replaced by submission indices, the finish reasons, and the widest the
    cache's buffers were after a tick."""
    sessions, index, ticks, widest = [], {}, [], 0
    step = 0
    while step < len(script) or engine.has_work():
        if step < len(script):
            for prompt, opts in script[step].get("submit", []):
                s = engine._submit_session(prompt, options_cls(**opts))
                index[s.generation_id] = len(sessions)
                sessions.append(s)
            for i in script[step].get("cancel", []):
                engine.cancel(sessions[i].generation_id)
            for i in script[step].get("expire", []):
                sessions[i].deadline = 0.0
        ticks.append([(index[g], tok, fin) for g, tok, fin in engine.step()])
        widest = max(widest, engine.cache.max_len)
        step += 1
        assert step < max_steps, "engine did not drain"
    return ([list(s.generated) for s in sessions], ticks,
            [s.finish_reason for s in sessions], widest)


@pytest.fixture
def spies(monkeypatch):
    """Calls of the fused window's step and of the new kernel wrappers."""
    counts = {}
    targets = [(tllama.DecodeWindow, "step"), (tfa, "flash_attention"),
               (tqa, "quantized_decode_attention"),
               (tqa, "quantized_fused_decode_attention"),
               (tqa, "fused_tail_flush")]
    for owner, name in targets:
        real = getattr(owner, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(owner, name, spy)
    return counts


def script_mixed(eos):
    """Eleven streams through 4 slots: EOS and max_new_tokens mid-window, a
    cancel and a deadline while decoding, a prompt too long for the cache
    (rejected), a 40-token prompt chunked past the 32-token bucket that
    grows the buffers from 32 to 64 and then to 96, late arrivals."""
    ps = prompts(8, seed=3)
    rng = np.random.default_rng(11)
    long_prompt = rng.integers(0, 256, size=40).tolist()
    too_long = rng.integers(0, 256, size=130).tolist()
    return [
        {"submit": [
            (ps[0], dict(max_new_tokens=14, eos_token_id=eos)),
            (ps[1], dict(max_new_tokens=20)),
            (ps[2], dict(max_new_tokens=7)),      # ends mid-window
            (ps[3], dict(max_new_tokens=2)),
            (ps[4], dict(max_new_tokens=30)),     # waits for a slot
        ]},
        {},
        {"cancel": [1]},
        {"submit": [(ps[5], dict(max_new_tokens=11)),
                    (too_long, dict(max_new_tokens=4)),
                    (ps[6], dict(max_new_tokens=5))]},
        {"expire": [4]},
        {"submit": [(long_prompt, dict(max_new_tokens=44)),
                    (ps[7], dict(max_new_tokens=6))]},
    ]


def eos_token(**kw):
    """A token that session 0 of :func:`script_mixed` emits mid-stream,
    from a free run of the port (the parity run then checks both)."""
    out = port_engine(**kw).generate([prompts(8, seed=3)[0]],
                        SamplingOptions(max_new_tokens=14))
    return out[0][5]


def check_mixed(kw, spies):
    """:func:`script_mixed` through both engines on ``kw``: identical
    streams, events and finish reasons; the kernel wrappers the path must
    call, and no other."""
    script = script_mixed(eos_token(**kw))
    jax_engine, port = engines(**kw)
    want = drive(jax_engine, JaxOptions, script)
    spies.clear()
    got = drive(port, SamplingOptions, script)
    assert got[0] == want[0], "token streams differ"
    assert got[2] == want[2], "finish reasons differ"
    assert got[1] == want[1], "per-tick events differ"
    assert got[2][:7] == ["eos", "cancelled", "length", "length", "deadline",
                          "length", "capacity"]
    assert set(got[2][7:]) == {"length"} and len(got[0][8]) == 44
    assert port.metrics.get_counter("sessions_rejected") == 1
    assert port.metrics.get_counter("cache_growths") == (
        jax_engine.metrics.get_counter("cache_growths")) >= 2
    assert got[3] == want[3] == 96
    assert port.cache.max_len == jax_engine.cache.max_len
    flash = kw.get("kernels") and not kw.get("kv_quant")
    k = port.decode_steps
    assert k == (kw.get("decode_steps") or (1 if flash else 16))
    layers = MODEL["num_layers"]
    if k > 1:
        assert spies["step"] % k == 0 and spies["step"] > 0
    if flash:
        assert set(spies) == {"flash_attention"}
    elif kw.get("kv_quant") and kw.get("kernels"):
        if k == 1:
            assert set(spies) == {"quantized_decode_attention"}
        else:
            windows = spies["step"] // k
            assert spies["quantized_fused_decode_attention"] == (
                layers * spies["step"])
            assert spies["fused_tail_flush"] == windows
            assert "quantized_decode_attention" not in spies
    else:
        assert set(spies) <= {"step"}
    if port._pipelined and port.ecfg.overlap_admission:
        assert port.metrics.get_counter("admit_overlap_sessions") == (
            jax_engine.metrics.get_counter("admit_overlap_sessions")) > 0


# (id, engine keywords): the model-dtype cache on both routes and the int8
# cache without its kernels, K = 16 (None), 4 and 1, pipelining and overlap
# on and off. The int8 cache's kernel routes are in
# test_torch_engine_dense_kernels.py, int4 weights in
# test_torch_engine_dense_int4.py (the three files share the time).
MIXED = [
    ("model_dtype_k16_pipelined_overlap", dict()),
    ("model_dtype_k4_sync", dict(decode_steps=4, pipelined_ticks=False)),
    ("model_dtype_k1", dict(decode_steps=1)),
    ("model_dtype_flash", dict(kernels=True)),
    ("int8_no_kernels_k16", dict(kv_quant="int8")),
    ("int8_no_kernels_k4_sync",
     dict(kv_quant="int8", decode_steps=4, pipelined_ticks=False)),
    ("int8_no_kernels_k1", dict(kv_quant="int8", decode_steps=1)),
]


@pytest.mark.parametrize("kw", [m[1] for m in MIXED], ids=[m[0] for m in MIXED])
def test_engine_matches_jax(kw, spies):
    check_mixed(kw, spies)


def check_shrink(kw):
    """A max_seq_len of 64: a stream runs into the buffers' capacity inside
    a window; once the engine is idle the buffers are re-created at the
    first rung, and a new session then grows them again (two growths)."""
    rng = np.random.default_rng(13)
    first = [{"submit": [(rng.integers(0, 256, size=40).tolist(),
                          dict(max_new_tokens=40)),
                         (prompts(1, seed=2)[0], dict(max_new_tokens=9))]}]
    second = [{"submit": [(rng.integers(0, 256, size=36).tolist(),
                           dict(max_new_tokens=5))]}]
    jax_engine, port = engines(max_seq_len=64, **kw)
    results = []
    for engine, opts in ((jax_engine, JaxOptions), (port, SamplingOptions)):
        results.append((drive(engine, opts, first), drive(engine, opts, second)))
    (ja, jb), (pa, pb) = results
    assert pa == ja and pb == jb and pa[3] == pb[3] == 64
    assert pa[2] == ["capacity", "length"] and len(pa[0][0]) == 24
    assert port.metrics.get_counter("cache_growths") == (
        jax_engine.metrics.get_counter("cache_growths")) == 2
    assert port.cache.max_len == jax_engine.cache.max_len


def test_shrink_when_idle_and_capacity_inside_a_window():
    check_shrink({})


def test_sink_caches_are_created():
    """Both sink kinds: the cache type and the bytes a window token holds
    over all layers (model dtype: K and V; int8: K and V and two f32
    scales); K resolves to 16 on the int8 ring with the kernels (ring span
    1020 >= 16), to 1 on the model-dtype ring (no tail)."""
    from distributed_llm_inference_tpu_torch.cache.sink import (
        QuantizedSinkKVCache,
        SinkKVCache,
    )

    for kv_quant, cls in ((None, SinkKVCache), ("int8", QuantizedSinkKVCache)):
        port = InferenceEngine(
            tcfg.ModelConfig(**MODEL), TPARAMS,
            tcfg.EngineConfig(dtype="float32", use_pallas_attention=True),
            tcfg.CacheConfig(kind="sink", kv_quant=kv_quant), device="cpu",
            attention_backend="cuda")
        assert type(port.cache) is cls
        assert port.decode_steps == (1 if kv_quant is None else 16)
        assert port.metrics.snapshot()["kv_bytes_per_token"] == (
            2 * 2 * 2 * 16 * 4 if kv_quant is None
            else 2 * 2 * (2 * 16 + 8))


def test_dense_caches_are_created():
    for kv_quant, cls in ((None, DenseKVCache), ("int8", QuantizedDenseKVCache)):
        port = engines(kv_quant=kv_quant, kernels=True)[1]
        assert type(port.cache) is cls
        assert port.metrics.snapshot()["kv_bytes_per_token"] == (
            2 * 2 * 2 * 16 * 4 if kv_quant is None
            else 2 * 2 * 2 * (16 + 4))
