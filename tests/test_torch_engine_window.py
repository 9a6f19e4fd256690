"""Port parity, the engine's fused K-step decode: the same weights and
submissions go to the JAX ``InferenceEngine`` and to the port's (on
``device="cpu"``, float32) at ``decode_steps`` None (16 on these caches),
4 and 16, with pipelined ticks and overlapped admission on and off, over
the model-dtype pool with its decode kernel, the int8 pool on its kernel
and segments forms, and int4 weights. Greedy token streams, the events of
every ``step()`` and the finish reasons must be IDENTICAL; both engines
resolve ``decode_steps=None`` to the same K.

The scripts end streams inside a window: by EOS, ``max_new_tokens``, a
cancel, a deadline and page capacity; a long prompt chunk-admits beside a
live window; one stream crosses the int8 pool's ``INPLACE_CTX`` (moved
down on both classes), so it runs the gathered form and then the in-place
form. Spies show that the windows ran (``DecodeWindow.step``) and which
kernel wrappers they called."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.cache.paged import (
    QuantizedPagedKVCache as JaxQCache,
)
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from distributed_llm_inference_tpu.engine.sampling import SamplingOptions as JaxOptions
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache.paged import QuantizedPagedKVCache
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.engine.sampling import SamplingOptions
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa
from distributed_llm_inference_tpu_torch.ops import quant_attention as tqa

torch.set_num_threads(1)
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
JPARAMS = jllama.init_params(
    jcfg.ModelConfig(**MODEL), jax.random.PRNGKey(0), dtype=jnp.float32)
TPARAMS = tllama.params_from_numpy(
    tcfg.ModelConfig(**MODEL), jax.tree_util.tree_map(np.asarray, JPARAMS),
    torch.float32, "cpu")


def engines(kernels=True, kv_quant=None, num_pages=64, max_pages=8,
            chunk=None, **ekw):
    """The JAX engine and the port's on one configuration. ``kernels``:
    the decode kernel route on both (``use_pallas_attention``), else the
    default plan (the JAX engine's and the port's CPU plan alike)."""
    e = dict(max_batch_size=4, prefill_buckets=(8, 16, 32), max_seq_len=64,
             dtype="float32", ragged_attention=True, prefill_chunk_tokens=chunk,
             **ekw)
    if kernels:
        e["use_pallas_attention"] = True
    c = dict(kind="paged", page_size=8, num_pages=num_pages,
             max_pages_per_session=max_pages, kv_quant=kv_quant)
    jax_engine = JaxEngine(
        jcfg.ModelConfig(**MODEL), JPARAMS, jcfg.EngineConfig(**e),
        jcfg.CacheConfig(**c))
    port = InferenceEngine(
        tcfg.ModelConfig(**MODEL), TPARAMS, tcfg.EngineConfig(**e),
        tcfg.CacheConfig(**c), device="cpu",
        attention_backend="cuda" if kernels else None)
    assert port.decode_steps == jax_engine.decode_steps
    assert port._pipelined == jax_engine._pipelined
    return jax_engine, port


def prompts(n, lo=3, hi=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def drive(engine, options_cls, script, max_steps=300):
    """Run ``script`` — per tick, prompts to submit (with option fields),
    submission indices to cancel and to expire (deadline now) — then drain.
    Returns the streams, the events of every tick with generation ids
    replaced by submission indices, and the finish reasons."""
    sessions, index, ticks = [], {}, []
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
        step += 1
        assert step < max_steps, "engine did not drain"
    return ([list(s.generated) for s in sessions], ticks,
            [s.finish_reason for s in sessions])


@pytest.fixture
def spies(monkeypatch):
    """Calls of the fused window's step and of the kernel wrappers."""
    counts = {}
    targets = [(tllama.DecodeWindow, "step"), (tpa, "paged_attention"),
               (tpa, "quantized_paged_attention"),
               (tpa, "quantized_paged_fused_attention"),
               (tpa, "paged_tail_flush"),
               (tqa, "quantized_fused_decode_attention")]
    for owner, name in targets:
        real = getattr(owner, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(owner, name, spy)
    return counts


def script_mixed(eos):
    """Ten streams through 4 slots: EOS and max_new_tokens mid-window, a
    cancel and a deadline while decoding, late arrivals."""
    ps = prompts(8, seed=3)
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
                    (ps[6], dict(max_new_tokens=5))]},
        {"expire": [4]},
        {"submit": [(ps[7], dict(max_new_tokens=6))]},
    ]


def eos_token(**kw):
    """A token that session 0 of :func:`script_mixed` emits mid-stream,
    from a free run of the port (the parity run then checks both)."""
    _, port = engines(**kw)
    ps = prompts(8, seed=3)
    out = port.generate([ps[0]], SamplingOptions(max_new_tokens=14))
    return out[0][5]


# (id, engine keywords): the model-dtype pool through its decode kernel and
# the int8 pool on either route, K = 16 (None), 8 or 4, pipelining and
# overlap on and off. The int8 tail is flushed by the kernel when it fits a
# page (K <= 8 here), else by the scatter, as in the JAX package.
MIXED = [
    ("bf16_pool_k16_pipelined_overlap", dict(decode_steps=None)),
    ("bf16_pool_k4_sync", dict(decode_steps=4, pipelined_ticks=False)),
    ("int8_pool_kernels_k8_no_overlap",
     dict(decode_steps=8, kv_quant="int8", overlap_admission=False)),
    ("int8_pool_segments_k4_pipelined",
     dict(decode_steps=4, kv_quant="int8", kernels=False)),
    ("int4_int8_pool_k_none", dict(kv_quant="int8", quantization="int4")),
]


@pytest.mark.parametrize("kw", [m[1] for m in MIXED], ids=[m[0] for m in MIXED])
def test_engine_windows_match_jax(kw, spies):
    script = script_mixed(eos_token(**kw))
    jax_engine, port = engines(**kw)
    want = drive(jax_engine, JaxOptions, script)
    spies.clear()
    got = drive(port, SamplingOptions, script)
    assert got[0] == want[0], "token streams differ"
    assert got[2] == want[2], "finish reasons differ"
    assert got[1] == want[1], "per-tick events differ"
    assert got[2][:5] == ["eos", "cancelled", "length", "length", "deadline"]
    assert set(got[2][5:]) == {"length"}
    assert port.decode_steps == (kw.get("decode_steps") or 16)
    k = port.decode_steps
    assert spies["step"] % k == 0 and spies["step"] > 0
    windows = spies["step"] // k
    layers = MODEL["num_layers"]
    if kw.get("kv_quant") is None:
        assert spies["paged_attention"] == layers * spies["step"]
    elif kw.get("kernels", True):
        # Capacity 32 (4 pages of 8) gathers, 64 reads in place.
        fused = (spies.get("quantized_fused_decode_attention", 0)
                 + spies.get("quantized_paged_fused_attention", 0))
        assert fused == layers * spies["step"]
        assert spies.get("paged_tail_flush", 0) == (windows if k <= 8 else 0)
        assert "quantized_paged_attention" not in spies
    else:
        assert set(spies) == {"step"}
    assert port.allocator.free_count == 63
    if port._pipelined and port.ecfg.overlap_admission:
        assert port.metrics.get_counter("admit_overlap_sessions") == (
            jax_engine.metrics.get_counter("admit_overlap_sessions")) > 0


def test_switch_at_inplace_ctx_runs_both_forms(monkeypatch, spies):
    """INPLACE_CTX at 64 on both classes: while the table is 4 pages wide
    (32 slots) the window gathers (#9); a stream that outgrows it widens
    the table to 8 pages, and the window reads the pool in place (#6)."""
    monkeypatch.setattr(JaxQCache, "INPLACE_CTX", 64)
    monkeypatch.setattr(QuantizedPagedKVCache, "INPLACE_CTX", 64)
    script = [{"submit": [(p, dict(max_new_tokens=40))
                          for p in prompts(3, lo=10, hi=14, seed=5)]}]
    jax_engine, port = engines(kv_quant="int8")
    want = drive(jax_engine, JaxOptions, script)
    spies.clear()
    got = drive(port, SamplingOptions, script)
    assert got == want
    assert spies["quantized_fused_decode_attention"] > 0
    assert spies["quantized_paged_fused_attention"] > 0
    assert port.metrics.get_counter("cache_growths") > 0


def test_chunked_admission_beside_a_live_window_and_capacity():
    """A long greedy prompt chunk-admits while a window is live; short
    tables (4 pages a session) finish streams on capacity inside a
    window."""
    rng = np.random.default_rng(7)
    long_prompt = rng.integers(0, 256, size=22).tolist()
    script = [
        {"submit": [(p, dict(max_new_tokens=40)) for p in prompts(2, seed=6)]},
        {},
        {"submit": [(long_prompt, dict(max_new_tokens=8)),
                    (prompts(1, seed=9)[0], dict(max_new_tokens=3))]},
    ]
    jax_engine, port = engines(kv_quant="int8", max_pages=4, chunk=8,
                               chunk_decode_share=0.5, decode_steps=16)
    want = drive(jax_engine, JaxOptions, script)
    got = drive(port, SamplingOptions, script)
    assert got == want
    assert "capacity" in got[2]
    assert port.metrics.get_counter("attn_chunked_rows") == (
        jax_engine.metrics.get_counter("attn_chunked_rows")) > 0


def test_pool_pressure_with_windows():
    """9 usable pages, pipelined K=16 over the model-dtype pool: sessions
    wait for pages, grow into freed ones and finish on capacity.

    The JAX engine's pipelined resolve keeps a row's device carry when the
    row delivered its whole budget; when page capacity cut that budget
    below K, the carry holds -1 (the row stopped before the window's last
    step), and once pages free up the row's next window starts from token
    -1, which ``jnp.take`` wraps to the last vocabulary row. The port feeds
    such a row its last token (``ROADMAP.md`` queue 3). So on this input
    the port's pipelined streams are held to the synchronous ticks' (no
    carry), of both engines, and the JAX pipelined streams differ."""
    script = [{"submit": [(p, dict(max_new_tokens=30))
                          for p in prompts(5, lo=10, hi=14, seed=4)]}]
    jax_sync, port_sync = engines(num_pages=10, pipelined_ticks=False)
    want = drive(jax_sync, JaxOptions, script)
    assert drive(port_sync, SamplingOptions, script) == want
    jax_piped, port = engines(num_pages=10)
    got = drive(port, SamplingOptions, script)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[2] == ["capacity"] * 4 + ["length"]
    assert port.allocator.free_count == 9
    assert drive(jax_piped, JaxOptions, script)[0] != want[0]


def test_pages_freed_behind_a_cut_window():
    """5 usable pages, pipelined K=16: a row's window is cut by page
    capacity while another session still holds pages; that session's
    finish frees them before the next dispatch, whose budgets are set
    before the cut window resolves. The cut row must not decode from its
    in-flight carry (-1, the row stopped before the window's last step):
    it idles one tick and then continues from its last token. The port's
    pipelined streams equal the synchronous ticks' of both engines; the JAX
    pipelined engine's differ on this input (``ROADMAP.md`` queue 3)."""
    ps = prompts(3, lo=3, hi=20, seed=0)
    script = [{"submit": [(p, dict(max_new_tokens=m))
                          for p, m in zip(ps, (20, 10, 20))]}]
    jax_sync, port_sync = engines(num_pages=6, pipelined_ticks=False)
    want = drive(jax_sync, JaxOptions, script)
    assert drive(port_sync, SamplingOptions, script)[0::2] == want[0::2]
    jax_piped, port = engines(num_pages=6)
    got = drive(port, SamplingOptions, script)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[2] == ["capacity", "length", "length"]
    assert port.allocator.free_count == 5
    assert drive(jax_piped, JaxOptions, script)[0] != want[0]


def test_sampled_window_streams_repeat_for_a_seed():
    """Sampled rows in K-step windows: the same seed gives the same streams
    (the counter-based draw), another seed other streams."""
    def run(seed):
        port = InferenceEngine(
            tcfg.ModelConfig(**MODEL), TPARAMS,
            tcfg.EngineConfig(max_batch_size=4, prefill_buckets=(8, 16, 32),
                              max_seq_len=64, dtype="float32"),
            tcfg.CacheConfig(page_size=8, num_pages=64, max_pages_per_session=8,
                             kv_quant="int8"),
            generator=torch.Generator().manual_seed(seed), device="cpu")
        assert port.decode_steps == 16 and port._pipelined
        return port.generate(
            prompts(6, seed=9),
            SamplingOptions(max_new_tokens=20, temperature=0.9, top_k=40))

    assert run(1) == run(1)
    assert run(1) != run(2)
