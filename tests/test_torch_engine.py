"""Port parity, the engine's single-step decode path: the same weights and
the same submissions go to the JAX ``InferenceEngine`` (paged cache,
float32, ``decode_steps=1``, ``pipelined_ticks=False``) and to the port's
on ``device="cpu"`` with attention routed through the kernel wrappers
(their plain versions, since the tensors lie on the CPU). Greedy token
streams, the events of every tick and the finish reasons must be
IDENTICAL. ``decode_steps=1`` stays reachable on both engines; the fused
K-step windows, the default, are held to the JAX engine in
``test_torch_engine_window.py``."""

import collections
import dataclasses

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
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa
from distributed_llm_inference_tpu_torch.ops import quant_matmul as tqm
from distributed_llm_inference_tpu_torch.ops import ragged_attention as tra

torch.set_num_threads(1)
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
JPARAMS = jllama.init_params(
    jcfg.ModelConfig(**MODEL), jax.random.PRNGKey(0), dtype=jnp.float32)
TPARAMS = tllama.params_from_numpy(
    tcfg.ModelConfig(**MODEL), jax.tree_util.tree_map(np.asarray, JPARAMS),
    torch.float32, "cpu")


def engines(batch=4, chunk=None, num_pages=64, kv_quant=None,
            attention_backend="cuda", with_jax=True, **ekw):
    """The JAX engine (None without ``with_jax``) and the port's on one
    paged configuration."""
    e = dict(max_batch_size=batch, prefill_buckets=(8, 16, 32), max_seq_len=64,
             dtype="float32", ragged_attention=True, prefill_chunk_tokens=chunk,
             decode_steps=1, pipelined_ticks=False, **ekw)
    c = dict(kind="paged", page_size=8, num_pages=num_pages,
             max_pages_per_session=8, kv_quant=kv_quant)
    jax_engine = JaxEngine(
        jcfg.ModelConfig(**MODEL), JPARAMS, jcfg.EngineConfig(**e),
        jcfg.CacheConfig(**c)) if with_jax else None
    port = InferenceEngine(
        tcfg.ModelConfig(**MODEL), TPARAMS, tcfg.EngineConfig(**e),
        tcfg.CacheConfig(**c), device="cpu",
        attention_backend=attention_backend)
    kernels = attention_backend == "cuda"
    assert port.cache.use_kernel == kernels and port.cache.use_ragged == kernels
    return jax_engine, port


def prompts(n, lo=3, hi=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def drive(engine, options_cls, script, max_steps=400):
    """Run ``script`` — per tick, prompts to submit (with option fields) and
    submission indices to cancel — then drain. Returns the streams, the
    events of every tick with generation ids replaced by submission indices,
    and the finish reasons."""
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
        ticks.append([(index[g], tok, fin) for g, tok, fin in engine.step()])
        step += 1
        assert step < max_steps, "engine did not drain"
    return ([list(s.generated) for s in sessions], ticks,
            [s.finish_reason for s in sessions])


def both(script, **kw):
    jax_engine, port = engines(**kw)
    want = drive(jax_engine, JaxOptions, script)
    got = drive(port, SamplingOptions, script)
    return got, want, port, jax_engine


def assert_identical(got, want):
    assert got[0] == want[0], "token streams differ"
    assert got[2] == want[2], "finish reasons differ"
    assert got[1] == want[1], "per-tick events differ"


def test_batch_larger_than_max_batch_size():
    opts = dict(max_new_tokens=6)
    script = [{"submit": [(p, opts) for p in prompts(10)]}]
    got, want, port, _ = both(script)
    assert_identical(got, want)
    assert all(len(s) == 6 for s in got[0])
    assert got[2] == ["length"] * 10
    assert port.metrics.get_counter("batched_prefills") > 0
    assert port.allocator.free_count == 63 and port.slots == [None] * 4
    assert port.collect_finished().keys() and not port.sessions


def test_engine_goes_through_both_wrappers(monkeypatch):
    calls = {"paged": 0, "ragged": 0}
    real_p, real_r = tpa.paged_attention, tra.ragged_paged_attention

    def paged(*a, **k):
        calls["paged"] += 1
        return real_p(*a, **k)

    def ragged(*a, **k):
        calls["ragged"] += 1
        return real_r(*a, **k)

    monkeypatch.setattr(tpa, "paged_attention", paged)
    monkeypatch.setattr(tra, "ragged_paged_attention", ragged)
    _, port = engines()
    out = port.generate(prompts(3), SamplingOptions(max_new_tokens=4))
    assert all(len(s) == 4 for s in out)
    layers = MODEL["num_layers"]
    ticks = int(port.metrics.snapshot()["decode_step_count"])
    assert calls["paged"] == layers * ticks
    assert calls["ragged"] >= layers
    assert tpa.launches == 0 and tra.launches == 0, "no kernel ran on the CPU"


def test_long_prompt_chunk_admitted_beside_live_decode():
    rng = np.random.default_rng(7)
    shorts = prompts(2)
    long_prompt = rng.integers(0, 256, size=50).tolist()
    opts = dict(max_new_tokens=12)
    script = [
        {"submit": [(p, opts) for p in shorts]},
        {},
        {"submit": [(long_prompt, opts), (prompts(3)[2], opts)]},
    ]
    got, want, port, jax_engine = both(script, chunk=16, chunk_decode_share=0.5)
    assert_identical(got, want)
    assert port.metrics.get_counter("attn_chunked_rows") == (
        jax_engine.metrics.get_counter("attn_chunked_rows")) > 0
    assert all(len(s) == 12 for s in got[0])
    # The long prompt's first token arrives ticks after the shorts': its
    # chunks rode the decode cadence.
    first_tick = {}
    for n, events in enumerate(got[1]):
        for i, _, _ in events:
            first_tick.setdefault(i, n)
    assert first_tick[2] > first_tick[3] == 2
    # Every attention dispatch left its (kind, shape) in the plan, the same
    # ones as the JAX engine's, and the counter counts them.
    shapes = port.plan.dispatch_shapes
    assert shapes == jax_engine.plan._shapes
    assert {s[0] for s in shapes} == {"prefill", "chunk", "decode"}
    assert ("chunk", 1, 16) in shapes
    assert max(s[3] for s in shapes if s[0] == "decode") == (
        port.cache.page_table.shape[1])
    assert port.metrics.get_counter("attn_dispatch_shapes") == len(shapes)


def test_cancel_eos_and_length_finishes():
    ps = prompts(5, seed=3)
    # A free run of the port picks the EOS (the parity run checks both).
    _, free_run = engines(with_jax=False)
    streams = free_run.generate(ps, SamplingOptions(max_new_tokens=10))
    eos = streams[0][3]  # session 0 will stop at its 4th token (or earlier)
    script = [
        {"submit": [
            (ps[0], dict(max_new_tokens=10, eos_token_id=eos)),
            (ps[1], dict(max_new_tokens=10)),
            (ps[2], dict(max_new_tokens=3)),
            (ps[3], dict(max_new_tokens=1)),
            (ps[4], dict(max_new_tokens=10)),   # waits for a slot
        ]},
        {},
        {"cancel": [1]},
        {"submit": [(ps[1], dict(max_new_tokens=2))], "cancel": [5]},
    ]
    got, want, port, _ = both(script)
    assert_identical(got, want)
    streams, ticks, reasons = got
    assert reasons == ["eos", "cancelled", "length", "length", "length",
                       "cancelled"]
    assert streams[0][-1] == eos and len(streams[0]) <= 4
    assert 0 < len(streams[1]) < 10 and streams[5] == []
    assert [len(s) for s in streams[2:5]] == [3, 1, 10]
    events = [e for tick in ticks for e in tick]
    assert (1, -1, True) in events and (5, -1, True) in events
    assert port.allocator.free_count == 63


def test_pool_pressure_holds_the_queue():
    # 7 usable pages of 8 slots: a 12-token prompt takes 2, so three sessions
    # fit and the fourth waits although a batch slot is free; rows that
    # cannot grow finish with "capacity".
    ps = prompts(5, lo=12, hi=13, seed=4)
    script = [{"submit": [(p, dict(max_new_tokens=9)) for p in ps]}]
    jax_engine, port = engines(num_pages=8)
    for eng, cls in ((jax_engine, JaxOptions), (port, SamplingOptions)):
        for p, o in script[0]["submit"]:
            eng._submit_session(p, cls(**o))
        eng.step()
        assert eng.queue_depth() == 2 and eng.active_sessions() == 3
        assert eng.slots[3] is None
    got, want, port, _ = both(script, num_pages=8)
    assert_identical(got, want)
    assert "capacity" in got[2] and "length" in got[2]
    assert port.allocator.free_count == 7


def test_deadline_and_admission_order():
    _, port = engines()
    ps = prompts(6, seed=8)
    opts = SamplingOptions(max_new_tokens=3)
    port.set_admission_order(lambda pending: list(reversed(pending)))
    gids = [port.submit(p, opts) for p in ps[:5]]
    late = port.submit(ps[5], opts, deadline=0.0)  # already expired
    events = port.step()
    assert (late, -1, True) in events
    assert port.sessions[late].finish_reason == "deadline"
    assert port.sessions[gids[0]].slot is None, "reverse order: first waits"
    assert port.sessions[gids[4]].slot is not None
    while port.has_work():
        port.step()
    assert all(len(port.sessions[g].generated) == 3 for g in gids)
    with pytest.raises(ValueError):
        port.submit([])


def test_sampled_streams_repeat_for_a_seed_and_differ_across_seeds():
    def run(seed):
        port = InferenceEngine(
            tcfg.ModelConfig(**MODEL), TPARAMS,
            tcfg.EngineConfig(max_batch_size=4, prefill_buckets=(8, 16, 32),
                              max_seq_len=64, dtype="float32"),
            tcfg.CacheConfig(page_size=8, num_pages=64, max_pages_per_session=8),
            generator=torch.Generator().manual_seed(seed), device="cpu")
        assert not port.cache.use_kernel and not port.plan.enabled
        return port.generate(
            prompts(6, seed=9),
            SamplingOptions(max_new_tokens=8, temperature=0.9, top_k=40))

    assert run(1) == run(1)
    assert run(1) != run(2)


def test_capacity_rejection_matches():
    too_long = list(range(64))  # 64 + 1 > 8 pages * 8 slots
    script = [{"submit": [(too_long, dict(max_new_tokens=4)),
                          (prompts(1)[0], dict(max_new_tokens=4))]}]
    got, want, _, _ = both(script)
    assert_identical(got, want)
    assert got[2] == ["capacity", "length"] and got[0][0] == []


# Quantized serving: int4 (half-split) or int8 weights over the int8 page
# pool. The JAX engine runs once per configuration (its int4 projections are
# interpret-mode kernels); the port runs twice against it: through the
# kernel wrappers (attention_backend "cuda", their plain versions on the
# CPU) and on the default plan (the gather path).
QUANT_SCRIPT = [
    {"submit": [(p, dict(max_new_tokens=6)) for p in prompts(5, seed=12)]},
    {},
    {"submit": [(list(range(7, 47)), dict(max_new_tokens=6))],
     "cancel": [1]},
]
_QUANT_WANT = {}


@pytest.mark.parametrize("backend", ["cuda", None], ids=["kernels", "default"])
@pytest.mark.parametrize("quantization", ["int4", "int8"])
def test_quantized_serving_matches_jax(quantization, backend):
    kw = dict(chunk=16, chunk_decode_share=0.5, kv_quant="int8",
              quantization=quantization)
    jax_engine, port = engines(attention_backend=backend,
                               with_jax=quantization not in _QUANT_WANT, **kw)
    if quantization not in _QUANT_WANT:
        _QUANT_WANT[quantization] = (
            drive(jax_engine, JaxOptions, QUANT_SCRIPT),
            jax_engine.metrics.get_counter("attn_chunked_rows"),
            jax_engine.metrics.snapshot()["kv_bytes_per_token"],
        )
    want, chunked, kv_bytes = _QUANT_WANT[quantization]
    before = (tpa.quantized_launches, tra.quantized_launches,
              tqm.launches, tqm.stacked_launches)
    got = drive(port, SamplingOptions, QUANT_SCRIPT)
    assert_identical(got, want)
    assert got[2] == ["length", "cancelled", "length", "length", "length",
                      "length"]
    assert all(len(s) == 6 for i, s in enumerate(got[0]) if i != 1)
    assert port.metrics.snapshot()["kv_bytes_per_token"] == kv_bytes
    assert port.allocator.free_count == 63
    if backend == "cuda":
        # The long prompt rode the decode cadence, as in the JAX engine.
        assert port.metrics.get_counter("attn_chunked_rows") == chunked > 0
    assert before == (tpa.quantized_launches, tra.quantized_launches,
                      tqm.launches, tqm.stacked_launches), (
        "no kernel ran on the CPU")


def test_quantized_engine_goes_through_the_int8_and_int4_wrappers(monkeypatch):
    calls = collections.Counter()
    for mod, name in ((tpa, "quantized_paged_attention"),
                      (tra, "quantized_ragged_paged_attention"),
                      (tqm, "int4_matmul"), (tqm, "int4_matmul_stacked")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    port = InferenceEngine(
        tcfg.ModelConfig(**MODEL), TPARAMS,
        tcfg.EngineConfig(max_batch_size=4, prefill_buckets=(8, 16, 32),
                          max_seq_len=64, dtype="float32", quantization="int4",
                          decode_steps=1),
        tcfg.CacheConfig(page_size=8, num_pages=64, max_pages_per_session=8,
                         kv_quant="int8"),
        device="cpu", attention_backend="cuda")
    out = port.generate(prompts(3), SamplingOptions(max_new_tokens=4))
    assert all(len(s) == 4 for s in out)
    layers = MODEL["num_layers"]
    ticks = int(port.metrics.snapshot()["decode_step_count"])
    prefills = int(port.metrics.snapshot()["prefill_count"])
    assert calls["quantized_paged_attention"] == layers * ticks
    assert calls["quantized_ragged_paged_attention"] == layers * prefills
    # Every projection of every layer, decode and (short) prefill alike; the
    # head (lm_head, 2-D) through the flat kernel once per dispatch.
    assert calls["int4_matmul_stacked"] == 7 * layers * (ticks + prefills)
    assert calls["int4_matmul"] == ticks + prefills


def test_plan_selects_the_kernels_for_the_int8_pool():
    from distributed_llm_inference_tpu_torch.engine.plan import AttentionPlan

    for kv_quant in (None, "int8"):
        cc = tcfg.CacheConfig(kv_quant=kv_quant)
        sel = AttentionPlan(tcfg.EngineConfig(), cc, backend="cuda").select()
        assert sel.use_pallas and sel.use_ragged
        sel = AttentionPlan(tcfg.EngineConfig(), cc, backend="cpu").select()
        assert not sel.use_pallas and not sel.use_ragged


WAITING = [
    # Sharded serving runs (item 12); int4 weights under tp or pp wait.
    ("mesh_cfg", dict(mesh_cfg=tcfg.MeshConfig(tp=2),
                      engine=dict(quantization="int4"))),
    # The latent family runs (item 10); int8/int4 weights on it wait.
    ("latent", dict(model=dict(latent=tcfg.LatentConfig(), family="mla"),
                    engine=dict(quantization="int8"))),
    ("trace_cfg", dict(trace_cfg=object())),
]


@pytest.mark.parametrize("name,kw", WAITING, ids=[w[0] for w in WAITING])
def test_waiting_features_raise_not_implemented(name, kw):
    cfg = tcfg.ModelConfig(**dict(MODEL, **kw.get("model", {})))
    extra = {k: v for k, v in kw.items() if k not in ("engine", "cache", "model")}
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1, item \d+"):
        InferenceEngine(
            cfg, TPARAMS,
            tcfg.EngineConfig(dtype="float32", **kw.get("engine", {})),
            tcfg.CacheConfig(**kw.get("cache", {})), device="cpu", **extra)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(tcfg.ModelConfig(**MODEL), TPARAMS)
    port = engines()[1]
    assert port.decode_steps == 1 and dataclasses.is_dataclass(port.ecfg)
