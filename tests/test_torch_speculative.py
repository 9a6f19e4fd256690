"""Port parity, speculative decoding: the port's ``SpeculativeDecoder``
(``engine/speculative.py``) and the engine's draft branch against the JAX
package's, and against the port's own plain greedy engine.

The JAX side is built three times only (the decoder at k = 3 and the
engine over the dense and the paged cache, module-scoped); every other case
holds the port's speculative engine to the port's plain greedy engine, whose
parity with the JAX engine is pinned elsewhere. Float32, ``device="cpu"``,
the JAX tests' configs (``tests/test_speculative.py``: a 3-layer target, a
1-layer draft). The invariant: speculation changes how many target forwards
run, never the tokens; the port's streams and ``spec_stats`` equal the JAX
engine's. Besides: one host fetch a fused-rounds tick and nothing inside
its rounds that waits for the host; the verify rows through the paged
cache's multi-token route (the ragged kernels on the card) and no decode
kernel inside a speculative tick; the refusals in the JAX words; the
adaptive controller; ``local --speculative-draft``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from distributed_llm_inference_tpu.engine.sampling import SamplingOptions as JaxOptions
from distributed_llm_inference_tpu.engine.speculative import (
    SpeculativeDecoder as JaxDecoder)
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu_torch import cli
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache.dense import DenseKVCache
from distributed_llm_inference_tpu_torch.engine import engine as engine_mod
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.engine.sampling import SamplingOptions
from distributed_llm_inference_tpu_torch.engine.speculative import (
    SpeculativeDecoder)
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
from distributed_llm_inference_tpu_torch.ops import ragged_attention as ra
from distributed_llm_inference_tpu_torch.utils.streader import save_file

torch.set_num_threads(1)
TARGET = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_layers=3, num_heads=4, num_kv_heads=2, head_dim=8,
              max_position_embeddings=128)
DRAFT = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
             num_layers=1, num_heads=2, num_kv_heads=1, head_dim=8,
             max_position_embeddings=128)
JT, JD = jcfg.ModelConfig(**TARGET), jcfg.ModelConfig(**DRAFT)
T, D = tcfg.ModelConfig(**TARGET), tcfg.ModelConfig(**DRAFT)
JTP = jllama.init_params(JT, jax.random.PRNGKey(0), jnp.float32)
JDP = jllama.init_params(JD, jax.random.PRNGKey(7), jnp.float32)


def _port(cfg, tree):
    return tllama.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, tree), torch.float32, "cpu")


TP, DP = _port(T, JTP), _port(D, JDP)
K = 3


def _greedy(prompt, steps):
    """Target-only greedy decoding over a dense cache (the oracle)."""
    cache = DenseKVCache.create(T.num_layers, 1, 128, T.num_kv_heads,
                                T.head_dim, torch.float32, device="cpu")
    logits, _ = tllama.model_apply(
        T, TP, torch.tensor([prompt], dtype=torch.int32), cache,
        torch.tensor([len(prompt)], dtype=torch.int32))
    out = [int(torch.argmax(logits[0, len(prompt) - 1]))]
    for _ in range(steps - 1):
        logits, _ = tllama.model_apply(
            T, TP, torch.tensor([[out[-1]]], dtype=torch.int32), cache,
            torch.ones((1,), dtype=torch.int32))
        out.append(int(torch.argmax(logits[0, -1])))
    return out


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, T.vocab_size,
                         size=int(rng.integers(3, 10))).tolist()
            for _ in range(n)]


def _engine(draft=None, kind="dense", ecfg=None, ccfg=None, **kw):
    e = dict(max_batch_size=4, prefill_buckets=(8, 16, 32), max_seq_len=64,
             dtype="float32", speculative_k=K)
    e.update(ecfg or {})
    c = dict(kind=kind, page_size=8, num_pages=64, max_pages_per_session=8)
    c.update(ccfg or {})
    return InferenceEngine(T, TP, tcfg.EngineConfig(**e),
                           tcfg.CacheConfig(**c), draft=draft, device="cpu",
                           **kw)


def _run(engine, prompts, new, spec=lambda i: True, **opts):
    subs = [engine._submit_session(p, SamplingOptions(
        max_new_tokens=new, speculative=spec(i), **opts))
        for i, p in enumerate(prompts)]
    while engine.has_work():
        engine.step()
    return [s.generated for s in subs]


PLAIN = {}


def _plain(kind, prompts, new, ecfg=None, ccfg=None):
    key = (kind, json.dumps(prompts), new, json.dumps(ecfg),
           json.dumps(ccfg))
    if key not in PLAIN:
        PLAIN[key] = _engine(kind=kind, ecfg=ecfg, ccfg=ccfg).generate(
            prompts, SamplingOptions(max_new_tokens=new))
    return PLAIN[key]


# -- SpeculativeDecoder ------------------------------------------------------


def test_decoder_equals_the_jax_decoder():
    want = JaxDecoder(JT, JTP, JD, JDP, k=K, max_seq_len=128,
                      dtype=jnp.float32)
    got = SpeculativeDecoder(T, TP, D, DP, k=K, max_seq_len=128,
                             dtype=torch.float32, device="cpu")
    assert (got.generate([3, 14, 15], max_new_tokens=20)
            == want.generate([3, 14, 15], max_new_tokens=20))
    assert got.stats == want.stats
    assert got.acceptance_rate == want.acceptance_rate


@pytest.mark.parametrize("k", [1, 3, 4])
def test_decoder_equals_greedy_weak_draft(k):
    dec = SpeculativeDecoder(T, TP, D, DP, k=k, max_seq_len=128,
                             dtype=torch.float32, device="cpu")
    assert dec.generate([3, 14, 15], max_new_tokens=20) == _greedy(
        [3, 14, 15], 20)
    assert 0.0 <= dec.acceptance_rate <= 1.0


def test_decoder_equals_greedy_perfect_draft():
    dec = SpeculativeDecoder(T, TP, T, TP, k=4, max_seq_len=128,
                             dtype=torch.float32, device="cpu")
    assert dec.generate([9, 2, 5, 5], max_new_tokens=17) == _greedy(
        [9, 2, 5, 5], 17)
    assert dec.acceptance_rate == 1.0
    assert dec.stats["steps"] <= (17 // 5) + 1


def test_decoder_respects_eos():
    ref = _greedy([1, 2], 30)
    eos = ref[5]
    dec = SpeculativeDecoder(T, TP, D, DP, k=3, max_seq_len=128,
                             dtype=torch.float32, device="cpu")
    got = dec.generate([1, 2], max_new_tokens=30, eos_token_id=eos)
    assert got == ref[: ref.index(eos) + 1]


def test_a_vocabulary_mismatch_raises():
    bad = tcfg.ModelConfig(vocab_size=32, hidden_size=16,
                           intermediate_size=32, num_layers=1, num_heads=2,
                           num_kv_heads=1, head_dim=8)
    bp = tllama.init_params(bad, torch.Generator().manual_seed(1),
                            torch.float32, "cpu")
    with pytest.raises(ValueError, match="share a vocabulary"):
        SpeculativeDecoder(T, TP, bad, bp, device="cpu")
    with pytest.raises(ValueError, match="share a vocabulary"):
        _engine(draft=(bad, bp))


# -- the engine against the JAX engine ----------------------------------------

JAX_RUNS = {}


def _jax_engine_run(kind, prompts, new):
    """The JAX engine's streams and spec_stats: six prompts, alternate rows
    speculative, the default pipelined rounds (R = 16 // (k + 1) = 4)."""
    if kind not in JAX_RUNS:
        eng = JaxEngine(
            JT, JTP,
            jcfg.EngineConfig(max_batch_size=4, prefill_buckets=(8, 16, 32),
                              max_seq_len=64, dtype="float32",
                              speculative_k=K),
            jcfg.CacheConfig(kind=kind, page_size=8, num_pages=64,
                             max_pages_per_session=8),
            draft=(JD, JDP))
        subs = [eng._submit_session(p, JaxOptions(
            max_new_tokens=new, speculative=(i % 2 == 0)))
            for i, p in enumerate(prompts)]
        while eng.has_work():
            eng.step()
        JAX_RUNS[kind] = ([s.generated for s in subs], dict(eng.spec_stats),
                          eng.spec_rounds)
    return JAX_RUNS[kind]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_engine_equals_the_jax_engine(kind):
    ps = _prompts(6, 21)
    want, want_stats, rounds = _jax_engine_run(kind, ps, 12)
    eng = _engine(draft=(D, DP), kind=kind)
    assert eng.spec_rounds == rounds == 4 and not eng._pipelined
    got = _run(eng, ps, 12, spec=lambda i: i % 2 == 0)
    assert got == want
    assert eng.spec_stats == want_stats and want_stats["steps"] > 0
    assert got == _plain(kind, ps, 12)


# -- the port against its plain greedy engine ---------------------------------


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("rounds", [None, 1])
def test_synchronous_tick_equals_the_rounds(kind, rounds):
    ps = _prompts(6, 23)
    spec = lambda i: i % 3 != 2  # noqa: E731
    sync = _run(_engine(draft=(D, DP), kind=kind, ecfg=dict(
        pipelined_ticks=False)), ps, 10, spec)
    fused = _run(_engine(draft=(D, DP), kind=kind, ecfg=dict(
        speculative_rounds=rounds)), ps, 10, spec)
    assert sync == fused == _plain(kind, ps, 10)


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_self_draft_accepts_every_proposal(kind, pipelined):
    ps = _prompts(3, 22)
    eng = _engine(draft=(T, TP), kind=kind,
                  ecfg=dict(pipelined_ticks=pipelined))
    assert _run(eng, ps, 8) == _plain(kind, ps, 8)
    st = eng.spec_stats
    assert st["steps"] > 0 and st["accepted"] == st["proposed"], st


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_int8_targets_equal_plain_greedy(kind):
    """Over int8 KV the verify reads every position quantized, as a
    one-token decode does; a K-step window reads its own tail unquantized
    (the reference's int8-tail behaviour), so both engines run K = 1 here,
    the speculative one with 3 fused rounds a tick."""
    ps = _prompts(5, 24)
    c, e = dict(kv_quant="int8"), dict(decode_steps=1)
    for draft in ((D, DP), (T, TP)):
        eng = _engine(draft=draft, kind=kind, ccfg=c,
                      ecfg=dict(e, speculative_rounds=3))
        assert _run(eng, ps, 10, spec=lambda i: i != 1) == _plain(
            kind, ps, 10, ecfg=e, ccfg=c)
        assert eng.spec_stats["steps"] > 0


@pytest.mark.parametrize("kind,ecfg,match", [
    ("sink", {}, r"^speculative decoding needs rollback-capable caches "
                 r"\(dense/paged\); the sink ring evicts on write$"),
    ("dense", {"speculative_k": 0},
     r"^speculative_k must be >= 1 with a draft model, got 0$"),
])
def test_refusals_in_the_jax_words(kind, ecfg, match):
    """The JAX engine's refusals (``engine/engine.py:699-708``), word for
    word."""
    e = dict(max_batch_size=2, prefill_buckets=(8,), max_seq_len=64,
             dtype="float32", speculative_k=K)
    e.update(ecfg)
    with pytest.raises(ValueError, match=match):
        InferenceEngine(T, TP, tcfg.EngineConfig(**e),
                        tcfg.CacheConfig(kind=kind), draft=(D, DP),
                        device="cpu")


@pytest.mark.parametrize("pipelined", [True, False])
def test_capacity_disable_and_resume(pipelined):
    """Pool pressure (6 pages of 4) turns speculation off for some ticks;
    when pages free up it resumes with the draft caught up: with the
    target as its own draft acceptance stays total."""
    def mk(draft):
        return InferenceEngine(
            T, TP,
            tcfg.EngineConfig(max_batch_size=2, prefill_buckets=(8, 16),
                              max_seq_len=32, dtype="float32",
                              speculative_k=K, pipelined_ticks=pipelined),
            tcfg.CacheConfig(kind="paged", page_size=4, num_pages=6,
                             max_pages_per_session=8),
            draft=draft, device="cpu")

    pa_, pb = [3, 14, 15, 9], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5]
    ref = mk(None)
    ra_ = ref._submit_session(pa_, SamplingOptions(max_new_tokens=8))
    rb = ref._submit_session(pb, SamplingOptions(max_new_tokens=2))
    while ref.has_work():
        ref.step()
    eng = mk((T, TP))
    sa = eng._submit_session(pa_, SamplingOptions(max_new_tokens=8,
                                                  speculative=True))
    sb = eng._submit_session(pb, SamplingOptions(max_new_tokens=2))
    while eng.has_work():
        eng.step()
    assert (sa.generated, sb.generated) == (ra_.generated, rb.generated)
    st = eng.spec_stats
    assert st["proposed"] > 0 and st["accepted"] == st["proposed"], st


def _adaptive(draft, batch):
    return _engine(draft=draft, ecfg=dict(
        max_batch_size=batch, max_seq_len=128, decode_steps=4,
        speculative_rounds=1, speculative_adaptive=True,
        speculative_probe_len=2, speculative_probe_period=6))


def test_adaptive_suspends_on_low_acceptance_with_the_same_output():
    ps = _prompts(3, 33)
    e = dict(max_seq_len=128, decode_steps=4)
    eng = _adaptive((D, DP), 3)
    assert _run(eng, ps, 60) == _plain("dense", ps, 60, ecfg=e)
    snap = eng.metrics.snapshot()
    assert snap.get("spec_adapt_probes", 0) >= 1
    assert "spec_adapt_probes" in eng.metrics.prometheus()


def test_adaptive_keeps_speculating_with_a_perfect_draft():
    ps = _prompts(2, 34)
    eng = _adaptive((T, TP), 2)
    assert _run(eng, ps, 40) == _plain(
        "dense", ps, 40, ecfg=dict(max_seq_len=128, decode_steps=4))
    assert eng.metrics.snapshot().get("spec_adapt_probes", 0) == 0


def test_cancel_all_speculative_drains_the_pipeline():
    eng = _engine(draft=(D, DP), ecfg=dict(decode_steps=4))
    opts = SamplingOptions(max_new_tokens=10_000, speculative=True)
    subs = [eng._submit_session(p, opts) for p in _prompts(4, 55)]
    eng.step()
    eng.step()
    assert eng._spec_pending is not None
    for s in subs:
        eng.cancel(s.generation_id)
    for _ in range(20):
        if not eng.has_work():
            break
        eng.step()
    assert not eng.has_work(), "orphaned in-flight speculative tick"
    assert all(s.state.name == "CANCELLED" for s in subs)
    assert not eng._spec_carry_ok.any()


def test_spec_adapt_normalizes_per_spec_row():
    """Two windows at different speculative occupancy but the same tokens/s
    a row fold to the same rate (the JAX test of the same name)."""
    eng = _engine(draft=(T, TP), ecfg=dict(
        speculative_k=2, speculative_adaptive=True, speculative_probe_len=2,
        prefill_buckets=(8,)))
    clock = {"t": 0.0}
    tokens = {"n": 0.0}
    eng._spec_clock = lambda: clock["t"]
    eng._decode_tokens_total = lambda: tokens["n"]
    eng._session_wants_spec = lambda s: True

    def window(nspec, tok_per_row):
        eng.slots = [f"g{i}" for i in range(nspec)] + [None]
        eng.sessions = {f"g{i}": object() for i in range(nspec)}
        c = eng._spec_ctl
        c["comp"] = tuple(eng.slots)
        c.update(win_t0=clock["t"], win_tok0=tokens["n"], win_ticks=0,
                 stat0=dict(eng.spec_stats), skip=0)
        for _ in range(2):
            clock["t"] += 1.0
            tokens["n"] += nspec * tok_per_row
            eng._spec_adapt([])
        return eng._spec_ctl["spec_rate"]

    r1 = window(nspec=3, tok_per_row=5.0)
    assert r1 == pytest.approx(5.0)
    eng._spec_ctl["spec_rate"] = None
    assert window(nspec=1, tok_per_row=5.0) == pytest.approx(r1)


def test_prefix_caching_on_equals_off_with_speculative_rows():
    """Sharing on (pages of 4, a copy-on-write split of the bare system
    prompt) equals sharing off, and both equal plain greedy: rejected
    verify writes land at or past ``lengths``, in the row's own pages."""
    rng = np.random.default_rng(9)
    system = rng.integers(0, 64, size=12).tolist()
    ps = [system + rng.integers(0, 64, size=n).tolist() for n in (2, 5)]
    ps += [system, system + [7]]
    outs, counts = {}, {}
    for on in (True, False):
        eng = _engine(draft=(D, DP), kind="paged", ccfg=dict(
            page_size=4, prefix_caching=on))
        outs[on] = [_run(eng, [p], 9)[0] for p in ps]
        counts[on] = eng.metrics.snapshot()
    assert outs[True] == outs[False] == [_plain("paged", [p], 9)[0]
                                         for p in ps]
    assert counts[True].get("prefix_cow_copies", 0) >= 1
    assert counts[True].get("prefix_pages_shared", 0) >= 3


def test_a_sampled_plain_row_riding_the_rounds_is_deterministic():
    ps = _prompts(3, 61)

    def run(seed, record=None):
        eng = _engine(draft=(D, DP), generator=torch.Generator().manual_seed(
            seed))
        subs = [eng._submit_session(p, SamplingOptions(
            max_new_tokens=12, speculative=i < 2,
            temperature=0.0 if i < 2 else 0.9, top_k=0 if i < 2 else 20))
            for i, p in enumerate(ps)]
        while eng.has_work():
            eng.step()
        return [s.generated for s in subs]

    steps = []
    real = engine_mod.sample

    def recording(logits, key, sp, step=0):
        steps.append(int(step))
        return real(logits, key, sp, step)

    engine_mod.sample = recording
    try:
        a = run(5)
    finally:
        engine_mod.sample = real
    assert a == run(5)
    assert a[:2] == _plain("dense", ps[:2], 12) and len(a[2]) == 12
    # The rounds of a tick draw at steps 0..R-1, never one twice.
    assert set(steps) == set(range(_engine(draft=(D, DP)).spec_rounds))


class _NoHostSync:
    """Raises on every Tensor method that would wait for the device."""

    NAMES = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
             "__float__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(name):
            def f(*a, **k):
                raise AssertionError(f"Tensor.{name} inside the rounds")
            return f

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse(n))

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_rounds_tick_fetches_once_and_never_waits_inside(kind):
    eng = _engine(draft=(D, DP), kind=kind)
    fetches, per_tick, dispatched = [0], [], [0]
    real_fetch, real_rounds = eng._to_host, eng._spec_round_fn
    real_tick, real_dispatch = eng._speculative_rounds_tick, eng._spec_dispatch

    def dispatch(prev):
        out = real_dispatch(prev)
        dispatched[0] += out is not None
        return out

    def to_host(t):
        fetches[0] += 1
        return real_fetch(t)

    def rounds(*a):
        with _NoHostSync():
            return real_rounds(*a)

    def tick(produced):
        before = fetches[0]
        out = real_tick(produced)
        per_tick.append(fetches[0] - before)
        return out

    eng._to_host, eng._spec_round_fn = to_host, rounds
    eng._speculative_rounds_tick, eng._spec_dispatch = tick, dispatch
    ps = _prompts(4, 71)
    assert _run(eng, ps, 30, spec=lambda i: i != 3) == _plain(kind, ps, 30)
    # One fetch a dispatched tick; a tick whose rows' budgets are all in
    # flight dispatches nothing and only resolves.
    assert dispatched[0] >= 3 and fetches[0] == dispatched[0], per_tick
    assert set(per_tick) <= {0, 1}


def test_the_verify_takes_the_multi_token_route_inside_the_decode_loop():
    """With the kernels' route (``attention_backend="cuda"``: the wrappers'
    plain versions on CPU tensors), every verify goes through the ragged
    wrapper at ``k + 1`` query rows a row, once a layer a round, and no
    decode wrapper runs inside a speculative tick."""
    calls = {"ragged": [], "paged": 0, "rounds": 0, "in_spec": False,
             "paged_in_spec": 0}
    real_r, real_p = ra.ragged_paged_attention, pa.paged_attention

    def ragged(q, *a, **k):
        calls["ragged"].append(q.shape[1])
        return real_r(q, *a, **k)

    def paged(*a, **k):
        calls["paged"] += 1
        calls["paged_in_spec"] += calls["in_spec"]
        return real_p(*a, **k)

    eng = _engine(draft=(D, DP), kind="paged",
                  ecfg=dict(ragged_attention=True, use_pallas_attention=True),
                  attention_backend="cuda")
    assert eng.cache.use_ragged and eng.cache.use_kernel
    real_fn = eng._spec_round_fn

    def rounds(*a):
        calls["rounds"] += 1
        calls["in_spec"] = True
        try:
            return real_fn(*a)
        finally:
            calls["in_spec"] = False

    eng._spec_round_fn = rounds
    ps = _prompts(4, 81)
    ra.ragged_paged_attention, pa.paged_attention = ragged, paged
    try:
        # The last row is not speculative and outlives the others: plain
        # K = 16 windows (the decode wrapper) follow the speculative ticks.
        got = _run(eng, ps[:3], 12) + _run(eng, ps[3:], 40, spec=lambda i: 0)
    finally:
        ra.ragged_paged_attention, pa.paged_attention = real_r, real_p
    assert got == _plain("paged", ps[:3], 12) + _plain("paged", ps[3:], 40)
    verify = [s for s in calls["ragged"] if s == K + 1]
    assert calls["rounds"] > 0
    assert len(verify) == T.num_layers * eng.spec_rounds * calls["rounds"]
    assert calls["paged_in_spec"] == 0 and calls["paged"] > 0


def test_a_dense_draft_over_a_latent_target():
    """The JAX engine runs a dense draft over a latent (MLA) target; so does
    the port, with the streams of its plain engine."""
    m = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
             max_position_embeddings=128, family="mla",
             latent=tcfg.LatentConfig(rank=16, rope_head_dim=8))
    lc = tcfg.ModelConfig(**m)
    lp = tllama.init_params(lc, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    e = tcfg.EngineConfig(max_batch_size=3, prefill_buckets=(16,),
                          max_seq_len=64, dtype="float32", speculative_k=K)
    c = tcfg.CacheConfig(page_size=8, num_pages=48, max_pages_per_session=8)
    ps = _prompts(3, 91)
    plain = InferenceEngine(lc, lp, e, c, device="cpu").generate(
        ps, SamplingOptions(max_new_tokens=8))
    for draft in ((D, DP), (T, TP)):
        eng = InferenceEngine(lc, lp, e, c, draft=draft, device="cpu")
        assert _run(eng, ps, 8) == plain
        assert eng.spec_stats["steps"] > 0


# -- the command line -----------------------------------------------------------


def _checkpoint(root, cfg, params):
    """A single-shard HF-layout checkpoint of ``params`` by the port's
    writer."""
    os.makedirs(root, exist_ok=True)
    lp, state = params["layers"], {}
    names = {"attn_norm": ("input_layernorm", False),
             "wq": ("self_attn.q_proj", True),
             "wk": ("self_attn.k_proj", True),
             "wv": ("self_attn.v_proj", True),
             "wo": ("self_attn.o_proj", True),
             "mlp_norm": ("post_attention_layernorm", False),
             "wg": ("mlp.gate_proj", True), "wu": ("mlp.up_proj", True),
             "wd": ("mlp.down_proj", True)}
    for i in range(cfg.num_layers):
        for ours, (hf, transpose) in names.items():
            w = lp[ours][i]
            state[f"model.layers.{i}.{hf}.weight"] = (
                w.T if transpose else w).contiguous()
    state["model.embed_tokens.weight"] = params["embed"]
    state["model.norm.weight"] = params["final_norm"]
    state["lm_head.weight"] = params["lm_head"].T.contiguous()
    save_file(state, os.path.join(root, "model.safetensors"))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({
            "model_type": "llama", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "max_position_embeddings": cfg.max_position_embeddings,
        }, f)
    return str(root)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
    return _checkpoint(d / "target", T, TP), _checkpoint(d / "draft", D, DP)


def test_local_speculative_draft_prints_its_stats(checkpoints, capsys):
    target, draft = checkpoints
    argv = ["local", "--model", target, "--prompt-ids", "5,11,42",
            "--max-new", "9", "--dtype", "float32", "--max-seq-len", "64",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    plain = json.loads(capsys.readouterr().out)
    assert "speculative" not in plain
    assert cli.main(argv + ["--speculative-draft", draft,
                            "--speculative-k", "3"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["tokens"] == plain["tokens"] == _greedy([5, 11, 42], 9)
    st = doc["speculative"]
    assert set(st) == {"proposed", "accepted", "steps", "acceptance_rate"}
    assert st["steps"] > 0 and st["proposed"] == 3 * st["steps"]
    assert st["acceptance_rate"] == round(
        st["accepted"] / st["proposed"], 4)


def test_local_speculative_draft_is_greedy_only(checkpoints):
    target, draft = checkpoints
    with pytest.raises(SystemExit, match="greedy-only"):
        cli.main(["local", "--model", target, "--prompt-ids", "5,11",
                  "--device", "cpu", "--speculative-draft", draft,
                  "--temperature", "0.7"])
