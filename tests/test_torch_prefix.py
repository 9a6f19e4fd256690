"""Port parity, prefix caching (``prefixstore/``, the paged pools' page
operations and the engine's sharing, copy-on-write and spill branches).

The same weights and the same submissions go to the JAX ``InferenceEngine``
and to the port's (``device="cpu"``, float32, pages of 4, attention routed
through the kernel wrappers' plain versions), both with
``CacheConfig(prefix_caching=True)`` and one ``PrefixConfig`` (sharing on,
a 1 MiB spill arena), over the model-dtype pool, the int8 pool and the f32
latent pool. The script (:func:`script`): the JAX tests' sequence (a prompt
over a 24-token system prompt, a second one, the bare system prompt, whose
six full pages all match (the copy-on-write split), the first again), a
second session attaching to a writer's pages while the writer decodes, a
40-token prompt that evicts registered pages into the arena, and the first
prompt again, which reloads them. Token streams and every ``prefix_*``
counter must be IDENTICAL (the reload timings aside).

Then the port alone: sharing on equals sharing off at the default fused
window (K = 16, pipelined, overlapped admission), greedy and sampled; the
spill round trip and a corrupt arena entry; ``read_page`` against the JAX
pool's; the page operations in place; the hash-chain keys against the JAX
allocator's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.cache.paged import (
    PageAllocator as JaxAllocator,
)
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from distributed_llm_inference_tpu.engine.sampling import SamplingOptions as JaxOptions
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache.latent import (
    LatentPagedKVCache, QuantizedLatentPagedKVCache)
from distributed_llm_inference_tpu_torch.cache.paged import (
    PageAllocator, PagedKVCache, QuantizedPagedKVCache)
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.engine.sampling import SamplingOptions
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.prefixstore import (
    HostSpillArena, chain_keys_hex, match_tokens)

torch.set_num_threads(1)
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
LATENT_MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
                    max_position_embeddings=256, family="mla")
LATENT = dict(rank=16, rope_head_dim=8)
PS = 4
SYS = list(range(1, 25))       # 24 tokens: 6 full pages
SYS2 = list(range(100, 124))
LONG = list(range(150, 190))   # 40 distinct tokens: 11 pages
# Pool (pages, the null page included), sized so LONG evicts registered
# pages into the arena.
NUM_PAGES = 20
SPILL = 1 << 20

# pool -> (kv_quant, latent)
POOLS = {"model_dtype": (None, False), "int8": ("int8", False),
         "latent_f32": (None, True)}
_PARAMS = {}
_JAX_RUNS = {}


def _configs(latent):
    if latent:
        return (jcfg.ModelConfig(**LATENT_MODEL,
                                 latent=jcfg.LatentConfig(**LATENT)),
                tcfg.ModelConfig(**LATENT_MODEL,
                                 latent=tcfg.LatentConfig(**LATENT)))
    return jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)


def params(latent):
    if latent not in _PARAMS:
        jc, tc = _configs(latent)
        jp = jllama.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
        _PARAMS[latent] = (jp, tllama.params_from_numpy(
            tc, jax.tree_util.tree_map(np.asarray, jp), torch.float32, "cpu"))
    return _PARAMS[latent]


def _kw(kv_quant, prefix=True, num_pages=NUM_PAGES, **ekw):
    e = dict(max_batch_size=4, prefill_buckets=(8, 16, 32), max_seq_len=64,
             dtype="float32", ragged_attention=True, **ekw)
    c = dict(kind="paged", page_size=PS, num_pages=num_pages,
             max_pages_per_session=16, prefix_caching=prefix,
             kv_quant=kv_quant)
    return e, c


def jax_engine(pool):
    kv_quant, latent = POOLS[pool]
    jc, _ = _configs(latent)
    e, c = _kw(kv_quant, decode_steps=1, pipelined_ticks=False)
    return JaxEngine(jc, params(latent)[0], jcfg.EngineConfig(**e),
                     jcfg.CacheConfig(**c),
                     prefix_cfg=jcfg.PrefixConfig(spill_bytes_max=SPILL))


def port_engine(pool, prefix=True, spill=SPILL, num_pages=NUM_PAGES, **ekw):
    kv_quant, latent = POOLS[pool]
    _, tc = _configs(latent)
    e, c = _kw(kv_quant, prefix=prefix, num_pages=num_pages, **ekw)
    return InferenceEngine(
        tc, params(latent)[1], tcfg.EngineConfig(**e), tcfg.CacheConfig(**c),
        prefix_cfg=tcfg.PrefixConfig(spill_bytes_max=spill), device="cpu",
        attention_backend="cuda")


def script(engine, options_cls, opts=None):
    """Sequential submissions, then a live share, then a spill and a
    reload; returns the streams."""
    o = options_cls(**(opts or dict(max_new_tokens=5, eos_token_id=-1)))
    p1, p2 = SYS + [30, 31], SYS + [40, 41, 42]
    out = [engine.generate([p], o)[0] for p in (p1, p2, SYS, p1)]
    # Register-at-admission: b attaches to a's pages while a decodes.
    live = dict(opts or {}, max_new_tokens=8, eos_token_id=-1)
    a = engine._submit_session(SYS2 + [30, 31], options_cls(**live))
    engine.step()
    b = engine._submit_session(SYS2 + [40, 41, 42], options_cls(**live))
    while engine.has_work():
        engine.step()
    out += [a.generated, b.generated]
    out += [engine.generate([p], o)[0] for p in (LONG, p1)]
    return out


def prefix_counters(engine):
    """Every ``prefix_*`` number of the snapshot but the reload timings
    (their count stays)."""
    return {k: v for k, v in engine.metrics.snapshot().items()
            if k.startswith("prefix_") and not k.endswith("_s")}


def jax_run(pool):
    """The JAX engine's run of :func:`script`, once per pool."""
    if pool not in _JAX_RUNS:
        e = jax_engine(pool)
        streams = script(e, JaxOptions)
        key = e.allocator.chain_keys(SYS, PS)[0]
        page = e.allocator.peek(key)
        _JAX_RUNS[pool] = dict(
            streams=streams, counters=prefix_counters(e), page=page,
            tiles=e.cache.read_page(page),
            prom=e.metrics.prometheus())
    return _JAX_RUNS[pool]


def _type_lines(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith("# TYPE dli_prefix_"))


@pytest.mark.parametrize("pool", list(POOLS))
def test_streams_and_counters_equal_the_jax_engine(pool):
    want = jax_run(pool)
    port = port_engine(pool, decode_steps=1, pipelined_ticks=False)
    assert port.cache.use_ragged and port.cache.use_kernel
    assert script(port, SamplingOptions) == want["streams"]
    got = prefix_counters(port)
    assert got == want["counters"]
    # Not vacuous: every branch ran.
    assert got["prefix_cow_copies"] >= 1
    assert got["prefix_pages_shared"] >= 6
    assert got["prefix_spilled_pages"] >= 1
    assert got["prefix_spill_reloads"] >= 1
    assert got["prefix_reload_ms_count"] == got["prefix_spill_reloads"]
    assert got.get("prefix_reload_errors", 0) == 0
    assert 0 < got["prefix_hit_rate"] < 1
    # /metrics carries the JAX package's names and kinds.
    assert _type_lines(port.metrics.prometheus()) == _type_lines(want["prom"])
    # The pages freed and cached add up to the pool.
    assert port.allocator.free_count == NUM_PAGES - 1


@pytest.mark.parametrize("pool", list(POOLS))
def test_read_page_matches_the_jax_pool(pool):
    want = jax_run(pool)
    port = port_engine(pool, decode_steps=1, pipelined_ticks=False)
    script(port, SamplingOptions)
    page = port.allocator.peek(port.allocator.chain_keys(SYS, PS)[0])
    assert page == want["page"]
    got = port.cache.read_page(page)
    assert sorted(got) == sorted(want["tiles"])
    for name, tile in want["tiles"].items():
        t = got[name]
        assert tuple(t.shape) == tile.shape, name
        assert str(t.dtype).removeprefix("torch.") == tile.dtype.name, name
        assert t.device.type == "cpu"
        if tile.dtype == np.int8:
            # One rounding step at most: the values were quantized from
            # f32 keys computed by two frameworks.
            diff = np.abs(t.numpy().astype(np.int32) - tile.astype(np.int32))
            assert diff.max() <= 1, name
        else:
            np.testing.assert_allclose(t.numpy(), tile, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("opts", [
    dict(max_new_tokens=5, eos_token_id=-1),
    dict(max_new_tokens=5, eos_token_id=-1, temperature=0.8, top_k=20),
], ids=["greedy", "sampled"])
def test_sharing_on_equals_sharing_off(pool, opts):
    """At the engine's defaults (the fused K-step window, pipelined ticks
    and overlapped admission where the pool has the tail): sharing
    changes the prefill work, never a token."""
    on = port_engine(pool)
    off = port_engine(pool, prefix=False, spill=0, num_pages=64)
    if pool != "latent_f32":
        assert on.decode_steps == 16 and on._pipelined
    got = script(on, SamplingOptions, opts)
    assert got == script(off, SamplingOptions, opts)
    snap = on.metrics.snapshot()
    assert snap["prefix_cow_copies"] >= 1 and snap["prefix_spill_reloads"] >= 1
    assert "prefix_cached_tokens" not in off.metrics.snapshot()
    # The prefill counted only what was computed.
    assert (snap["prefill_tokens"] + snap["prefix_cached_tokens"]
            == off.metrics.snapshot()["prefill_tokens"])


def test_spill_round_trip_and_reloaded_tiles_are_bitwise_equal():
    e = port_engine("int8", num_pages=16, decode_steps=1,
                    pipelined_ticks=False)
    o = SamplingOptions(max_new_tokens=4, eos_token_id=-1)
    ra = e.generate([SYS + [30, 31]], o)[0]
    e.generate([LONG], o)
    assert e.metrics.get_counter("prefix_spilled_pages") >= 1
    assert e.metrics.get_gauge("prefix_spill_bytes") == e._spill.bytes_used > 0
    spilled = {k: {n: t.clone() for n, t in e._spill.peek(k).items()}
               for k in e._spill.keys()}
    assert e.generate([SYS + [30, 31]], o)[0] == ra
    assert e.metrics.get_counter("prefix_spill_reloads") >= 1
    # Every reloaded page holds its spilled tiles bit for bit.
    for key, tiles in spilled.items():
        page = e.allocator.peek(key)
        if page is None:
            continue
        back = e.cache.read_page(page)
        assert all(torch.equal(back[n], t) for n, t in tiles.items())


def test_corrupt_arena_entry_degrades_to_recompute():
    e = port_engine("model_dtype", num_pages=16, decode_steps=1,
                    pipelined_ticks=False)
    o = SamplingOptions(max_new_tokens=4, eos_token_id=-1)
    ra = e.generate([SYS + [30, 31]], o)[0]
    e.generate([LONG], o)
    assert len(e._spill) >= 1
    for key in list(e._spill.keys()):
        tiles = e._spill.take(key)
        e._spill.put(key, {n: t[..., :1] for n, t in tiles.items()})
    assert e.generate([SYS + [30, 31]], o)[0] == ra  # recomputed
    assert e.metrics.get_counter("prefix_reload_errors") >= 1
    assert e.metrics.get_counter("prefix_spill_reloads") == 0


def _filled(cls, dtype=torch.float32):
    """A small pool of ``cls`` with random content in every plane."""
    heads, width = (1, 24) if issubclass(cls, LatentPagedKVCache) else (2, 16)
    c = cls.create(2, 2, 6, PS, 3, heads, width, dtype, device="cpu")
    g = torch.Generator().manual_seed(0)
    for f in cls.PLANE_FIELDS.values():
        pool = getattr(c, f)
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=g))
        else:
            pool.copy_(torch.randn(pool.shape, generator=g).to(pool.dtype))
    return c


POOL_CLASSES = [(PagedKVCache, torch.bfloat16), (QuantizedPagedKVCache, None),
                (LatentPagedKVCache, None), (QuantizedLatentPagedKVCache, None)]


@pytest.mark.parametrize("cls,dtype", POOL_CLASSES,
                         ids=[c.__name__ for c, _ in POOL_CLASSES])
def test_page_ops_write_in_place_and_round_trip(cls, dtype):
    c = _filled(cls, dtype or torch.float32)
    ptrs = {f: getattr(c, f).data_ptr() for f in cls.PLANE_FIELDS.values()}
    tiles = c.read_page(2)
    assert set(tiles) == set(cls.PLANE_FIELDS)
    c.write_page(4, tiles)
    assert all(torch.equal(c.read_page(4)[n], t) for n, t in tiles.items())
    c.copy_page(5, 2)
    assert all(torch.equal(c.read_page(5)[n], t) for n, t in tiles.items())
    # In place: no plane was rebound (a captured window keeps its pools).
    assert ptrs == {f: getattr(c, f).data_ptr()
                    for f in cls.PLANE_FIELDS.values()}
    # numpy tiles of the same form install too (bf16 by its bits).
    if dtype is None:
        c.write_page(3, {n: t.numpy() for n, t in tiles.items()})
        assert all(torch.equal(c.read_page(3)[n], t) for n, t in tiles.items())
    before = {n: t.clone() for n, t in c.read_page(1).items()}
    name = next(iter(tiles))
    bad = [
        {**tiles, "extra": tiles[name]},
        {n: t[..., :1] if n == name else t for n, t in tiles.items()},
        {n: t.to(torch.float16) if n == name else t for n, t in tiles.items()},
    ]
    for b in bad:
        with pytest.raises(ValueError):
            c.write_page(1, b)
    assert all(torch.equal(c.read_page(1)[n], t) for n, t in before.items())


def test_chain_keys_match_the_jax_allocator():
    for tokens in ([], [5], list(range(7)), list(range(8)),
                   list(range(100)), [2**31 - 1, -1] * 8):
        want = JaxAllocator.chain_keys(tokens, PS)
        assert PageAllocator.chain_keys(tokens, PS) == want
        assert chain_keys_hex(tokens, PS) == [k.hex() for k in want]
    with pytest.raises(ValueError):
        chain_keys_hex([1, 2], 0)


def test_match_tokens_root_walk():
    keys = chain_keys_hex(list(range(32)), 8)
    assert match_tokens(list(range(32)), 8, keys) == 32
    assert match_tokens(list(range(32)), 8, keys[:2]) == 16
    assert match_tokens(list(range(32)), 8, keys[2:]) == 0
    assert match_tokens(list(range(32)), 8, []) == 0
    assert match_tokens(list(range(5)), 8, keys) == 0


def test_arena_budget_lru_take():
    tile = {"k": torch.ones((2, 4), dtype=torch.float32)}  # 32 bytes
    a = HostSpillArena(max_bytes=70)
    assert a.put(b"a", tile) and a.put(b"b", {"k": np.ones((2, 4), np.float32)})
    assert a.bytes_used == 64
    assert a.put(b"c", tile)  # evicts the oldest ("a")
    assert b"a" not in a and b"b" in a and a.bytes_used == 64
    assert not a.put(b"big", {"k": torch.ones(100)})
    assert not a.put(b"b", tile)
    assert a.peek(b"b") is not None and a.keys() == [b"c", b"b"]
    assert a.take(b"b") is not None and b"b" not in a and a.bytes_used == 32
    assert a.take(b"missing") is None


def test_export_import_and_the_routing_probes():
    o = SamplingOptions(max_new_tokens=4, eos_token_id=-1)
    src = port_engine("int8", decode_steps=1, pipelined_ticks=False)
    want = src.generate([SYS + [30, 31]], o)[0]
    assert src.prefix_match_tokens(SYS + [7]) == 24
    heads = src.advertised_prefix_heads()
    assert match_tokens(SYS, PS, heads) == 24
    ps, items = src.export_prefix_pages(SYS + [30, 31])
    assert ps == PS and len(items) == 6
    dst = port_engine("int8", decode_steps=1, pipelined_ticks=False)
    assert dst.import_prefix_pages(PS, items) == 6
    assert dst.metrics.get_counter("fleet_pages_imported") == 6
    assert dst.import_prefix_pages(PS, items) == 0  # already resident
    assert dst.generate([SYS + [30, 31]], o)[0] == want
    assert dst.metrics.get_counter("prefix_cached_tokens") == 24
    with pytest.raises(ValueError):
        dst.import_prefix_pages(PS + 1, items)


def test_prefix_caching_needs_the_paged_cache():
    with pytest.raises(ValueError, match="paged"):
        InferenceEngine(
            tcfg.ModelConfig(**MODEL), params(False)[1],
            tcfg.EngineConfig(dtype="float32", max_seq_len=64),
            tcfg.CacheConfig(kind="dense", prefix_caching=True),
            device="cpu")


def test_same_tick_sharer_dispatches_after_its_writer():
    """Two prompts over one system prompt submitted together, in different
    buckets: the second attaches at admission to the pages the first has
    yet to prefill, so its prefill must be enqueued after the first's. (The
    JAX engine dispatches a lone bucket's writer after the singles: there
    the sharer reads unwritten pages and its stream differs from the one
    without sharing.)"""
    o = SamplingOptions(max_new_tokens=4, eos_token_id=-1)
    prompts = [SYS + [30, 31], SYS + list(range(40, 60))]
    on = port_engine("model_dtype", decode_steps=1, pipelined_ticks=False)
    off = port_engine("model_dtype", prefix=False, spill=0, num_pages=64,
                      decode_steps=1, pipelined_ticks=False)
    got = on.generate(prompts, o)
    assert on.metrics.get_counter("prefix_cached_tokens") == 24
    assert got == off.generate(prompts, o)


def test_an_engine_with_a_spill_arena_dies_with_its_last_reference():
    """The allocator's eviction hook holds its engine weakly: no reference
    cycle, so an engine (its captured graphs and pools on a card) goes at
    its last ``del``, not whenever the cyclic collector runs."""
    import gc
    import weakref

    gc.disable()
    try:
        e = port_engine("int8", decode_steps=1, pipelined_ticks=False)
        assert e._spill is not None
        e.generate([SYS + [30, 31]], SamplingOptions(max_new_tokens=2))
        ref = weakref.ref(e)
        del e
        assert ref() is None
    finally:
        gc.enable()
