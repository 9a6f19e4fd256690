"""The attention kernels' widths at the wrappers, with a stub library: every
wrapper launches its kernel for 1 to 8 query heads a kv head at head_dim 64
and 128, passes those widths to the C entry, and raises for 9 query heads a
kv head (naming ROADMAP.md queue 1, item 18) and for head_dim 96 and 256;
the four latent wrappers take 1, 8 and 16 query heads over lat_dim 576 and
80 and raise for 17 and 128 heads (item 19) and lat_dim 64, the ragged ones
through the tensor-core entry for bf16 q at lat_dim 576 and the CUDA-core
one for f32 q and lat_dim 80; no call of a tensor on the card ever takes
the plain version. And the engine refuses
such a model, per-head or latent, when it is built on the card.

No card here: the tensors are CPU tensors that report a CUDA device
(``OnCard``), factories asked for that device make CPU tensors of the same
kind (``CardMode``), and ``_build.load_library`` hands out a library whose
every entry records its call and returns 0."""

import contextlib
import types

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.engine import engine as tengine
from distributed_llm_inference_tpu_torch.ops import _build
from distributed_llm_inference_tpu_torch.ops import flash_attention as tfa
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa
from distributed_llm_inference_tpu_torch.ops import quant_attention as tqa
from distributed_llm_inference_tpu_torch.ops import ragged_attention as tra

torch.set_num_threads(1)
CARD = torch.device("cuda", 0)
WIDTHS = [(g, d) for d in (64, 128) for g in range(1, 9)]
REFUSED = [(9, 128, "queue 1, item 18"), (4, 96, "head_dim 96"),
           (4, 256, "head_dim 256")]


class OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""

    @property
    def device(self):
        return CARD


def _on_card(x):
    if isinstance(x, torch.Tensor) and not isinstance(x, OnCard):
        return x.as_subclass(OnCard)
    return x


class CardMode(TorchFunctionMode):
    """Factories asked for the card make CPU tensors; every tensor a torch
    function returns is an ``OnCard``."""

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev).type == "cuda":
            kwargs["device"] = "cpu"
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **kwargs)
        return tree_map(_on_card, out)


class StubLibrary:
    """Every C entry records its name and arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def card(monkeypatch):
    lib = StubLibrary()
    monkeypatch.setattr(_build, "load_library", lambda name: lib)
    for mod, attr in ((tpa, "_fn"), (tra, "_fn"), (tfa, "_fn"),
                      (tqa, "_fns")):
        monkeypatch.setattr(mod, attr, {})
    monkeypatch.setitem(tpa._sm_count, CARD, 132)
    for _, (mod, counter), _ in WRAPPERS.values():
        # The counts made against the stub are undone afterwards: other
        # tests in this process read the counters as real launches.
        monkeypatch.setattr(mod, counter, getattr(mod, counter))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=7))

    def plain(*args, **kwargs):
        raise AssertionError("a tensor on the card took the plain version")

    for mod, counter in LATENT_WRAPPERS.values():
        monkeypatch.setattr(mod, counter, getattr(mod, counter))
    for mod, names in (
            (tpa, ("paged_attention_plain", "quantized_paged_attention_plain",
                   "quantized_paged_fused_attention_plain",
                   "latent_paged_attention_plain",
                   "quantized_latent_paged_attention_plain")),
            (tra, ("ragged_paged_attention_plain",
                   "quantized_ragged_paged_attention_plain",
                   "latent_ragged_paged_attention_plain",
                   "quantized_latent_ragged_paged_attention_plain")),
            (tfa, ("flash_attention_plain",)),
            (tqa, ("quantized_decode_attention_plain",
                   "quantized_fused_decode_attention_plain",
                   "sink_fused_decode_attention_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, plain)
    with CardMode():
        yield lib


def _zeros(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).as_subclass(OnCard)


def _i32(values):
    return torch.tensor(values, dtype=torch.int32).as_subclass(OnCard)


def _int8_planes(lead, n, d):
    return (_zeros((*lead, n, d), torch.int8), _zeros((*lead, n)),
            _zeros((*lead, n, d), torch.int8), _zeros((*lead, n)))


B, HKV, PS, T, KT = 2, 2, 16, 64, 16


def _paged(g, d, dtype, quantized):
    q = _zeros((B, 1, HKV * g, d), dtype)
    table, lens = _i32([[1, 2], [3, 4]]), _i32([20, 5])
    if quantized:
        k, ks, v, vs = _int8_planes((5, HKV), PS, d)
        return tpa.quantized_paged_attention(q, k, ks, v, vs, table, lens)
    pool = _zeros((5, HKV, PS, d), dtype)
    return tpa.paged_attention(q, pool, pool, table, lens)


def _ragged(g, d, dtype, quantized):
    q = _zeros((B, 8, HKV * g, d), dtype)
    table, lens, new = _i32([[1, 2], [3, 4]]), _i32([20, 5]), _i32([8, 1])
    if quantized:
        k, ks, v, vs = _int8_planes((5, HKV), PS, d)
        return tra.quantized_ragged_paged_attention(q, k, ks, v, vs, table,
                                                    lens, new)
    pool = _zeros((5, HKV, PS, d), dtype)
    return tra.ragged_paged_attention(q, pool, pool, table, lens, new)


def _flash(g, d, dtype, quantized):
    q = _zeros((B, 16, HKV * g, d), dtype)
    kv = _zeros((B, 32, HKV, d), dtype)
    mask = torch.ones((B, 16, 32), dtype=torch.bool).as_subclass(OnCard)
    return tfa.flash_attention(q, kv, kv, mask)


def _dense_decode(g, d, dtype, quantized):
    k, ks, v, vs = _int8_planes((B, HKV), T, d)
    return tqa.quantized_decode_attention(
        _zeros((B, 1, HKV * g, d), dtype), k, ks, v, vs, _i32([T, 3]))


def _fused(g, d, dtype, paged):
    q = _zeros((B, 1, HKV * g, d), dtype)
    kn = _zeros((B, 1, HKV, d), dtype)
    tail = _int8_planes((2, B, HKV), KT, d)
    vec = _i32([5, 3])
    if paged:
        return tpa.quantized_paged_fused_attention(
            q, kn, kn, *_int8_planes((2, 5, HKV), PS, d), *tail, 1,
            _i32([0]), _i32([[1, 2], [3, 4]]), vec, vec, vec)
    return tqa.quantized_fused_decode_attention(
        q, kn, kn, *_int8_planes((2, B, HKV), T, d), *tail, 1, _i32([0]),
        vec, vec, vec)


def _sink(g, d, dtype, quantized):
    q = _zeros((B, 1, HKV * g, d), dtype)
    kn = _zeros((B, 1, HKV, d), dtype)
    vec = _i32([5, 3])
    return tqa.sink_fused_decode_attention(
        q, q.clone(), kn, kn, *_int8_planes((2, B, HKV), T, d),
        *_int8_planes((2, B, HKV), 4, d), *_int8_planes((2, B, HKV), KT, d),
        1, _i32([0]), vec, vec, vec, vec, vec, 60)


# wrapper -> (call, launch counter, the C entries it may take)
WRAPPERS = {
    "paged_attention": (lambda g, d, t: _paged(g, d, t, False),
                        (tpa, "launches"),
                        ("dli_paged_attention_bf16", "dli_paged_attention")),
    "quantized_paged_attention": (
        lambda g, d, t: _paged(g, d, t, True), (tpa, "quantized_launches"),
        ("dli_quantized_paged_attention_bf16",
         "dli_quantized_paged_attention")),
    "ragged_paged_attention": (
        lambda g, d, t: _ragged(g, d, t, False), (tra, "launches"),
        ("dli_ragged_paged_attention",)),
    "quantized_ragged_paged_attention": (
        lambda g, d, t: _ragged(g, d, t, True), (tra, "quantized_launches"),
        ("dli_quantized_ragged_paged_attention",)),
    "flash_attention": (lambda g, d, t: _flash(g, d, t, False),
                        (tfa, "launches"), ("dli_flash_attention",)),
    "quantized_decode_attention": (
        lambda g, d, t: _dense_decode(g, d, t, True),
        (tqa, "decode_launches"),
        ("dli_quantized_decode_attention_bf16",
         "dli_quantized_decode_attention")),
    "quantized_paged_fused_attention": (
        lambda g, d, t: _fused(g, d, t, True), (tpa, "fused_launches"),
        ("dli_quantized_paged_fused_attention",)),
    "quantized_fused_decode_attention": (
        lambda g, d, t: _fused(g, d, t, False), (tqa, "fused_launches"),
        ("dli_quantized_fused_decode_attention",)),
    "sink_fused_decode_attention": (
        lambda g, d, t: _sink(g, d, t, False), (tqa, "sink_launches"),
        ("dli_sink_fused_decode_attention",)),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("g,d", WIDTHS, ids=[f"g{g}_d{d}" for g, d in WIDTHS])
@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_every_wrapper_launches_at_every_width(card, wrapper, g, d, dtype):
    """One call of the wrapper: one C call, with G and D among its
    arguments (in that order, G right before D), one launch counted."""
    call, (mod, counter), entries = WRAPPERS[wrapper]
    before = getattr(mod, counter)
    out = call(g, d, dtype)
    out = out[0] if isinstance(out, tuple) else out
    assert out.dtype == dtype and out.shape[-1] == d
    assert len(card.calls) == 1, card.calls
    name, args = card.calls[0]
    assert name in entries, name
    ints = [a for a in args if type(a) is int]
    assert any(ints[i:i + 2] == [g, d] for i in range(len(ints))), ints
    assert getattr(mod, counter) == before + 1


@pytest.mark.parametrize("g,d,match", REFUSED,
                         ids=[f"g{g}_d{d}" for g, d, _ in REFUSED])
@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_every_wrapper_refuses_other_widths(card, wrapper, g, d, match):
    """9 query heads a kv head and head_dim 96 or 256: ValueError naming
    the reason, no C call, no launch counted, no plain version."""
    call, (mod, counter), _ = WRAPPERS[wrapper]
    before = getattr(mod, counter)
    with pytest.raises(ValueError, match=match):
        call(g, d, torch.bfloat16)
    assert card.calls == [] and getattr(mod, counter) == before


def test_int8_pages_of_head_dim_64_need_an_even_page_size(card):
    """int8 rows of 64 bytes: boxes of an odd number of rows would land
    off the TMA's 128-byte alignment, so the bf16 kernels refuse them."""
    q = _zeros((B, 1, HKV * 4, 64), torch.bfloat16)
    k, ks, v, vs = _int8_planes((5, HKV), 15, 64)
    with pytest.raises(ValueError, match="even page size"):
        tpa.quantized_paged_attention(q, k, ks, v, vs, _i32([[1, 2], [3, 4]]),
                                      _i32([20, 5]))
    assert card.calls == []


# A model of 9 query heads over 1 kv head, and one of head_dim 96.
MODEL = dict(vocab_size=64, hidden_size=36, intermediate_size=48,
             num_layers=1, num_heads=9, num_kv_heads=1, head_dim=16)


@pytest.mark.parametrize("widths,dtype,cache,match", [
    (dict(), "float32", None, r"ROADMAP\.md queue 1, item 18"),
    (dict(num_heads=2, num_kv_heads=1, head_dim=96, hidden_size=192),
     "float32", None, "head_dim 96"),
    (dict(num_heads=4, num_kv_heads=1, head_dim=64, hidden_size=256),
     "bfloat16", dict(kv_quant="int8", page_size=15), "even page size"),
], ids=["g9", "d96", "d64_int8_pages_of_15"])
def test_engine_refuses_widths_no_kernel_takes_on_the_card(
        monkeypatch, widths, dtype, cache, match):
    """Built on the card, the engine raises at construction (not at the
    first kernel call) for widths no attention kernel takes, and for bf16
    over int8 pages of head_dim 64 with an odd page size."""
    monkeypatch.setattr(tengine, "resolve_device", lambda device: CARD)
    cfg = tcfg.ModelConfig(**{**MODEL, **widths})
    with pytest.raises(NotImplementedError, match=match):
        tengine.InferenceEngine(
            cfg, {}, tcfg.EngineConfig(dtype=dtype),
            None if cache is None else tcfg.CacheConfig(**cache))


def test_engine_takes_every_width_on_the_cpu():
    """Off the card the plain path takes any width: 9 query heads over one
    kv head serve a token."""
    from distributed_llm_inference_tpu_torch.models import llama

    from distributed_llm_inference_tpu_torch.engine.sampling import (
        SamplingOptions)

    cfg = tcfg.ModelConfig(**MODEL)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               dtype=torch.float32, device="cpu")
    engine = tengine.InferenceEngine(
        cfg, params, tcfg.EngineConfig(dtype="float32", max_batch_size=1,
                                       max_seq_len=32),
        device="cpu")
    out = engine.generate([[1, 2, 3]], SamplingOptions(max_new_tokens=2))
    assert len(out[0]) == 2


# The latent (MLA) wrappers: one kv head, G = every query head, D = lat_dim.
LATENT_WRAPPERS = {
    "latent_ragged_paged_attention": (tra, "latent_launches"),
    "quantized_latent_ragged_paged_attention": (
        tra, "quantized_latent_launches"),
    "latent_paged_attention": (tpa, "latent_launches"),
    "quantized_latent_paged_attention": (tpa, "quantized_latent_launches"),
}


def _latent(name, g, d, window=None, dtype=torch.bfloat16):
    """One call of the latent wrapper ``name``: 2 rows over pages of 16,
    bf16 queries unless ``dtype`` says otherwise (3 a row on the ragged
    ones)."""
    q8 = name.startswith("quantized")
    ragged = "ragged" in name
    q = _zeros((B, 3 if ragged else 1, g, d), dtype)
    pools = ((_zeros((9, 1, PS, d), torch.int8), _zeros((9, 1, PS)))
             if q8 else (_zeros((9, 1, PS, d)),))
    table, lens = _i32([[1, 2, 3, 4], [5, 6, 7, 8]]), _i32([40, 3])
    fn = getattr(LATENT_WRAPPERS[name][0], name)
    if ragged:
        return fn(q, *pools, table, lens, _i32([3, 1]), sliding_window=window)
    return fn(q, *pools, table, lens, sliding_window=window,
              return_stats=True)


LATENT_WIDTHS = [(16, 576), (1, 576), (8, 80)]


@pytest.mark.parametrize("g,d", LATENT_WIDTHS,
                         ids=[f"g{g}_d{d}" for g, d in LATENT_WIDTHS])
@pytest.mark.parametrize("name", list(LATENT_WRAPPERS))
def test_latent_wrappers_launch_on_the_card(card, name, g, d):
    """One C call of ``csrc/latent_attention.cu`` with the widths, the
    window and the scale plane (null over the f32 pool), one launch
    counted; decode rows of 64 table positions take one split each. The
    ragged wrappers take the tensor-core entry for bf16 q at lat_dim 576,
    the CUDA-core one at lat_dim 80."""
    mod, counter = LATENT_WRAPPERS[name]
    before = getattr(mod, counter)
    out = _latent(name, g, d, window=300)
    out = out[0] if isinstance(out, tuple) else out
    assert out.dtype == torch.bfloat16 and out.shape[-2:] == (g, d)
    assert getattr(mod, counter) == before + 1
    (symbol, args), = card.calls
    if "ragged" in name:
        assert symbol == ("dli_latent_ragged_wgmma" if d == 576
                          else "dli_latent_ragged_attention")
        assert args[8:14] == (B, 3, g, d, PS, 4)  # B S G D PS Tw
    else:
        assert symbol == "dli_latent_paged_attention"
        assert args[12:19] == (B, g, d, PS, 4, 1, 64)  # ... splits chunk
    assert args[-3:-1] == (300, 0)  # the window, bf16
    assert (args[2] is None) == (not name.startswith("quantized"))


# (query dtype, lat_dim) -> the ragged C entry: the tensor-core instance
# takes bf16 at 576 only; f32 q (the exact-stream checks) and lat_dim 80
# keep the CUDA-core kernel.
LATENT_ROUTES = [
    (torch.bfloat16, 576, "dli_latent_ragged_wgmma"),
    (torch.float32, 576, "dli_latent_ragged_attention"),
    (torch.bfloat16, 80, "dli_latent_ragged_attention"),
    (torch.float32, 80, "dli_latent_ragged_attention"),
]


@pytest.mark.parametrize("dtype,d,symbol", LATENT_ROUTES,
                         ids=[f"{str(t)[6:]}_d{d}" for t, d, _ in
                              LATENT_ROUTES])
@pytest.mark.parametrize("g", [1, 16])
@pytest.mark.parametrize("name", ["latent_ragged_paged_attention",
                                  "quantized_latent_ragged_paged_attention"])
def test_latent_ragged_routes_by_query_dtype_and_lat_dim(card, name, g,
                                                        dtype, d, symbol):
    """The ragged latent wrappers pick their C entry from (q's dtype,
    lat_dim) alone, over either pool: one call, the dtype code passed, q's
    dtype out, one launch counted, no plain version."""
    mod, counter = LATENT_WRAPPERS[name]
    before = getattr(mod, counter)
    out = _latent(name, g, d, dtype=dtype)
    assert out.dtype == dtype and out.shape == (B, 3, g, d)
    assert getattr(mod, counter) == before + 1
    (got, args), = card.calls
    assert got == symbol == tra.latent_ragged_entry(dtype, d)
    assert args[-2] == (0 if dtype == torch.bfloat16 else 1)
    assert (args[2] is None) == (not name.startswith("quantized"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,d", [(17, 576), (16, 64)])
def test_latent_ragged_refuses_widths_neither_instance_takes(card, g, d,
                                                             dtype):
    """Neither the tensor-core instance nor the CUDA-core kernel takes 17
    heads or lat_dim 64: the wrapper raises before any C call."""
    with pytest.raises(ValueError, match="item 19|lat_dim 576"):
        _latent("latent_ragged_paged_attention", g, d, dtype=dtype)
    assert card.calls == []


LATENT_REFUSED = [(17, 576, r"ROADMAP\.md queue 1, item 19"),
                  (128, 576, r"ROADMAP\.md queue 1, item 19"),
                  (16, 64, "lat_dim 576 and lat_dim 80")]


@pytest.mark.parametrize("g,d,match", LATENT_REFUSED,
                         ids=[f"g{g}_d{d}" for g, d, _ in LATENT_REFUSED])
@pytest.mark.parametrize("name", list(LATENT_WRAPPERS))
def test_latent_wrappers_refuse_other_widths(card, name, g, d, match):
    mod, counter = LATENT_WRAPPERS[name]
    before = getattr(mod, counter)
    with pytest.raises(ValueError, match=match):
        _latent(name, g, d)
    assert card.calls == [] and getattr(mod, counter) == before


@pytest.mark.parametrize("heads,rank", [(128, 512), (16, 448)],
                         ids=["g128_deepseek_v2", "lat_dim_512"])
def test_engine_refuses_latent_widths_no_kernel_takes_on_the_card(
        monkeypatch, heads, rank):
    monkeypatch.setattr(tengine, "resolve_device", lambda device: CARD)
    cfg = tcfg.ModelConfig(
        vocab_size=64, hidden_size=64, intermediate_size=64, num_layers=1,
        num_heads=heads, num_kv_heads=1, head_dim=16, family="mla",
        latent=tcfg.LatentConfig(rank=rank, rope_head_dim=64))
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md queue 1, item 19"):
        tengine.InferenceEngine(cfg, {}, tcfg.EngineConfig(dtype="float32"))
