"""Port parity, checkpoint loading: tiny HF-format checkpoints written by
the JAX package's ``save_safetensors`` are loaded by both packages, and the
port's parameters must EQUAL (float32) ``params_from_numpy`` of the JAX
loader's. Case for case the ``tests/test_checkpoint.py`` suite (sharded
load, shard selection, block slices, the ``.bin`` route, ``load_config``,
a missing index, the weights cache, an unsupported family), plus the port's
own safetensors reader and writer against the ``safetensors`` wheel."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as wheel_save_file

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu.models import registry as jregistry
from distributed_llm_inference_tpu.utils import checkpoint as jcheckpoint
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache.dense import DenseKVCache
from distributed_llm_inference_tpu_torch.models import llama
from distributed_llm_inference_tpu_torch.models import registry
from distributed_llm_inference_tpu_torch.utils import checkpoint, streader

torch.set_num_threads(1)
MODEL = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
             num_layers=4, num_heads=4, num_kv_heads=2, head_dim=4,
             max_position_embeddings=64)
CFG = tcfg.ModelConfig(**MODEL)
JCFG = jcfg.ModelConfig(**MODEL)
SHARD1 = "model-00001-of-00002.safetensors"
SHARD2 = "model-00002-of-00002.safetensors"


def _hf_state(seed: int = 0):
    """Random HF-keyed state dict in torch's [out, in] linear layout."""
    r = np.random.RandomState(seed)
    h, d, inter = CFG.hidden_size, CFG.head_dim, CFG.intermediate_size
    state = {
        "model.embed_tokens.weight": r.randn(CFG.vocab_size, h),
        "model.norm.weight": r.randn(h),
        "lm_head.weight": r.randn(CFG.vocab_size, h),
    }
    for i in range(CFG.num_layers):
        p = f"model.layers.{i}."
        state.update({
            p + "input_layernorm.weight": r.randn(h),
            p + "self_attn.q_proj.weight": r.randn(CFG.num_heads * d, h),
            p + "self_attn.k_proj.weight": r.randn(CFG.num_kv_heads * d, h),
            p + "self_attn.v_proj.weight": r.randn(CFG.num_kv_heads * d, h),
            p + "self_attn.o_proj.weight": r.randn(h, CFG.num_heads * d),
            p + "post_attention_layernorm.weight": r.randn(h),
            p + "mlp.gate_proj.weight": r.randn(inter, h),
            p + "mlp.up_proj.weight": r.randn(inter, h),
            p + "mlp.down_proj.weight": r.randn(h, inter),
        })
    return {k: v.astype(np.float32) for k, v in state.items()}


def _shard_of(key):
    if any(key.startswith(f"model.layers.{i}.") for i in (2, 3)):
        return SHARD2
    return SHARD2 if key in ("model.norm.weight", "lm_head.weight") else SHARD1


def _write_sharded(model_dir, state):
    """Two shards: layers 0-1 + embed in shard 1; layers 2-3 + norm/head in
    2; written by the JAX package's writer."""
    shards, weight_map = {}, {}
    for k, v in state.items():
        shards.setdefault(_shard_of(k), {})[k] = v
        weight_map[k] = _shard_of(k)
    for name, tensors in shards.items():
        jcheckpoint.save_safetensors(tensors, os.path.join(model_dir, name))
    with open(os.path.join(model_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": weight_map}, f)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({
            "model_type": "llama", "vocab_size": CFG.vocab_size,
            "hidden_size": CFG.hidden_size,
            "intermediate_size": CFG.intermediate_size,
            "num_hidden_layers": CFG.num_layers,
            "num_attention_heads": CFG.num_heads,
            "num_key_value_heads": CFG.num_kv_heads,
            "head_dim": CFG.head_dim, "rms_norm_eps": 1e-5,
        }, f)


@pytest.fixture
def model_dir(tmp_path):
    d = tmp_path / "model"
    d.mkdir()
    _write_sharded(str(d), _hf_state())
    return str(d)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_params_equal(got, want):
    """``got`` (the port's) equals ``want`` (the port's from the JAX
    loader's tree) key for key, bit for bit."""
    assert set(got) == set(want)
    assert set(got["layers"]) == set(want["layers"])
    for name in want["layers"]:
        assert got["layers"][name].dtype == want["layers"][name].dtype
        assert torch.equal(got["layers"][name], want["layers"][name]), name
    for name in set(want) - {"layers"}:
        assert torch.equal(got[name], want[name]), name


def _from_jax(tree):
    """The JAX loader's parameters as the port's (float32, CPU): a full
    model through ``params_from_numpy``, a block's layers as they are."""
    tree = _numpy_tree(tree)
    if "embed" in tree:
        return llama.params_from_numpy(CFG, tree, torch.float32, "cpu")
    return {"layers": {k: torch.from_numpy(np.array(v))
                       for k, v in tree["layers"].items()}}


def test_load_model_params_equals_the_jax_loader(model_dir):
    got = checkpoint.load_model_params(model_dir, CFG, torch.float32,
                                       device="cpu")
    want = _from_jax(
        jcheckpoint.load_model_params(model_dir, JCFG, jnp.float32))
    _assert_params_equal(got, want)
    assert got["layers"]["wq"].shape == (4, 16, 16)
    assert got["lm_head"].shape == (16, 64)


def test_block_load_opens_only_needed_shards(model_dir):
    opened = []
    base = checkpoint._default_resolve(model_dir)

    def resolve(name):
        opened.append(name)
        return base(name)

    params = checkpoint.load_block_params(
        model_dir, CFG, [2, 3], torch.float32, resolve=resolve, device="cpu")
    shards = [n for n in opened if n.endswith(".safetensors")]
    assert shards == [SHARD2], "a block of layers [2,3] must not read shard 1"
    want = _from_jax(jcheckpoint.load_block_params(
        model_dir, JCFG, [2, 3], jnp.float32))
    _assert_params_equal(params, want)
    assert params["layers"]["wq"].shape[0] == 2


def test_block_load_forward_matches_full_model_slice(model_dir):
    """Layers [1,2] loaded as a block through block_apply match the same
    layers sliced out of a full-model load."""
    full = checkpoint.load_model_params(model_dir, CFG, torch.float32,
                                        device="cpu")
    block = checkpoint.load_block_params(model_dir, CFG, [1, 2],
                                         torch.float32, device="cpu")
    x = torch.from_numpy(
        np.random.RandomState(1).randn(1, 5, CFG.hidden_size).astype(np.float32))
    num_new = torch.full((1,), 5, dtype=torch.int32)

    def run(layer_params):
        cache = DenseKVCache.create(2, 1, 8, CFG.num_kv_heads, CFG.head_dim,
                                    torch.float32, device="cpu")
        out, _ = llama.block_apply(CFG, layer_params, x, cache, num_new)
        return out

    sliced = {k: v[1:3] for k, v in full["layers"].items()}
    torch.testing.assert_close(run(block["layers"]), run(sliced),
                               rtol=1e-6, atol=0)


def test_torch_bin_route(tmp_path):
    state = _hf_state()
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               os.path.join(tmp_path, "pytorch_model.bin"))
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump({"model_type": "llama"}, f)
    got = checkpoint.load_model_params(str(tmp_path), CFG, torch.float32,
                                       device="cpu")
    want = _from_jax(
        jcheckpoint.load_model_params(str(tmp_path), JCFG, jnp.float32))
    _assert_params_equal(got, want)


def test_load_config(model_dir):
    cfg = checkpoint.load_config(model_dir)
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_kv_heads) == (16, 4, 2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jcheckpoint.load_config(model_dir))


def test_missing_index_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoint.block_state_dict(str(tmp_path), [0])


def test_block_state_dict_matches_the_jax_one(model_dir):
    got = checkpoint.block_state_dict(model_dir, [1], include_non_layer=True)
    want = jcheckpoint.block_state_dict(model_dir, [1], include_non_layer=True)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


# ---------------------------------------------------------------------------
# Pre-converted on-disk weight cache
# ---------------------------------------------------------------------------


def _entries(cache_dir):
    return sorted(f for f in os.listdir(cache_dir) if f.endswith(".safetensors"))


def test_weights_cache_roundtrip_and_hit(model_dir, tmp_path, monkeypatch):
    cache_dir = str(tmp_path / "wcache")
    ref = checkpoint.load_model_params(model_dir, CFG, torch.float32,
                                       device="cpu")
    out = checkpoint.load_model_params(model_dir, CFG, torch.float32,
                                       cache_dir=cache_dir, device="cpu")
    assert len(_entries(cache_dir)) == 1

    def boom(*a, **k):
        raise AssertionError("cache miss: the checkpoint was read")

    monkeypatch.setattr(checkpoint, "_state_views", boom)
    cached = checkpoint.load_model_params(model_dir, CFG, torch.float32,
                                          cache_dir=cache_dir, device="cpu")
    for tree in (out, cached):
        _assert_params_equal(tree, ref)


def test_weights_cache_block_key_varies_by_span_and_dtype(model_dir, tmp_path):
    cache_dir = str(tmp_path / "wcache")
    for ids, dtype in (([0, 1], torch.float32), ([2, 3], torch.float32),
                       ([0, 1], torch.bfloat16)):
        checkpoint.load_block_params(model_dir, CFG, ids, dtype,
                                     cache_dir=cache_dir, device="cpu")
    assert len(_entries(cache_dir)) == 3  # distinct keys, no collisions
    bf16 = checkpoint.load_block_params(model_dir, CFG, [0, 1], torch.bfloat16,
                                        cache_dir=cache_dir, device="cpu")
    assert bf16["layers"]["wq"].dtype == torch.bfloat16


def test_weights_cache_invalidated_by_checkpoint_change(model_dir, tmp_path):
    cache_dir = str(tmp_path / "wcache")
    a = checkpoint.load_block_params(model_dir, CFG, [0], torch.float32,
                                     cache_dir=cache_dir, device="cpu")
    _write_sharded(model_dir, _hf_state(seed=9))
    os.utime(checkpoint.find_index(checkpoint._default_resolve(model_dir)))
    b = checkpoint.load_block_params(model_dir, CFG, [0], torch.float32,
                                     cache_dir=cache_dir, device="cpu")
    assert not torch.equal(a["layers"]["wq"], b["layers"]["wq"])


def test_weights_cache_corrupt_entry_rebuilds(model_dir, tmp_path):
    cache_dir = tmp_path / "wcache"
    ref = checkpoint.load_block_params(model_dir, CFG, [0], torch.float32,
                                       cache_dir=str(cache_dir), device="cpu")
    entry = next(cache_dir.glob("*.safetensors"))
    entry.write_bytes(b"garbage")
    again = checkpoint.load_block_params(model_dir, CFG, [0], torch.float32,
                                         cache_dir=str(cache_dir), device="cpu")
    assert torch.equal(ref["layers"]["wq"], again["layers"]["wq"])


def test_weights_cache_invalidated_by_shard_change_only(model_dir, tmp_path):
    """Replacing a shard while the index file stays byte-identical must
    still invalidate the cache (the key covers shard identities too)."""
    cache_dir = str(tmp_path / "wcache")
    a = checkpoint.load_block_params(model_dir, CFG, [0], torch.float32,
                                     cache_dir=cache_dir, device="cpu")
    shard1 = {k: torch.from_numpy(v) for k, v in _hf_state(seed=9).items()
              if _shard_of(k) == SHARD1}
    checkpoint.save_safetensors(shard1, os.path.join(model_dir, SHARD1))
    b = checkpoint.load_block_params(model_dir, CFG, [0], torch.float32,
                                     cache_dir=cache_dir, device="cpu")
    assert not torch.equal(a["layers"]["wq"], b["layers"]["wq"])


def test_weights_cache_entries_stay_apart_from_the_jax_ones(model_dir, tmp_path):
    """One cache directory shared by both packages: each writes and reads
    only its own entries."""
    cache_dir = str(tmp_path / "wcache")
    jcheckpoint.load_block_params(model_dir, JCFG, [0], jnp.float32,
                                  cache_dir=cache_dir)
    jax_entries = _entries(cache_dir)
    got = checkpoint.load_block_params(model_dir, CFG, [0], torch.float32,
                                       cache_dir=cache_dir, device="cpu")
    ours = sorted(set(_entries(cache_dir)) - set(jax_entries))
    assert len(jax_entries) == 1 and len(ours) == 1
    assert ours[0].startswith("torch-block-")
    again = checkpoint.load_block_params(model_dir, CFG, [0], torch.float32,
                                         cache_dir=cache_dir, device="cpu")
    assert torch.equal(got["layers"]["wq"], again["layers"]["wq"])
    jcheckpoint.load_block_params(model_dir, JCFG, [0], jnp.float32,
                                  cache_dir=cache_dir)
    assert len(_entries(cache_dir)) == 2


def test_load_config_rejects_unsupported_family(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": 64, "hidden_size": 16,
                   "num_hidden_layers": 2, "num_attention_heads": 2}, f)
    with pytest.raises(KeyError):
        checkpoint.load_config(str(tmp_path))
    cfg = checkpoint.load_config(str(tmp_path), validate=False)
    assert cfg.family == "gpt2"


# ---------------------------------------------------------------------------
# What the port refuses, and its default device
# ---------------------------------------------------------------------------


def test_load_without_a_device_raises_on_a_host_without_a_gpu(model_dir):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    for call in (
        lambda: checkpoint.load_model_params(model_dir, CFG, torch.float32),
        lambda: checkpoint.load_block_params(model_dir, CFG, [0]),
        lambda: checkpoint.load_client_params(model_dir, CFG),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


MLA_MODEL = dict(MODEL, num_kv_heads=4, family="mla")
MLA_LATENT = dict(rank=8, rope_head_dim=4, nope_head_dim=6)


def _mla_state(seed=2):
    """A tiny DeepSeek-V2's HF state: the Llama layers with q_proj [Hq *
    (dn + dr), H], kv_a_proj_with_mqa [rank + dr, H], kv_a_layernorm
    [rank] and kv_b_proj [Hq * (dn + D), rank] in place of k/v_proj."""
    r = np.random.RandomState(seed)
    h, d, hq = CFG.hidden_size, CFG.head_dim, CFG.num_heads
    rank, dr, dn = (MLA_LATENT[k] for k in
                    ("rank", "rope_head_dim", "nope_head_dim"))
    state = {k: v for k, v in _hf_state(seed).items()
             if ".k_proj." not in k and ".v_proj." not in k}
    for i in range(CFG.num_layers):
        p = f"model.layers.{i}.self_attn."
        state[p + "q_proj.weight"] = r.randn(hq * (dn + dr), h)
        state[p + "kv_a_proj_with_mqa.weight"] = r.randn(rank + dr, h)
        state[p + "kv_a_layernorm.weight"] = r.randn(rank)
        state[p + "kv_b_proj.weight"] = r.randn(hq * (dn + d), rank)
    return {k: v.astype(np.float32) for k, v in state.items()}


@pytest.mark.parametrize("key,names", [
    ("model.layers.0.self_attn.kv_b_proj.weight", ("wk_b", "wv_b")),
    ("model.layers.0.self_attn.kv_a_proj_with_mqa.weight", ("wkv_a",)),
])
def test_waiting_families_raise_with_their_queue_item(key, names):
    """The latent (MLA) keys, which waited for ROADMAP.md queue 1, item 10,
    now load: a DeepSeek-V2 state converts EQUAL to the JAX conversion,
    the weights made from ``key`` included, and a per-head config ignores
    them as the JAX conversion does."""
    np_state = _mla_state()
    state = {k: torch.from_numpy(v) for k, v in np_state.items()}
    cfg = tcfg.ModelConfig(**MLA_MODEL, latent=tcfg.LatentConfig(**MLA_LATENT))
    jc = jcfg.ModelConfig(**MLA_MODEL,
                          latent=jcfg.LatentConfig(**MLA_LATENT))
    got = llama.convert_hf_state_dict(cfg, state, None, torch.float32, "cpu")
    want = jllama.convert_hf_state_dict(jc, np_state, None, jnp.float32)
    assert set(got["layers"]) == set(want["layers"]) >= set(names)
    for name in got["layers"]:
        np.testing.assert_array_equal(got["layers"][name].numpy(),
                                      np.asarray(want["layers"][name]))
    llama_state = dict(_hf_state(), **{key: np_state[key]})
    per_head = llama.convert_hf_state_dict(
        CFG, {k: torch.from_numpy(v) for k, v in llama_state.items()}, None,
        torch.float32, "cpu")
    jper = jllama.convert_hf_state_dict(JCFG, llama_state, None, jnp.float32)
    assert set(per_head["layers"]) == set(jper["layers"])
    assert not set(per_head["layers"]) & set(names)


MOE_CFG = dataclasses.replace(CFG, num_experts=3, num_experts_per_tok=2,
                              family="mixtral")


def _moe_state(seed=1):
    """A tiny Mixtral's HF state: the Llama layers' attention, each MLP
    replaced by ``block_sparse_moe``'s router (``gate``, [E, H]) and three
    experts' ``w1``/``w3`` ([F, H]) and ``w2`` ([H, F])."""
    r = np.random.RandomState(seed)
    h, inter = CFG.hidden_size, CFG.intermediate_size
    state = {k: v for k, v in _hf_state(seed).items() if ".mlp." not in k}
    for i in range(CFG.num_layers):
        p = f"model.layers.{i}.block_sparse_moe."
        state[p + "gate.weight"] = r.randn(3, h)
        for e in range(3):
            state[p + f"experts.{e}.w1.weight"] = r.randn(inter, h)
            state[p + f"experts.{e}.w3.weight"] = r.randn(inter, h)
            state[p + f"experts.{e}.w2.weight"] = r.randn(h, inter)
    return {k: v.astype(np.float32) for k, v in state.items()}


@pytest.mark.parametrize("key", [
    "model.layers.0.block_sparse_moe.gate.weight",
    "model.layers.0.self_attn.o_proj.bias",
])
def test_moe_and_o_proj_bias_load_as_the_jax_conversion(key, tmp_path):
    """The keys that waited: a tiny Mixtral checkpoint (``block_sparse_moe``
    keys, two shards) and a Llama with an o_proj bias, each loaded by both
    packages: the port's parameters EQUAL the JAX loader's, experts
    stacked ``[L, E, in, out]``."""
    moe = "block_sparse_moe" in key
    cfg, jc = (MOE_CFG, dataclasses.replace(JCFG, num_experts=3,
                                            family="mixtral")) if moe else (
        CFG, JCFG)
    state = _moe_state() if moe else _hf_state()
    if not moe:
        r = np.random.RandomState(5)
        for i in range(CFG.num_layers):
            state[f"model.layers.{i}.self_attn.o_proj.bias"] = r.randn(
                CFG.hidden_size).astype(np.float32)
    d = tmp_path / "model"
    d.mkdir()
    _write_sharded(str(d), state)
    got = checkpoint.load_model_params(str(d), cfg, torch.float32,
                                       device="cpu")
    want = llama.params_from_numpy(cfg, _numpy_tree(
        jcheckpoint.load_model_params(str(d), jc, jnp.float32)),
        torch.float32, "cpu")
    _assert_params_equal(got, want)
    if moe:
        assert got["layers"]["we_g"].shape == (4, 3, 16, 32)
        assert got["layers"]["we_d"].shape == (4, 3, 32, 16)
        assert got["layers"]["router"].shape == (4, 16, 3)
        assert torch.equal(
            got["layers"]["we_d"][2, 1],
            torch.from_numpy(state["model.layers.2.block_sparse_moe."
                                   "experts.1.w2.weight"]).T)
        block = checkpoint.load_block_params(str(d), cfg, [1, 3],
                                             torch.float32, device="cpu")
        for name, w in block["layers"].items():
            assert torch.equal(w, got["layers"][name][[1, 3]]), name
        with pytest.raises(ValueError, match="num_experts"):
            llama.convert_hf_state_dict(
                CFG, {k: torch.from_numpy(v) for k, v in state.items()},
                None, torch.float32, "cpu")
    else:
        assert got["layers"]["bo"].shape == (4, 16)


def test_http_models_and_sharded_placement_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="HTTP"):
        checkpoint.load_config("https://example.invalid/llama")
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        checkpoint.shard_put({}, None)


@pytest.mark.parametrize("model_type", [
    "llama", "mistral", "qwen2", "mixtral", "deepseek_v2", "gpt2"])
def test_registry_agrees_with_the_jax_one(model_type):
    hf = dict(model_type=model_type, sliding_window=None)
    if model_type == "deepseek_v2":
        hf["kv_lora_rank"] = 64
    if model_type == "mixtral":
        hf["num_local_experts"] = 4

    def verdict(reg, cfg_mod):
        try:
            return reg.validate_config(cfg_mod.ModelConfig.from_hf_config(hf)).name
        except (KeyError, ValueError) as e:
            return type(e).__name__

    assert verdict(registry, tcfg) == verdict(jregistry, jcfg)
    assert sorted(registry.FAMILIES) == sorted(jregistry.FAMILIES)


# ---------------------------------------------------------------------------
# The port's safetensors reader and writer
# ---------------------------------------------------------------------------


def _mixed_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i8": torch.randint(-128, 128, (9,), generator=g).to(torch.int8),
        "i32": torch.randint(-2**31, 2**31 - 1, (4, 4), generator=g,
                             dtype=torch.int64).to(torch.int32),
        "u8": torch.randint(0, 256, (3,), generator=g).to(torch.uint8),
        "transposed": torch.randn(4, 3, generator=g).T,
        "scalar": torch.tensor(3.0),
        "empty": torch.zeros(0, 4),
    }


def _split_safetensors(raw):
    """(header length, header entries in file order with __metadata__ as a
    dict, data bytes) of a safetensors file's bytes."""
    n = int.from_bytes(raw[:8], "little")
    entries = json.loads(raw[8:8 + n], object_pairs_hook=list)
    entries = [(k, dict(v) if k == "__metadata__" else v) for k, v in entries]
    padding = raw[8:8 + n][len(raw[8:8 + n].rstrip(b" ")):]
    return n, (entries, padding), raw[8 + n:]


@pytest.mark.parametrize("metadata", [None, {"format": "pt", "note": "x"}])
def test_streader_round_trip_and_wheel_bytes(tmp_path, metadata):
    tensors = _mixed_tensors()
    mine, wheel = tmp_path / "mine.safetensors", tmp_path / "wheel.safetensors"
    streader.save_file(tensors, str(mine), metadata)
    wheel_save_file({k: v.contiguous() for k, v in tensors.items()},
                    str(wheel), metadata)
    # The wheel writes the keys of __metadata__ in a random order (a hash
    # map, per process): the bytes are equal up to that order. Everything
    # else (lengths, tensor entries in order, padding, data) is compared
    # exactly, and the whole file when the order cannot differ.
    raw_mine, raw_wheel = mine.read_bytes(), wheel.read_bytes()
    if metadata is None or len(metadata) < 2:
        assert raw_mine == raw_wheel
    (n_mine, h_mine, d_mine), (n_wheel, h_wheel, d_wheel) = (
        _split_safetensors(raw_mine), _split_safetensors(raw_wheel))
    assert n_mine == n_wheel and d_mine == d_wheel
    assert h_mine == h_wheel
    back = streader.load_file(str(wheel))
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert torch.equal(back[k], v), k
    with streader.SafetensorsFile(str(mine)) as f:
        assert f.metadata == metadata
    with safe_open(str(mine), framework="pt") as f:
        assert f.metadata() == metadata
        for k, v in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == v.dtype
            assert got.contiguous().view(-1).view(torch.uint8).tolist() == (
                v.contiguous().view(-1).view(torch.uint8).tolist()), k


def test_streader_bf16_stays_bits_and_corrupt_files_raise(tmp_path):
    bits = torch.arange(0, 65536, 7, dtype=torch.int32).to(torch.int16)
    path = tmp_path / "bits.safetensors"
    wheel_save_file({"w": bits.view(torch.bfloat16)}, str(path))
    got = streader.load_file(str(path))["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16), bits)
    raw = path.read_bytes()
    for bad in (raw[:5], raw[:-2], b"\xff" * 8 + raw[8:]):
        path.write_bytes(bad)
        with pytest.raises(ValueError):
            streader.SafetensorsFile(str(path))
