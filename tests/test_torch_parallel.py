"""Port parity, the sharded-serving modules (``parallel/``, the tensor-
parallel model, expert parallelism, ``shard_put``): the same inputs, made
from seeds, go through the JAX functions on the 8-device virtual CPU mesh
and through the port on a gloo world of spawned processes (one rank a
process, a ``file://`` store under the test's temporary directory).

* each rank's slice of the weights and of every cache kind equals what the
  JAX ``shard_pytree`` puts on the device at its mesh coordinate, and
  ``shard_put`` gives the same (no world needed: a rank's slice depends on
  its coordinate only);
* ``validate_tp`` raises the JAX words;
* on the world: tensor-parallel ``model_apply`` logits (and tp x ep for a
  Mixtral), ``pipeline_block_apply`` at pp 2 and 4 with 1, 2 and 4
  microbatches, ``ring_gqa_attention`` and ``ring_prefill`` at sp 2 and 4,
  all f32, to 1e-5 of the largest value.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.cache import dense as jdense
from distributed_llm_inference_tpu.cache import paged as jpaged
from distributed_llm_inference_tpu.cache import sink as jsink
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu.ops.attention import causal_mask
from distributed_llm_inference_tpu.parallel import (
    build_mesh as jbuild_mesh,
    cache_pspecs as jcache_pspecs,
    param_pspecs as jparam_pspecs,
    shard_pytree,
    validate_tp as jvalidate_tp,
)
from distributed_llm_inference_tpu.parallel.pipeline import (
    pipeline_block_apply as jpipeline_block_apply)
from distributed_llm_inference_tpu.parallel.ring import (
    ring_gqa_attention as jring_gqa_attention, ring_prefill as jring_prefill)
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.parallel import tp as ttp
from distributed_llm_inference_tpu_torch.utils import checkpoint as tckpt

from torch_mesh_worlds import World

torch.set_num_threads(1)

MODEL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_layers=4, num_heads=8, num_kv_heads=4, head_dim=8,
             max_position_embeddings=128)
MOE = dict(MODEL, num_layers=2, num_experts=4, num_experts_per_tok=2,
           family="mixtral")


def tree(model, seed):
    params = jllama.init_params(jcfg.ModelConfig(**model),
                                jax.random.PRNGKey(seed), jnp.float32)
    return params, jax.tree_util.tree_map(np.asarray, params)


JPARAMS, TREE = tree(MODEL, 0)
JMOE, MOE_TREE = tree(MOE, 3)
rng = np.random.default_rng(0)
TOKENS = rng.integers(0, 128, size=(2, 16)).astype(np.int32)
NUM_NEW = np.asarray([16, 11], np.int32)
X = rng.standard_normal((4, 8, 64)).astype(np.float32)
ATT = {name: rng.standard_normal(shape).astype(np.float32) for name, shape in (
    ("q", (2, 32, 8, 16)), ("k", (2, 32, 4, 16)), ("v", (2, 32, 4, 16)))}
ATT["pos"] = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32)).copy()
ATT["valid"] = np.ones((2, 32), bool)
ATT["valid"][1, 28:] = False
RING_TOKENS = rng.integers(0, 128, size=(2, 32)).astype(np.int32)
RING_NUM_NEW = np.asarray([32, 27], np.int32)

# The world's cases, in order (a case of n ranks runs on ranks 0..n-1).
CASES = {
    "model_apply_tp2": dict(run="model_apply", n=2, mesh=dict(tp=2),
                            model=MODEL, tree=TREE, tokens=TOKENS,
                            num_new=NUM_NEW, T=32),
    "model_apply_mixtral_ep2_tp2": dict(
        run="model_apply", n=4, mesh=dict(ep=2, tp=2), model=MOE,
        tree=MOE_TREE, tokens=TOKENS, num_new=NUM_NEW, T=32),
    **{f"pipeline_pp{pp}_m{m}": dict(run="pipeline", n=pp, mesh=dict(pp=pp),
                                     model=MODEL, tree=TREE, x=X,
                                     num_new=np.full(4, 8, np.int32), T=16,
                                     micro=m)
       for pp, m in ((2, 1), (2, 2), (4, 2), (4, 4))},
    **{f"ring_attention_sp{sp}": dict(run="ring_attention", n=sp,
                                      mesh=dict(sp=sp), scale=16 ** -0.5,
                                      **ATT)
       for sp in (2, 4)},
    **{f"ring_prefill_sp{sp}": dict(run="ring_prefill", n=sp,
                                    mesh=dict(sp=sp), model=MODEL, tree=TREE,
                                    tokens=RING_TOKENS, num_new=RING_NUM_NEW)
       for sp in (2, 4)},
}
NAMES = list(CASES)


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Started before the module's first test: the slice tests run while
    its processes work."""
    return World(4, list(CASES.values()), tmp_path_factory.mktemp("store"))


def ranks(world, name):
    return world.results()[NAMES.index(name)]


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


# -- slices: no world --------------------------------------------------------


def rank_mesh(mesh_kw, rank):
    """The coordinate of ``rank`` in the port's mesh (row-major over
    ``MeshConfig.shape``), as a stand-in for a built ``RankMesh``."""
    cfg = tcfg.MeshConfig(**mesh_kw)
    coord = np.unravel_index(rank, cfg.shape)
    index = dict(zip(cfg.axis_names, (int(c) for c in coord)))
    return types.SimpleNamespace(shape=dict(zip(cfg.axis_names, cfg.shape)),
                                 index=index.__getitem__, device="cpu")


def jax_shard_on(arr, mesh, rank):
    """The shard of a sharded JAX array on the device at row-major mesh
    position ``rank``."""
    device = mesh.devices.flat[rank]
    [shard] = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(shard.data)


def leaves(tree_, prefix=""):
    if isinstance(tree_, dict):
        for k, v in tree_.items():
            yield from leaves(v, f"{prefix}{k}.")
    elif hasattr(tree_, "q"):
        for f in ("q", "scale"):
            yield f"{prefix}{f}", getattr(tree_, f)
    else:
        yield prefix[:-1], tree_


MESHES = [dict(tp=2), dict(pp=2, tp=2), dict(dp=2, pp=2, tp=2),
          dict(ep=2, tp=2)]


@pytest.mark.parametrize("mesh_kw", MESHES, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
def test_weight_slices_equal_the_jax_shards(mesh_kw):
    use_pp = mesh_kw.get("pp", 1) > 1
    jparams, host = (JMOE, MOE_TREE) if "ep" in mesh_kw else (JPARAMS, TREE)
    mesh = jbuild_mesh(jcfg.MeshConfig(**mesh_kw))
    sharded = shard_pytree(jparams, mesh, jparam_pspecs(jparams, use_pp))
    n = jcfg.MeshConfig(**mesh_kw).num_devices
    for rank in range(n):
        mine = ttp.shard_params(host, rank_mesh(mesh_kw, rank), use_pp)
        put = tckpt.shard_put(host, rank_mesh(mesh_kw, rank), use_pp)
        theirs = dict(leaves(sharded))
        for name, got in leaves(mine):
            want = jax_shard_on(theirs[name], mesh, rank)
            assert got.shape == want.shape, (rank, name)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            np.testing.assert_array_equal(dict(leaves(put))[name].numpy(),
                                          want)


def test_int8_weight_slices_equal_the_jax_shards():
    from distributed_llm_inference_tpu.ops.quant import (
        quantize_params as jquantize)

    mesh_kw = dict(tp=2)
    from distributed_llm_inference_tpu_torch.models import llama as tllama

    jq = jax.jit(lambda p: jquantize(p, bits=8, scale_dtype=jnp.float32))(
        JPARAMS)
    host = tllama.params_from_numpy(
        tcfg.ModelConfig(**MODEL), jax.tree_util.tree_map(np.asarray, jq),
        torch.float32, "cpu")
    mesh = jbuild_mesh(jcfg.MeshConfig(**mesh_kw))
    sharded = dict(leaves(shard_pytree(jq, mesh, jparam_pspecs(jq))))
    for rank in range(2):
        mine = ttp.shard_params(host, rank_mesh(mesh_kw, rank))
        for name, got in leaves(mine):
            np.testing.assert_array_equal(
                got.numpy(), jax_shard_on(sharded[name], mesh, rank),
                err_msg=name)


CACHES = {
    "dense": lambda: jdense.DenseKVCache.create(4, 4, 16, 4, 8, jnp.float32),
    "dense_int8": lambda: jdense.QuantizedDenseKVCache.create(
        4, 4, 16, 4, 8, jnp.float32),
    "paged": lambda: jpaged.PagedKVCache.create(4, 4, 8, 4, 3, 4, 8,
                                                jnp.float32),
    "paged_int8": lambda: jpaged.QuantizedPagedKVCache.create(
        4, 4, 8, 4, 3, 4, 8, jnp.float32),
    "sink": lambda: jsink.SinkKVCache.create(4, 4, 12, 2, 4, 8, jnp.float32),
    "sink_int8": lambda: jsink.QuantizedSinkKVCache.create(
        4, 4, 12, 2, 4, 8, jnp.float32),
}


@pytest.mark.parametrize("name", list(CACHES))
def test_cache_slices_equal_the_jax_shards(name):
    """The port's cache field specs cut each field as the JAX specs shard
    it, and ``local_cache_shape`` gives every plane's rank-local
    (layers, rows, kv heads)."""
    kind, _, q = name.partition("_")
    use_pp = kind != "sink"  # pp serves the dense and paged kinds only
    mesh_kw = dict(dp=2, pp=2, tp=2) if use_pp else dict(dp=2, tp=2)
    mesh = jbuild_mesh(jcfg.MeshConfig(**mesh_kw))
    rng_ = np.random.default_rng(1)
    cache = CACHES[name]()
    cache = cache.replace(**{
        f: jnp.asarray(rng_.integers(-100, 100, getattr(cache, f).shape)
                       .astype(getattr(cache, f).dtype))
        for f in ttp.cache_pspecs(kind, q or None, use_pp)})
    sharded = shard_pytree(cache, mesh, jcache_pspecs(cache, use_pp))
    specs = ttp.cache_pspecs(kind, q or None, use_pp)
    shape = dict(zip(jcfg.MeshConfig(**mesh_kw).axis_names,
                     jcfg.MeshConfig(**mesh_kw).shape))
    layers, rows, heads = ttp.local_cache_shape(4, 4, 4, shape)
    for rank in range(jcfg.MeshConfig(**mesh_kw).num_devices):
        index = rank_mesh(mesh_kw, rank).index
        for field, spec in specs.items():
            want = jax_shard_on(getattr(sharded, field), mesh, rank)
            got = ttp._cut(np.asarray(getattr(cache, field)), spec, shape,
                           {n: index(n) for n in shape})
            np.testing.assert_array_equal(got, want, err_msg=field)
        plane = jax_shard_on(sharded.layer_stacks[0] if hasattr(
            sharded, "layer_stacks") else sharded.k, mesh, rank)
        assert plane.shape[0] == (layers if use_pp else 4)
        if kind == "paged":
            assert jax_shard_on(sharded.page_table, mesh, rank).shape[0] == rows
            assert plane.shape[2] == heads
        else:
            assert plane.shape[1] == rows
            assert heads in plane.shape[2:4]


@pytest.mark.parametrize("degrees,model", [
    (dict(tp=3), MODEL), (dict(tp=2), dict(MODEL, intermediate_size=129)),
    (dict(tp=2), dict(MODEL, vocab_size=129)), (dict(tp=2, sp=3), MODEL),
    (dict(tp=1, ep=2), MODEL), (dict(tp=1, ep=3), MOE),
], ids=["kv_heads", "mlp", "vocab", "sp_heads", "ep_dense", "ep_experts"])
def test_validate_tp_raises_the_jax_words(degrees, model):
    with pytest.raises(ValueError) as want:
        jvalidate_tp(jcfg.ModelConfig(**model), **degrees)
    with pytest.raises(ValueError) as got:
        ttp.validate_tp(tcfg.ModelConfig(**model), **degrees)
    assert str(got.value) == str(want.value)


# -- on the world ------------------------------------------------------------


def jax_model_apply(model, params, tokens, num_new, t):
    cfg = jcfg.ModelConfig(**model)
    cache = jdense.DenseKVCache.create(cfg.num_layers, tokens.shape[0], t,
                                       cfg.num_kv_heads, cfg.head_dim,
                                       jnp.float32)
    logits, _ = jllama.model_apply(cfg, params, jnp.asarray(tokens), cache,
                                   jnp.asarray(num_new))
    return np.asarray(logits)


@pytest.mark.parametrize("name", ["model_apply_tp2",
                                  "model_apply_mixtral_ep2_tp2"])
def test_tensor_parallel_model_apply_logits(world, name):
    case = CASES[name]
    want = jax_model_apply(case["model"],
                           JMOE if "mixtral" in name else JPARAMS,
                           case["tokens"], case["num_new"], case["T"])
    got = ranks(world, name)
    for rank in range(case["n"]):
        close(got[rank]["logits"], want)


@pytest.mark.parametrize("name", [n for n in NAMES if n.startswith("pipe")])
def test_pipeline_block_apply(world, name):
    case = CASES[name]
    cfg = jcfg.ModelConfig(**MODEL)
    mesh = jbuild_mesh(jcfg.MeshConfig(**case["mesh"]))
    cache = jdense.DenseKVCache.create(4, 4, 16, 4, 8, jnp.float32)
    cache = shard_pytree(cache, mesh, jcache_pspecs(cache, use_pp=True))
    layers = shard_pytree(JPARAMS, mesh, jparam_pspecs(JPARAMS, True))["layers"]
    n = jnp.asarray(case["num_new"])
    x, cache = jax.jit(lambda lp, x_, c: jpipeline_block_apply(
        cfg, lp, x_, c, n, mesh, case["micro"]))(layers, jnp.asarray(X), cache)
    k = np.asarray(cache.k)
    per = 4 // case["n"]
    for rank, got in enumerate(ranks(world, name)[:case["n"]]):
        close(got["x"], x)
        close(got["k"], k[rank * per:(rank + 1) * per])


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_gqa_attention(world, sp):
    mesh = jbuild_mesh(jcfg.MeshConfig(sp=sp), jax.devices()[:sp])
    spec = P(None, "sp")
    want = jax.jit(jax.shard_map(
        lambda q, k, v, pos, valid: jring_gqa_attention(
            q, k, v, pos, pos, valid, 16 ** -0.5),
        mesh=mesh, in_specs=(spec,) * 5, out_specs=spec, axis_names={"sp"},
        check_vma=False))(*(jnp.asarray(ATT[n]) for n in (
            "q", "k", "v", "pos", "valid")))
    for got in ranks(world, f"ring_attention_sp{sp}")[:sp]:
        close(got, want)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_prefill(world, sp):
    mesh = jbuild_mesh(jcfg.MeshConfig(sp=sp), jax.devices()[:sp])
    logits, ks, vs = jax.jit(lambda p, t: jring_prefill(
        jcfg.ModelConfig(**MODEL), p, t, jnp.asarray(RING_NUM_NEW), mesh))(
        JPARAMS, jnp.asarray(RING_TOKENS))
    for got in ranks(world, f"ring_prefill_sp{sp}")[:sp]:
        close(got["logits"], logits)
        close(got["ks"], ks)
        close(got["vs"], vs)


def test_ring_attention_agrees_with_one_softmax():
    """The JAX oracle above is itself held to one softmax over the whole
    row (``tests/test_ring.py``); here the mask the port's ring builds per
    visit, joined over visits, is the whole row's."""
    from distributed_llm_inference_tpu_torch.ops.attention import (
        causal_mask as tmask)

    pos, valid = ATT["pos"], ATT["valid"]
    want = np.asarray(causal_mask(jnp.asarray(pos), jnp.asarray(pos),
                                  jnp.asarray(valid)))
    sl = 8
    got = np.concatenate([
        tmask(torch.from_numpy(pos), torch.from_numpy(pos[:, j:j + sl]),
              torch.from_numpy(valid[:, j:j + sl])).numpy()
        for j in range(0, 32, sl)], axis=-1)
    np.testing.assert_array_equal(got, want)


def hf_state(tree_, cfg):
    """An HF-keyed state dict (torch's ``[out, in]`` layout) of a port
    parameter tree (numpy, ``[in, out]``), inverting the conversion's key
    map."""
    from distributed_llm_inference_tpu_torch.models.llama import _LAYER_KEY_MAP

    state = {"model.embed_tokens.weight": tree_["embed"],
             "model.norm.weight": tree_["final_norm"],
             "lm_head.weight": tree_["lm_head"].T}
    for i in range(cfg.num_layers):
        for suffix, (name, transposed) in _LAYER_KEY_MAP.items():
            if name in tree_["layers"]:
                w = tree_["layers"][name][i]
                state[f"model.layers.{i}.{suffix}"] = w.T if transposed else w
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


@pytest.mark.parametrize("mesh_kw", [dict(tp=2), dict(pp=2, tp=2)],
                         ids=["tp2", "pp2xtp2"])
def test_load_sharded_params_reads_each_ranks_slice(tmp_path, mesh_kw):
    """A checkpoint written by the port's writer, each rank's slice read
    through the mmap reader, equals ``shard_put`` of the whole tree."""
    cfg = tcfg.ModelConfig(**MODEL)
    tckpt.save_safetensors(hf_state(TREE, cfg),
                           str(tmp_path / "model.safetensors"))
    use_pp = "pp" in mesh_kw
    for rank in range(tcfg.MeshConfig(**mesh_kw).num_devices):
        mesh = rank_mesh(mesh_kw, rank)
        got = dict(leaves(tckpt.load_sharded_params(
            str(tmp_path), cfg, mesh, torch.float32)))
        want = dict(leaves(tckpt.shard_put(TREE, mesh, use_pp)))
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name].numpy(), w.numpy(),
                                          err_msg=name)


def test_a_ranks_slice_is_not_cut_twice():
    """An engine under the mesh takes a rank's slice (``shard_put``,
    ``load_sharded_params``) as it is; another rank's slice is refused."""
    mine = ttp.shard_params(TREE, rank_mesh(dict(tp=2), 1))
    assert ttp.shard_params(mine, rank_mesh(dict(tp=2), 1)) is mine
    with pytest.raises(ValueError, match="slice cut for"):
        ttp.shard_params(mine, rank_mesh(dict(tp=2), 0))
