"""Port parity, the engine under a mesh (``InferenceEngine(mesh_cfg=...)``):
one gloo world of 8 spawned processes (``torch_mesh_worlds.py``) serves the
meshes of ``tests/test_engine.py`` through the port's engine, each rank
running the same scheduler over the same submissions, and the greedy
streams must equal the JAX engine's on the same weights, all f32:

* tp = 2 on the dense cache, held to the JAX MESH engine itself: streams,
  finish reasons and the events of every tick;
* tp2 x pp2 x dp2; pp2 x dp2 at ``decode_steps=4``; the growth ladder under
  pp and pp x dp; the paged pool under pp, pp x dp, pp x tp and pp with
  int8 pages; ring prefill over sp = 2 on the dense and paged caches, in
  the model dtype and int8 (``ring_prefills == 2``), and over sp2 x tp2;
  a Mixtral under
  ep = 2; the sink ring under tp = 2 — each held to the unsharded JAX
  engine, which the JAX tests hold equal to its mesh engine.

The mesh refusals raise the JAX words, and what waits names ROADMAP item
22, before any process group is touched (no world).
"""

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
from distributed_llm_inference_tpu_torch.models import llama as tllama

from torch_mesh_worlds import World, drive

torch.set_num_threads(1)

MODEL = dict(vocab_size=128, hidden_size=64, intermediate_size=160,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
MIXTRAL = dict(MODEL, num_experts=4, num_experts_per_tok=2, family="mixtral")
JPARAMS = jllama.init_params(jcfg.ModelConfig(**MODEL), jax.random.PRNGKey(0),
                             dtype=jnp.float32)
JMIXTRAL = jllama.init_params(jcfg.ModelConfig(**MIXTRAL),
                              jax.random.PRNGKey(3), dtype=jnp.float32)
TREES = {"llama": jax.tree_util.tree_map(np.asarray, JPARAMS),
         "mixtral": jax.tree_util.tree_map(np.asarray, JMIXTRAL)}


def prompts(n, lo=3, hi=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def long_prompts(seed, lens=(24, 37)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=n).tolist() for n in lens]


ENGINE = dict(max_batch_size=4, prefill_buckets=(8, 16, 32), max_seq_len=64,
              dtype="float32")
RING = dict(ENGINE, max_batch_size=2, prefill_buckets=(8, 16))
PAGED = dict(kind="paged", page_size=8, num_pages=64, max_pages_per_session=8)
LADDER = dict(ENGINE, prefill_buckets=(8, 16), decode_windows=(16, 64))


def case(mesh, prompts_, new, engine=ENGINE, cache=None, model="llama",
         oracle="plain", **extra):
    n = int(np.prod(list(mesh.values())))
    script = [[(p, {"max_new_tokens": new}) for p in prompts_]]
    return dict(run="engine", n=n, mesh=mesh, model=MIXTRAL if model ==
                "mixtral" else MODEL, tree=TREES[model], engine=engine,
                cache=cache or {"kind": "dense"}, script=script,
                oracle=oracle, **extra)


CASES = {
    "tp2_dense": case(dict(tp=2), prompts(5, seed=31), 6, oracle="mesh"),
    "tp2_pp2_dp2_dense": case(dict(tp=2, pp=2, dp=2), prompts(7, seed=11), 6),
    "pp2_dp2_dense_k4": case(dict(pp=2, dp=2), prompts(5, seed=12), 7,
                             engine=dict(ENGINE, decode_steps=4)),
    **{f"ladder_{name}": case(mesh, [np.random.default_rng(13).integers(
        0, 128, size=6).tolist() for _ in range(4)], 24, engine=LADDER)
        for name, mesh in (("pp2", dict(pp=2)),
                           ("pp2_dp2", dict(pp=2, dp=2)))},
    **{f"paged_{name}": case(mesh, prompts(6, seed=17), 6,
                             cache=dict(PAGED, kv_quant=q))
       for name, mesh, q in (("pp2", dict(pp=2), None),
                             ("pp2_dp2", dict(pp=2, dp=2), None),
                             ("pp2_tp2", dict(pp=2, tp=2), None),
                             ("pp2_int8", dict(pp=2), "int8"))},
    # Prompts past the largest bucket (16, the ring threshold) go round the
    # ring.
    **{f"ring_{kind}_{q or 'f32'}": case(
        dict(sp=2), long_prompts(7 if kind == "dense" else 23), 6,
        engine=RING, cache=dict(PAGED if kind == "paged" else
                                {"kind": "dense"}, kv_quant=q))
       for kind in ("dense", "paged") for q in (None, "int8")},
    "ring_dense_f32_tp2": case(dict(sp=2, tp=2), long_prompts(9, (29,)), 5,
                               engine=RING),
    "mixtral_ep2": case(dict(ep=2), prompts(3, seed=5), 5, model="mixtral",
                        engine=dict(ENGINE, max_batch_size=2,
                                    prefill_buckets=(8, 16), max_seq_len=48)),
    "sink_tp2": case(dict(tp=2), prompts(2, seed=3), 40,
                     engine=dict(ENGINE, max_batch_size=2),
                     cache=dict(kind="sink", window_length=16,
                                num_sink_tokens=2)),
}
NAMES = list(CASES)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(8, list(CASES.values()), tmp_path_factory.mktemp("store"))


_ENGINES, _ORACLES = {}, {}


def jax_run(c):
    """The JAX oracle of a case: its mesh engine (``oracle="mesh"``) or the
    unsharded engine, through the same script. Cases that differ only by
    their mesh share the unsharded engine's run, and cases of one
    configuration share its engine (drained between scripts: greedy
    streams do not depend on what ran before)."""
    mesh = jcfg.MeshConfig(**c["mesh"]) if c["oracle"] == "mesh" else None
    ecfg, ccfg = jcfg.EngineConfig(**c["engine"]), jcfg.CacheConfig(**c["cache"])
    config = repr((mesh, c["model"], ecfg, ccfg))
    key = config + repr(c["script"])
    if key not in _ORACLES:
        if config not in _ENGINES:
            _ENGINES[config] = JaxEngine(
                jcfg.ModelConfig(**c["model"]),
                JMIXTRAL if c["model"] is MIXTRAL else JPARAMS, ecfg, ccfg,
                mesh_cfg=mesh)
        _ORACLES[key] = drive(_ENGINES[config], JaxOptions, c["script"])
    return _ORACLES[key]


@pytest.mark.parametrize("name", NAMES)
def test_mesh_engine_streams_equal_the_jax_engine(world, name):
    c = CASES[name]
    streams, ticks, reasons = jax_run(c)
    got = world.results()[NAMES.index(name)]
    for rank in range(c["n"]):
        assert got[rank]["streams"] == streams, (name, rank)
        assert got[rank]["reasons"] == reasons, (name, rank)
    assert all(len(s) == c["script"][0][0][1]["max_new_tokens"]
               for s in streams)
    mine = got[0]
    if c["oracle"] == "mesh":
        assert mine["ticks"] == ticks, "per-tick events differ"
    if name.startswith("ring"):
        assert mine["counters"]["ring_prefills"] == len(c["script"][0])
    if name.startswith("ladder"):
        assert mine["counters"]["cache_growths"] >= 1
        assert mine["max_len"] == 64
    if name == "pp2_dp2_dense_k4":
        assert mine["decode_steps"] == 4


# -- refusals and what waits: no world ----------------------------------------

TPARAMS = tllama.params_from_numpy(tcfg.ModelConfig(**MODEL), TREES["llama"],
                                   torch.float32, "cpu")
REFUSALS = [
    ("sink_sp", dict(kind="sink"), dict(max_batch_size=2), dict(sp=2)),
    ("sp_pp", dict(kind="dense"), dict(max_batch_size=4), dict(pp=2, sp=2)),
    ("batch_dp", dict(kind="dense"), dict(max_batch_size=3), dict(dp=2)),
    ("sink_pp", dict(kind="sink"), dict(max_batch_size=4), dict(pp=2)),
    ("layers_pp", dict(kind="dense"), dict(max_batch_size=4), dict(pp=4)),
    ("tp_heads", dict(kind="dense"), dict(max_batch_size=4), dict(tp=4)),
]


@pytest.mark.parametrize("name,cache,engine,mesh", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_mesh_refusals_raise_the_jax_words(name, cache, engine, mesh):
    kw = dict(dtype="float32", **engine)
    with pytest.raises(ValueError) as want:
        JaxEngine(jcfg.ModelConfig(**MODEL), JPARAMS, jcfg.EngineConfig(**kw),
                  jcfg.CacheConfig(**cache), mesh_cfg=jcfg.MeshConfig(**mesh))
    with pytest.raises(ValueError) as got:
        InferenceEngine(tcfg.ModelConfig(**MODEL), TPARAMS,
                        tcfg.EngineConfig(**kw), tcfg.CacheConfig(**cache),
                        mesh_cfg=tcfg.MeshConfig(**mesh), device="cpu")
    assert str(got.value) == str(want.value)


def test_latent_model_under_a_mesh_raises_the_jax_words():
    latent = dict(MODEL, latent=tcfg.LatentConfig(), family="mla")
    with pytest.raises(ValueError, match="latent KV attention is "
                       "single-device only"):
        InferenceEngine(tcfg.ModelConfig(**latent), TPARAMS,
                        tcfg.EngineConfig(dtype="float32"),
                        tcfg.CacheConfig(), mesh_cfg=tcfg.MeshConfig(tp=2),
                        device="cpu")


@pytest.mark.parametrize("what,engine,cache,draft,mesh", [
    ("int4_tp", dict(quantization="int4"), {}, False, dict(tp=2)),
    ("int4_pp", dict(quantization="int4"), {}, False, dict(pp=2)),
    ("prefix", {}, dict(prefix_caching=True), False, dict(dp=2)),
    ("draft", {}, {}, True, dict(tp=2)),
], ids=lambda x: x if isinstance(x, str) else None)
def test_what_waits_names_item_22(what, engine, cache, draft, mesh):
    cfg = tcfg.ModelConfig(**MODEL)
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md queue 1, item 22"):
        InferenceEngine(
            cfg, TPARAMS, tcfg.EngineConfig(dtype="float32", **engine),
            tcfg.CacheConfig(**cache), mesh_cfg=tcfg.MeshConfig(**mesh),
            draft=(cfg, TPARAMS) if draft else None, device="cpu")
    import torch.distributed as dist

    assert not dist.is_initialized(), "a process group was touched"
