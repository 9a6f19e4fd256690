"""Gloo worlds for the port's mesh tests (a helper of
``test_torch_parallel.py`` and ``test_torch_engine_mesh.py``; pytest
collects nothing here).

A world is ``n`` spawned processes that import only torch and the port. It
runs a list of cases in order; a case of ``k <= n`` ranks runs on ranks
``0..k-1``, in a process group of its own, joined through a ``file://``
store under the test's temporary directory (no port to collide between
xdist workers); the other ranks skip it. Each rank returns one result a
case (None where it sat out). The test starts the world, computes its JAX
oracles meanwhile, and then collects.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import traceback

import numpy as np
import torch

CASE_TIMEOUT_S = 120.0


class World:
    def __init__(self, nprocs, cases, store_dir):
        self.nprocs = nprocs
        # The cases go through a file: a large argument would hold each
        # start() until its child has imported torch to unpickle it.
        path = os.path.join(str(store_dir), "cases.pkl")
        with open(path, "wb") as f:
            pickle.dump(cases, f)
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        self.procs = [
            ctx.Process(target=_rank_main,
                        args=(r, path, str(store_dir), self.queue),
                        daemon=True)
            for r in range(nprocs)]
        for p in self.procs:
            p.start()
        self._results = None

    def results(self, timeout=600):
        """Per case, the list of every rank's result; raises on any rank's
        error."""
        if self._results is None:
            got = {}
            try:
                for _ in self.procs:
                    rank, payload = self.queue.get(timeout=timeout)
                    got[rank] = payload
            finally:
                for p in self.procs:
                    p.join(timeout=30)
                    if p.is_alive():
                        p.terminate()
                        p.join()
            errors = [v for v in got.values() if isinstance(v, str)]
            if errors:
                raise RuntimeError("a rank failed:\n" + errors[0])
            n = len(got[0])
            self._results = [[got[r][i] for r in range(self.nprocs)]
                             for i in range(n)]
        return self._results


def _rank_main(rank, cases_path, store_dir, queue):
    torch.set_num_threads(1)
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    from distributed_llm_inference_tpu_torch.parallel import init_distributed
    import torch.distributed as dist

    out = []
    try:
        for i, case in enumerate(cases):
            if rank >= case["n"]:
                out.append(None)
                continue
            init_distributed("gloo", f"file://{os.path.join(store_dir, f'c{i}')}",
                             case["n"], rank, timeout_s=CASE_TIMEOUT_S)
            try:
                out.append(RUNNERS[case["run"]](case))
            finally:
                dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, f"rank {rank}, case {len(out)}:\n"
                   + traceback.format_exc()))


# -- the runners: each builds its mesh and returns numpy / plain values ------


def _mesh(case, device="cpu"):
    from distributed_llm_inference_tpu_torch.config import MeshConfig
    from distributed_llm_inference_tpu_torch.parallel import build_mesh

    return build_mesh(MeshConfig(**case["mesh"]), device)


def _cfg(case):
    from distributed_llm_inference_tpu_torch.config import ModelConfig

    return ModelConfig(**case["model"])


def _np(t):
    return t.detach().cpu().numpy()


def run_model_apply(case):
    """tp (and ep) ``model_apply`` over a dense cache: the logits."""
    from distributed_llm_inference_tpu_torch.cache.dense import DenseKVCache
    from distributed_llm_inference_tpu_torch.models import llama
    from distributed_llm_inference_tpu_torch.parallel import tp

    mesh = _mesh(case)
    cfg = tp.local_model_config(_cfg(case), mesh.shape)
    params = tp.shard_params(case["tree"], mesh)
    tokens = torch.from_numpy(case["tokens"])
    cache = DenseKVCache.create(cfg.num_layers, tokens.shape[0], case["T"],
                                cfg.num_kv_heads, cfg.head_dim, torch.float32,
                                device="cpu")
    logits, cache = llama.model_apply(
        cfg, params, tokens, cache, torch.from_numpy(case["num_new"]),
        mesh=mesh)
    return {"logits": _np(logits), "k": _np(cache.k)}


def run_pipeline(case):
    """``pipeline_block_apply`` over a dense cache: the hidden states and
    this stage's keys."""
    from distributed_llm_inference_tpu_torch.cache.dense import DenseKVCache
    from distributed_llm_inference_tpu_torch.ops.attention import gqa_attention
    from distributed_llm_inference_tpu_torch.parallel import tp
    from distributed_llm_inference_tpu_torch.parallel.pipeline import (
        pipeline_block_apply)

    mesh = _mesh(case)
    cfg = tp.local_model_config(_cfg(case), mesh.shape)
    layers = tp.shard_params({"layers": case["tree"]["layers"]}, mesh,
                             use_pp=True)["layers"]
    x = torch.from_numpy(case["x"])
    cache = DenseKVCache.create(cfg.num_layers, x.shape[0], case["T"],
                                cfg.num_kv_heads, cfg.head_dim, torch.float32,
                                device="cpu")
    out, cache = pipeline_block_apply(
        cfg, layers, x, cache, torch.from_numpy(case["num_new"]),
        gqa_attention, mesh, case["micro"])
    return {"x": _np(out), "k": _np(cache.k)}


def run_ring_attention(case):
    """``ring_gqa_attention`` on each rank's chunk, gathered over sp."""
    from distributed_llm_inference_tpu_torch.parallel import comm
    from distributed_llm_inference_tpu_torch.parallel.ring import (
        ring_gqa_attention)

    mesh = _mesh(case)
    sp = mesh.axis("sp")
    s = case["q"].shape[1]
    sl = s // sp.size
    cut = slice(sp.index * sl, (sp.index + 1) * sl)

    def chunk(name):
        return torch.from_numpy(np.ascontiguousarray(case[name][:, cut]))

    out = ring_gqa_attention(chunk("q"), chunk("k"), chunk("v"), chunk("pos"),
                             chunk("pos"), chunk("valid"), case["scale"], sp)
    return _np(comm.all_gather(out, sp, dim=1))


def run_ring_prefill(case):
    from distributed_llm_inference_tpu_torch.parallel import tp
    from distributed_llm_inference_tpu_torch.parallel.ring import ring_prefill

    mesh = _mesh(case)
    cfg = tp.local_model_config(_cfg(case), mesh.shape)
    params = tp.shard_params(case["tree"], mesh)
    logits, ks, vs = ring_prefill(cfg, params, torch.from_numpy(case["tokens"]),
                                  torch.from_numpy(case["num_new"]), mesh)
    return {"logits": _np(logits), "ks": _np(ks), "vs": _np(vs)}


def drive(engine, options_cls, script, max_steps=400):
    """Run ``script`` (per tick, prompts to submit with their option fields)
    then drain. Returns the streams, each tick's events with generation
    ids replaced by submission indices, and the finish reasons."""
    sessions, index, ticks = [], {}, []
    step = 0
    while step < len(script) or engine.has_work():
        if step < len(script):
            for prompt, opts in script[step]:
                s = engine._submit_session(prompt, options_cls(**opts))
                index[s.generation_id] = len(sessions)
                sessions.append(s)
        ticks.append([(index[g], t, f) for g, t, f in engine.step()])
        step += 1
        assert step < max_steps, "engine did not drain"
    return ([s.generated for s in sessions], ticks,
            [s.finish_reason for s in sessions])


def run_engine(case):
    """The port's ``InferenceEngine`` under the case's mesh through its
    script: streams, events, finish reasons and counters."""
    from distributed_llm_inference_tpu_torch import config as tc
    from distributed_llm_inference_tpu_torch.engine.engine import (
        InferenceEngine)
    from distributed_llm_inference_tpu_torch.engine.sampling import (
        SamplingOptions)
    from distributed_llm_inference_tpu_torch.models import llama

    cfg = _cfg(case)
    params = llama.params_from_numpy(cfg, case["tree"], torch.float32, "cpu")
    engine = InferenceEngine(
        cfg, params, tc.EngineConfig(**case["engine"]),
        tc.CacheConfig(**case["cache"]), mesh_cfg=tc.MeshConfig(**case["mesh"]),
        device="cpu", **case.get("engine_kw", {}))
    streams, ticks, reasons = drive(engine, SamplingOptions, case["script"])
    snap = engine.metrics.snapshot()
    return {"streams": streams, "ticks": ticks, "reasons": reasons,
            "counters": {k: snap.get(k) for k in (
                "ring_prefills", "cache_growths", "batched_prefills")},
            "max_len": engine.cache.max_len,
            "decode_steps": engine.decode_steps}


RUNNERS = {
    "model_apply": run_model_apply,
    "pipeline": run_pipeline,
    "ring_attention": run_ring_attention,
    "ring_prefill": run_ring_prefill,
    "engine": run_engine,
}
