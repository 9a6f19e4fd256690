"""Tensor-parallel sharding rules, applied on the host (counterpart of the
JAX package's ``parallel/tp.py``).

The JAX package annotates parameters with ``NamedSharding`` and lets XLA
insert the collectives. The port keeps the same rules, one axis name (or
None) a tensor dimension, and cuts each rank's slice of every tensor on the
host, before anything is copied to the rank's device: no rank ever holds
another rank's shard on its card. The model then calls the collectives
itself (``models/llama.py``):

* column-parallel: ``wq/wk/wv`` (head dim), ``wg/wu`` (MLP features),
  each rank computing its heads and features with no communication;
* row-parallel: ``wo``, ``wd`` (contracting dim sharded), followed by an
  ``all_reduce`` over ``tp``;
* the KV cache's heads are sharded over ``tp``, so its reads and writes
  stay on the rank;
* the embedding is vocab-sharded (mask, look up, ``all_reduce``);
  ``lm_head`` shards the logits' vocab dim (``all_gather`` before
  sampling).

A spec is a tuple with one entry a dimension; trailing dimensions not named
are replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.quant import (
    QuantizedTensor,
    QuantizedTensor4Split,
    QuantizedTensorOutlier,
)

__all__ = [
    "layer_pspecs",
    "param_pspecs",
    "cache_pspecs",
    "local_cache_shape",
    "local_model_config",
    "RankParams",
    "shard_tensor",
    "shard_params",
    "validate_tp",
]

Spec = Tuple[Optional[str], ...]

# Stacked per-layer parameters: the leading axis is the layer stack, which
# ``pp`` shards when pipelining (``parallel/pipeline.py``).
_LAYER_RULES: Dict[str, Spec] = {
    "attn_norm": ("pp", None),
    "wq": ("pp", None, "tp"),
    "wk": ("pp", None, "tp"),
    "wv": ("pp", None, "tp"),
    "bq": ("pp", "tp"),
    "bk": ("pp", "tp"),
    "bv": ("pp", "tp"),
    "wo": ("pp", "tp", None),
    "bo": ("pp", None),
    "mlp_norm": ("pp", None),
    "wg": ("pp", None, "tp"),
    "wu": ("pp", None, "tp"),
    "wd": ("pp", "tp", None),
    # MoE (Mixtral): experts axis [L, E, in, out], experts over ``ep`` (each
    # rank computes its experts; the combine sums over ep), features over
    # ``tp`` like the dense MLP; the router replicated.
    "router": ("pp", None, None),
    "we_g": ("pp", "ep", None, "tp"),
    "we_u": ("pp", "ep", None, "tp"),
    "we_d": ("pp", "ep", "tp", None),
}


def _strip_pp(spec: Spec, use_pp: bool) -> Spec:
    return spec if use_pp else (None, *spec[1:])


def layer_pspecs(use_pp: bool = False) -> Dict[str, Spec]:
    """Specs of the stacked layer-parameter dict; ``use_pp`` shards the
    leading layer axis over ``pp`` (each stage holds its contiguous block of
    layers)."""
    return {k: _strip_pp(v, use_pp) for k, v in _LAYER_RULES.items()}


def param_pspecs(params: Dict[str, Any], use_pp: bool = False) -> Dict[str, Any]:
    """Spec tree of a full or block-only parameter tree: a spec a tensor, the
    weight's spec for a quantized leaf (:func:`shard_tensor` derives its
    fields')."""
    lp = layer_pspecs(use_pp)
    out: Dict[str, Any] = {}
    if "layers" in params:
        out["layers"] = {k: lp[k] for k in params["layers"]}
    if "embed" in params:
        out["embed"] = ("tp", None)
    if "final_norm" in params:
        out["final_norm"] = (None,)
    if "lm_head" in params:
        out["lm_head"] = (None, "tp")
    return out


def cache_pspecs(kind: str, kv_quant: Optional[str],
                 use_pp: bool = False) -> Dict[str, Spec]:
    """Specs of a KV cache's fields: kv heads over ``tp`` (reads and writes
    stay on the rank), batch rows over ``dp`` for the per-row kinds, the
    layer axis over ``pp`` when pipelining; the page pools are replicated
    over ``dp`` (any row of a replica may hold any page), their tables and
    lengths are rows over ``dp``."""
    pp = "pp" if use_pp else None
    if kind == "dense" and kv_quant == "int8":
        kv, sc = (pp, "dp", "tp", None, None), (pp, "dp", "tp", None)
        return {"k": kv, "v": kv, "ks": sc, "vs": sc, "lengths": ("dp",)}
    if kind == "dense":
        kv = (pp, "dp", None, "tp", None)
        return {"k": kv, "v": kv, "lengths": ("dp",)}
    if kind == "paged":
        kv, sc = (pp, None, "tp", None, None), (pp, None, "tp", None)
        out = {"k_pages": kv, "v_pages": kv, "page_table": ("dp", None),
               "lengths": ("dp",)}
        if kv_quant == "int8":
            out.update(ks_pages=sc, vs_pages=sc)
        return out
    if kind == "sink" and kv_quant == "int8":
        kv, sc = (pp, "dp", "tp", None, None), (pp, "dp", "tp", None)
        return {"k": kv, "v": kv, "ks": sc, "vs": sc, "sk": kv, "sv": kv,
                "sks": sc, "svs": sc, "lengths": ("dp",)}
    if kind == "sink":
        kv = (pp, "dp", None, "tp", None)
        return {"k": kv, "v": kv, "seen": ("dp",)}
    raise ValueError(f"unknown cache kind {kind}")


def local_cache_shape(num_layers: int, batch: int, num_kv_heads: int,
                      shape: Dict[str, int]) -> Tuple[int, int, int]:
    """``(layers, rows, kv heads)`` of one rank's cache under a mesh of
    ``shape`` (axis name to size): kv heads over tp, rows over dp for every
    kind (the page pools' table rows and lengths; their pages are
    replicated over dp), layers over pp. The engine creates its cache at
    this shape: no rank ever holds the whole cache."""
    return (num_layers // shape["pp"], batch // shape["dp"],
            num_kv_heads // shape["tp"])


def local_model_config(cfg: ModelConfig, shape: Dict[str, int]) -> ModelConfig:
    """The config one rank's layers run with: its layers (pp), its query and
    kv heads and MLP features (tp). The expert count stays global: the
    router scores every expert, and ``ops/moe.py`` knows its rank's share."""
    tp = shape["tp"]
    return dataclasses.replace(
        cfg, num_layers=cfg.num_layers // shape["pp"],
        num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp,
    )


def _cut(a, spec: Spec, shape: Dict[str, int], index: Dict[str, int]):
    """Rank's slice of ``a`` (a torch tensor or numpy array, host or mapped
    file) under ``spec``; a view where slicing allows."""
    for dim, name in enumerate(spec):
        if name is None or shape[name] == 1:
            continue
        n = a.shape[dim] // shape[name]
        sl = [slice(None)] * a.ndim
        sl[dim] = slice(index[name] * n, (index[name] + 1) * n)
        a = a[tuple(sl)]
    return a


def _to(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        # A copy of the slice: numpy views may be read-only.
        if a.dtype.name == "bfloat16":
            a = torch.from_numpy(np.array(a).view(np.uint16)).view(
                torch.bfloat16)
        else:
            a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype or a.dtype).contiguous()


def _cut_outlier(leaf: QuantizedTensorOutlier, spec: Spec, shape, index,
                 device) -> QuantizedTensorOutlier:
    """An int8 weight with fp outlier input channels. Its outlier indices
    address the CONTRACTED (input) axis of the whole weight: where tp shards
    that axis (row-parallel), each rank keeps the outliers that fall in its
    rows, re-indexed to them, and zeroes the side weight's others, so the
    ranks' side products sum to the whole one over the ``all_reduce``."""
    in_name = spec[-2]
    q = _cut(leaf.q, spec, shape, index)
    scale = _cut(leaf.scale, (*spec[:-2], spec[-1]), shape, index)
    idx = _cut(leaf.outlier_idx, (*spec[:-2], None), shape, index)
    w = _cut(leaf.outlier_w, (*spec[:-2], None, spec[-1]), shape, index)
    idx = torch.as_tensor(idx)
    w = torch.as_tensor(w)
    if in_name is not None and shape[in_name] > 1:
        rows = q.shape[-2]
        lo = index[in_name] * rows
        mine = (idx >= lo) & (idx < lo + rows)
        idx = torch.where(mine, idx - lo, torch.zeros_like(idx))
        w = w * mine[..., None].to(w.dtype)
    return QuantizedTensorOutlier(
        q=_to(q, device), scale=_to(scale, device),
        outlier_idx=_to(idx, device), outlier_w=_to(w, device))


def shard_tensor(leaf, spec: Spec, shape: Dict[str, int],
                 index: Dict[str, int], device, dtype=None):
    """This rank's shard of one parameter leaf on ``device``: a tensor (or
    numpy array) cut by ``spec``, or a quantized leaf whose fields follow
    its weight's spec (an int8 leaf's per-output-channel scale drops the
    contracted axis). Half-split int4 leaves are taken only where neither
    tp nor pp cuts them (elsewhere the engine refuses first)."""
    if isinstance(leaf, QuantizedTensorOutlier):
        return _cut_outlier(leaf, spec, shape, index, device)
    if isinstance(leaf, QuantizedTensor):
        return QuantizedTensor(
            q=_to(_cut(leaf.q, spec, shape, index), device),
            scale=_to(_cut(leaf.scale, (*spec[:-2], spec[-1]), shape, index),
                      device))
    if isinstance(leaf, QuantizedTensor4Split):
        if any(n is not None and shape[n] > 1 for n in spec):
            raise ValueError(
                f"a half-split int4 weight cannot be cut by {spec} under "
                f"{shape}")
        return dataclasses.replace(
            leaf, q=_to(leaf.q, device), scale_lo=_to(leaf.scale_lo, device),
            scale_hi=_to(leaf.scale_hi, device))
    return _to(_cut(leaf, spec, shape, index), device, dtype)


class RankParams(dict):
    """A rank's slice of a parameter tree, with the mesh shape and the
    coordinate it was cut for: cutting it again for the same rank returns
    it as it is, for another rank or mesh raises."""

    def __init__(self, tree, shape, index, use_pp):
        super().__init__(tree)
        self.cut_for = (dict(shape), dict(index), bool(use_pp))


def shard_params(params: Dict[str, Any], mesh, use_pp: bool = False,
                 dtype=None) -> Dict[str, Any]:
    """This rank's slice of a parameter tree (a :class:`RankParams`), each
    tensor cut on the host (numpy arrays, host tensors or views of a mapped
    checkpoint) and only then copied to ``mesh.device`` (as ``dtype`` when
    given, quantized leaves keeping theirs). A tree already cut for this
    rank is returned as it is."""
    shape = mesh.shape
    index = {n: mesh.index(n) for n in shape}
    if isinstance(params, RankParams):
        if params.cut_for != (shape, index, bool(use_pp)):
            raise ValueError(
                f"these parameters are the slice cut for {params.cut_for}, "
                f"not for this rank {(shape, index, bool(use_pp))}")
        return params
    specs = param_pspecs(params, use_pp)

    def go(tree, spec_tree):
        if isinstance(tree, dict):
            return {k: go(v, spec_tree[k]) for k, v in tree.items()}
        return shard_tensor(tree, spec_tree, shape, index, mesh.device, dtype)

    return RankParams(go(params, specs), shape, index, use_pp)


def validate_tp(cfg: ModelConfig, tp: int, sp: int = 1, ep: int = 1) -> None:
    """Fail fast on invalid degree combinations (divisibility constraints),
    in the JAX package's words."""
    if cfg.num_kv_heads % tp != 0:
        raise ValueError(
            f"tp={tp} must divide num_kv_heads={cfg.num_kv_heads} "
            "(KV heads are sharded over tp)"
        )
    if cfg.intermediate_size % tp != 0:
        raise ValueError(
            f"tp={tp} must divide intermediate_size={cfg.intermediate_size}"
        )
    if cfg.vocab_size % tp != 0:
        raise ValueError(f"tp={tp} must divide vocab_size={cfg.vocab_size}")
    if sp > 1 and cfg.num_heads % sp != 0:
        raise ValueError(
            f"sp={sp} must divide num_heads={cfg.num_heads} (ring attention "
            "all-to-alls heads across sp)"
        )
    if ep > 1:
        if cfg.num_experts == 0:
            raise ValueError(f"ep={ep} requires an MoE model (num_experts > 0)")
        if cfg.num_experts % ep != 0:
            raise ValueError(
                f"ep={ep} must divide num_experts={cfg.num_experts}"
            )
