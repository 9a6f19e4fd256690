"""Llama-family decoder stack as plain functions on tensors (counterpart of
the JAX package's ``models/llama.py``: per-head attention or the absorbed
latent (MLA) attention of DeepSeek-V2, with the SwiGLU MLP or Mixtral's MoE
MLP).

Parameters are a plain dict of tensors with every decoder layer's weights
STACKED on a leading layer axis, as in the JAX package:
``embed [V, H]``, ``layers.{attn_norm, wq, wk, wv, wo, mlp_norm, wg, wu, wd
[, bq, bk, bv, bo]} [L, ...]``, ``final_norm [H]``, optional ``lm_head
[H, V]``; an MoE config (``num_experts > 0``) has ``router [L, H, E]``,
``we_g``/``we_u [L, E, H, F]`` and ``we_d [L, E, F, H]`` in place of ``wg``,
``wu``, ``wd`` (``ops/moe.py``); a latent config (``cfg.use_latent``) has ``wq [L,
H, Hq * (dn + dr)]``, ``wkv_a [L, H, rank + dr]``, ``kv_norm [L, rank]``,
``wk_b [L, rank, Hq, dn]`` and ``wv_b [L, rank, Hq, D]`` in place of
``wq``, ``wk``, ``wv`` (``_latent_attention``).
All projections are stored ``[in_features, out_features]``; the forward runs
each through ``ops/quant.py:matmul`` (the experts through
``ops/quant.py:einsum``), so a projection may also be a quantized leaf
(``QuantizedTensor`` int8, ``QuantizedTensor4Split`` int4; expert stacks
stay int8).
``block_apply`` walks the layer axis in a Python loop (the JAX package scans
it) and hands each layer its own slice of the cache's planes (a page pool,
or dense per-row buffers), which the cache updates in place, and of each
weight — except half-split int4 stacks, which every layer receives whole
with its layer index, so that the int4 kernel reads the layer in place.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.attention import gqa_attention
from ..ops.moe import moe_mlp
from ..ops.norms import rms_norm
from ..ops.quant import (
    QuantizedTensor,
    QuantizedTensor4Split,
    QuantizedTensor4SplitView,
)
from ..ops.quant import matmul as qmatmul
from ..ops.rotary import RopeAngles, apply_rope, rope_cos_sin, rope_inv_freq
from ..utils.device import resolve_device

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _normal_stack(gen, num_layers, shape, dtype, device):
    """``[num_layers, *shape]`` normal(0, 0.02) weights, drawn one layer at a
    time in f32 so the temporary stays one layer large."""
    out = torch.empty((num_layers, *shape), dtype=dtype, device=device)
    for i in range(num_layers):
        out[i] = torch.randn(
            shape, generator=gen, dtype=torch.float32, device=device
        ) * 0.02
    return out


def init_layer_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator],
    num_layers: int,
    dtype=torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """Random (normal 0.02) stacked parameters for ``num_layers`` layers."""
    dev = resolve_device(device)
    gen = generator if generator is not None else _default_generator(dev)
    h, d = cfg.hidden_size, cfg.head_dim
    hq, hkv, inter = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size

    def w(*shape):
        return _normal_stack(gen, num_layers, shape, dtype, dev)

    if cfg.use_latent:
        # The MLA set; see _latent_attention for how each is used.
        lat = cfg.latent
        dn, dr = lat.nope_head_dim or d, lat.rope_head_dim
        p = {
            "attn_norm": torch.ones((num_layers, h), dtype=dtype, device=dev),
            "wq": w(h, hq * (dn + dr)),
            "wkv_a": w(h, lat.rank + dr),
            "kv_norm": torch.ones((num_layers, lat.rank), dtype=dtype,
                                  device=dev),
            "wk_b": w(lat.rank, hq, dn),
            "wv_b": w(lat.rank, hq, d),
            "wo": w(hq * d, h),
            "mlp_norm": torch.ones((num_layers, h), dtype=dtype, device=dev),
        }
    else:
        p = {
            "attn_norm": torch.ones((num_layers, h), dtype=dtype, device=dev),
            "wq": w(h, hq * d),
            "wk": w(h, hkv * d),
            "wv": w(h, hkv * d),
            "wo": w(hq * d, h),
            "mlp_norm": torch.ones((num_layers, h), dtype=dtype, device=dev),
        }
    if cfg.num_experts > 0:
        e = cfg.num_experts
        p["router"] = w(h, e)
        p["we_g"] = w(e, h, inter)
        p["we_u"] = w(e, h, inter)
        p["we_d"] = w(e, inter, h)
    else:
        p["wg"] = w(h, inter)
        p["wu"] = w(h, inter)
        p["wd"] = w(inter, h)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((num_layers, hq * d), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((num_layers, hkv * d), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((num_layers, hkv * d), dtype=dtype, device=dev)
    return p


def _default_generator(dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(0)


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    dtype=torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """Full-model parameters (embedding + stacked layers + head), drawn from
    ``generator`` (a ``torch.Generator`` on ``device``; seed 0 when None)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else _default_generator(dev)
    params: Params = {
        "embed": _normal_stack(
            gen, 1, (cfg.vocab_size, cfg.hidden_size), dtype, dev
        )[0],
        "layers": init_layer_params(cfg, gen, cfg.num_layers, dtype, dev),
        "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _normal_stack(
            gen, 1, (cfg.hidden_size, cfg.vocab_size), dtype, dev
        )[0]
    return params


def _numpy_to_torch(a) -> torch.Tensor:
    """A numpy array as a tensor of the same type; numpy's bfloat16 (an
    extension type) goes over by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _field(leaf, name, default=None):
    if isinstance(leaf, Mapping):
        return leaf.get(name, default)
    return getattr(leaf, name, default)


def params_from_numpy(
    cfg: ModelConfig,
    tree: Mapping[str, Any],
    dtype=torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """The port's parameters from the JAX package's parameter tree given as
    numpy arrays (same keys, same ``[in, out]`` layout, layers stacked
    ``[L, ...]``): a straight copy onto ``device`` in ``dtype``.

    Quantized leaves (the JAX package's ``QuantizedTensor`` and
    ``QuantizedTensor4Split`` with numpy fields, or mappings of the same
    fields: ``{q, scale}``, ``{q, scale_lo, scale_hi, in_dim, out_dim}``)
    become the port's classes and keep their own dtypes: int8 values stay
    int8, scales keep theirs."""
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, Mapping) or hasattr(a, "q"):
            q = _numpy_to_torch(_field(a, "q")).to(dev)
            if _field(a, "scale_lo") is not None:
                return QuantizedTensor4Split(
                    q=q,
                    scale_lo=_numpy_to_torch(_field(a, "scale_lo")).to(dev),
                    scale_hi=_numpy_to_torch(_field(a, "scale_hi")).to(dev),
                    in_dim=int(_field(a, "in_dim")),
                    out_dim=int(_field(a, "out_dim")),
                )
            return QuantizedTensor(
                q=q, scale=_numpy_to_torch(_field(a, "scale")).to(dev)
            )
        return _numpy_to_torch(a).to(device=dev, dtype=dtype)

    want = {"attn_norm", "wq", "wo", "mlp_norm"} | (
        {"wkv_a", "kv_norm", "wk_b", "wv_b"} if cfg.use_latent
        else {"wk", "wv"}
    ) | (
        {"router", "we_g", "we_u", "we_d"} if cfg.num_experts > 0
        else {"wg", "wu", "wd"}
    )
    layers = {k: conv(v) for k, v in tree["layers"].items()}
    missing = want - set(layers)
    if missing:
        raise ValueError(f"parameter tree lacks layer weights {sorted(missing)}")
    extra = set(layers) - want - {"bq", "bk", "bv", "bo"}
    if extra:
        raise ValueError(
            f"layer weights {sorted(extra)} do not belong to this config "
            f"(num_experts={cfg.num_experts}, latent={cfg.use_latent})"
        )
    if layers["wq"].shape[0] != cfg.num_layers:
        raise ValueError(
            f"tree has {layers['wq'].shape[0]} layers, config {cfg.num_layers}"
        )
    params: Params = {
        "embed": conv(tree["embed"]),
        "layers": layers,
        "final_norm": conv(tree["final_norm"]),
    }
    if tree.get("lm_head") is not None:
        params["lm_head"] = conv(tree["lm_head"])
    return params


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

# HF per-layer key suffix -> (our name, stored [out, in] and transposed).
_LAYER_KEY_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.o_proj.bias": ("bo", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("wg", True),
    "mlp.up_proj.weight": ("wu", True),
    "mlp.down_proj.weight": ("wd", True),
}
# Mixtral's per-expert linears (HF ``block_sparse_moe.experts.{e}.{w}``,
# each [out, in]) -> our expert stack.
_EXPERT_KEY_MAP = {"w1": "we_g", "w3": "we_u", "w2": "we_d"}
_MOE_PREFIX = "block_sparse_moe."
# DeepSeek-V2's latent (MLA) keys: the joint kv_b_proj, [Hq * (dn + D),
# rank], splits into wk_b and wv_b ``[rank, Hq, dn]`` / ``[rank, Hq, D]``.
_KV_B = "self_attn.kv_b_proj.weight"
_KV_A = "self_attn.kv_a_proj_with_mqa.weight"
_KV_NORM = "self_attn.kv_a_layernorm.weight"


def _latent_sources(cfg: ModelConfig, state: Mapping[str, Any], prefix: str):
    """A latent layer's MLA tensors, as the JAX conversion takes them (only
    with ``cfg.use_latent`` and a ``kv_b_proj`` present)."""
    if not (cfg.use_latent and prefix + _KV_B in state):
        return []
    lat = cfg.latent
    dn = lat.nope_head_dim or cfg.head_dim
    kvb = state[prefix + _KV_B].T.reshape(lat.rank, cfg.num_heads,
                                          dn + cfg.head_dim)
    out = [("wk_b", None, kvb[..., :dn], False),
           ("wv_b", None, kvb[..., dn:], False)]
    if prefix + _KV_A in state:
        out.append(("wkv_a", None, state[prefix + _KV_A], True))
    if prefix + _KV_NORM in state:
        out.append(("kv_norm", None, state[prefix + _KV_NORM], False))
    return out


def _layer_sources(cfg: ModelConfig, state: Mapping[str, Any], prefix: str):
    """One HF layer's tensors present in ``state``, as ``(our name, expert
    index or None, HF tensor, transposed)``; a latent layer's MLA tensors
    (``_latent_sources``), Mixtral's router (``gate``, ``[E, H]``) and
    experts (``w1``/``w3``/``w2``, expert by expert) included when ``cfg``
    has them, as the JAX conversion takes them."""
    out = [
        (name, None, state[prefix + suffix], transpose)
        for suffix, (name, transpose) in _LAYER_KEY_MAP.items()
        if prefix + suffix in state
    ] + _latent_sources(cfg, state, prefix)
    gate = prefix + _MOE_PREFIX + "gate.weight"
    if gate in state and cfg.num_experts > 0:
        out.append(("router", None, state[gate], True))
        for w, name in _EXPERT_KEY_MAP.items():
            for e in range(cfg.num_experts):
                key = f"{prefix}{_MOE_PREFIX}experts.{e}.{w}.weight"
                out.append((name, e, state[key], True))
    elif any(k.startswith(prefix + _MOE_PREFIX) for k in state):
        raise ValueError(
            f"{prefix}{_MOE_PREFIX}* holds MoE weights but the config has "
            f"num_experts={cfg.num_experts}"
        )
    return out


def _fill(dst: torch.Tensor, src: torch.Tensor, transpose: bool) -> None:
    """Copy ``src`` (host, the checkpoint's dtype) into ``dst`` (a slot of
    a stack on the device, its dtype), transposed on the device."""
    w = src.to(dst.device)
    dst.copy_(w.T if transpose else w)


def _on_device(src: torch.Tensor, transpose: bool, dtype, dev) -> torch.Tensor:
    """``src`` (host, the checkpoint's dtype) as a new contiguous tensor of
    ``dtype`` on ``dev``, transposed first when asked."""
    shape = tuple(src.shape[::-1]) if transpose else tuple(src.shape)
    out = torch.empty(shape, dtype=dtype, device=dev)
    _fill(out, src, transpose)
    return out


def _allocate(sources, num_layers, num_experts, dtype, dev) -> Params:
    """Empty stacks ``[L, ([E,]) *shape]`` for ``_layer_sources``."""
    out: Params = {}
    for name, e, src, transpose in sources:
        if name in out:
            continue
        shape = tuple(src.shape[::-1]) if transpose else tuple(src.shape)
        if e is not None:
            shape = (num_experts, *shape)
        out[name] = torch.empty((num_layers, *shape), dtype=dtype, device=dev)
    return out


def convert_hf_layer(
    cfg: ModelConfig,
    state: Mapping[str, torch.Tensor],
    layer_idx: int,
    dtype=torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """One HF decoder layer's tensors (``state`` maps full HF keys,
    ``model.layers.{i}.…``, to host tensors in torch's ``[out, in]`` linear
    layout) in our naming and ``[in, out]`` layout, on ``device``; a
    Mixtral layer's experts stacked ``[E, in, out]``."""
    stacks = convert_hf_state_dict(cfg, state, [layer_idx], dtype, device)
    return {name: w[0] for name, w in stacks["layers"].items()}


def convert_hf_state_dict(
    cfg: ModelConfig,
    state: Mapping[str, torch.Tensor],
    layer_ids: Optional[Sequence[int]] = None,
    dtype=torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """An HF Llama/Mistral/Qwen2/Mixtral/DeepSeek-V2 state dict as our
    parameters:
    layers ``layer_ids`` (all, with the embedding, final norm and head,
    when None) stacked ``[L, ...]`` on ``device`` (Mixtral's experts
    ``[L, E, in, out]``).

    Each stack is allocated once on ``device`` and each (layer[, expert])
    matrix is copied into its slot, transposed there: beyond the result the
    device holds one matrix and the host one tensor at a time; the JAX
    package stacks numpy copies instead."""
    dev = resolve_device(device)
    ids = list(layer_ids) if layer_ids is not None else list(
        range(cfg.num_layers)
    )
    stacks: Params = {}
    for j, i in enumerate(ids):
        sources = _layer_sources(cfg, state, f"model.layers.{i}.")
        names = {name for name, *_ in sources}
        if j == 0:
            stacks = _allocate(sources, len(ids), cfg.num_experts, dtype, dev)
        elif names != set(stacks):
            raise KeyError(
                f"layer {i} has {sorted(names)}, layer {ids[0]} {sorted(stacks)}"
            )
        for name, e, src, transpose in sources:
            slot = stacks[name][j]
            _fill(slot if e is None else slot[e], src, transpose)
    params: Params = {"layers": stacks}
    if layer_ids is None:
        params.update(convert_hf_non_layer(cfg, state, dtype, dev))
    return params


def convert_hf_non_layer(
    cfg: ModelConfig,
    state: Mapping[str, torch.Tensor],
    dtype=torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """The client-side tensors: embedding, final norm and (unless tied to the
    embedding) the head, on ``device``."""
    dev = resolve_device(device)
    params: Params = {
        "embed": _on_device(
            state["model.embed_tokens.weight"], False, dtype, dev
        ),
        "final_norm": _on_device(state["model.norm.weight"], False, dtype, dev),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in state:
        params["lm_head"] = _on_device(state["lm_head.weight"], True, dtype, dev)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _decoder_layer(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    layer_state: Tuple[torch.Tensor, ...],
    cache,
    rope: RopeAngles,
    q_pos: torch.Tensor,
    num_new: torch.Tensor,
    attention_fn=gqa_attention,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One decoder layer: pre-norm attention (per-head, or latent) +
    pre-norm SwiGLU (or MoE) MLP."""
    b, s, _ = x.shape
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    if cfg.use_latent:
        attn_flat, new_state = _latent_attention(
            cfg, p, h, layer_state, cache, rope, q_pos, num_new, attention_fn
        )
        o = qmatmul(attn_flat, p["wo"])
        if "bo" in p:
            o = o + p["bo"]
        return _mlp_residual(cfg, p, x + o, s, num_new), new_state
    q = qmatmul(h, p["wq"])
    k = qmatmul(h, p["wk"])
    v = qmatmul(h, p["wv"])
    # Biases applied iff the checkpoint carries them (HF `attention_bias`).
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, hq, d)
    k = k.reshape(b, s, hkv, d)
    v = v.reshape(b, s, hkv, d)

    attn, new_state = cache.attend(
        layer_state, q, k, v, rope, q_pos, num_new,
        cfg.sliding_window, attention_fn, d**-0.5,
    )
    o = qmatmul(attn.reshape(b, s, hq * d), p["wo"])
    if "bo" in p:
        o = o + p["bo"]
    x = x + o
    return _mlp_residual(cfg, p, x, s, num_new), new_state


def _mlp_residual(cfg, p, x, s, num_new):
    """Pre-norm MLP + residual: SwiGLU, or the MoE MLP when the config has
    experts."""
    h2 = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    if cfg.num_experts > 0:
        # Bucket-padding positions (>= num_new) must not consume expert
        # capacity in the dispatched prefill path.
        valid = None
        if s > 1:
            valid = (
                torch.arange(s, device=x.device)[None, :] < num_new[:, None]
            )
        return x + moe_mlp(cfg, p, h2, valid=valid)
    return x + qmatmul(
        F.silu(qmatmul(h2, p["wg"])) * qmatmul(h2, p["wu"]), p["wd"]
    )


def _latent_attention(
    cfg: ModelConfig,
    p: Params,
    h: torch.Tensor,
    layer_state: Tuple[torch.Tensor, ...],
    cache,
    rope: RopeAngles,
    q_pos: torch.Tensor,
    num_new: torch.Tensor,
    attention_fn=gqa_attention,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Absorbed-MLA attention over the latent cache (the JAX package's
    ``_latent_attention``).

    The cache stores one fused ``[c ; k_rope]`` latent a token. The key
    up-projection is absorbed into the query (``q_nope . (w_uk c) =
    (q_nope w_uk) . c``), so the query handed to the cache is ``[q_nope @
    wk_b[h] ; q_rope]`` and K is the latent itself (one kv head for all
    ``Hq`` heads); the value up-projection is deferred past the softmax
    (``sum_j p_j w_uv c_j = w_uv sum_j p_j c_j``). Rope is applied here, to
    the rope slices only (``rope`` is built for ``rope_head_dim``,
    :func:`_rope_dim`); the cache rotates nothing. The scale is ``(dn +
    dr)**-0.5``, the un-absorbed per-head query width. ``wk_b`` and
    ``wv_b`` are plain ``torch.einsum`` products, as the JAX package leaves
    them to XLA."""
    lat = cfg.latent
    b, s, _ = h.shape
    hq, d = cfg.num_heads, cfg.head_dim
    dn = lat.nope_head_dim or d
    dr = lat.rope_head_dim
    rank = lat.rank

    q = qmatmul(h, p["wq"]).reshape(b, s, hq, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv = qmatmul(h, p["wkv_a"])  # [B, S, rank + dr]
    c = rms_norm(ckv[..., :rank], p["kv_norm"], cfg.rms_norm_eps)
    k_rope = apply_rope(ckv[..., rank:][:, :, None, :], rope.cos, rope.sin)
    q_rope = apply_rope(q_rope, rope.cos, rope.sin)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, p["wk_b"])
    q_eff = torch.cat([q_lat, q_rope], dim=-1)  # [B, S, Hq, rank + dr]
    # [B, S, 1, rank + dr]: the stored form the cache writes as it is
    kv = torch.cat([c[:, :, None, :], k_rope], dim=-1)
    attn, new_state = cache.attend(
        layer_state, q_eff, kv, kv, rope, q_pos, num_new,
        None, attention_fn, (dn + dr) ** -0.5,
    )
    o = torch.einsum("bshr,rhd->bshd", attn[..., :rank], p["wv_b"])
    return o.reshape(b, s, hq * d), new_state


def _rope_dim(cfg: ModelConfig) -> int:
    """Rotary table width: the decoupled rope key's under latent (MLA)
    attention, where only that slice is rotated; else the head dim."""
    return cfg.latent.rope_head_dim if cfg.use_latent else cfg.head_dim


def int4_projections(cfg: ModelConfig) -> Tuple[str, ...]:
    """The layer weights that int4 quantization (``quantize_params(bits=4)``)
    puts in the half-split layout: seven projections a layer, four for an
    MoE config, whose expert stacks stay int8."""
    attn = ("wq", "wk", "wv", "wo")
    return attn if cfg.num_experts > 0 else attn + ("wg", "wu", "wd")


def _split_int4_stacks(layer_params: Params):
    """Partition the layer dict: half-split int4 stacks (the
    :func:`int4_projections`) are handed to every layer WHOLE (their kernel
    takes a layer index); everything else, int8 expert stacks included, is
    sliced per layer."""
    whole = {
        k: v for k, v in layer_params.items()
        if isinstance(v, QuantizedTensor4Split)
    }
    sliced = {k: v for k, v in layer_params.items() if k not in whole}
    return whole, sliced


def _int4_views(whole: Params, idx: int) -> Params:
    return {
        k: QuantizedTensor4SplitView(
            v.q, v.scale_lo, v.scale_hi, idx, v.in_dim, v.out_dim
        )
        for k, v in whole.items()
    }


def block_apply(
    cfg: ModelConfig,
    layer_params: Params,
    x: torch.Tensor,
    cache,
    num_new: torch.Tensor,
    attention_fn=gqa_attention,
):
    """Run a block of decoder layers over hidden states: hidden states in,
    hidden states out. ``cache`` holds stacked per-layer pools with leading
    dim equal to this block's layer count; layer ``i`` gets the views
    ``stack[i]`` and writes its new k/v into them in place.

    Returns ``(x, cache)`` — the same cache object, lengths NOT advanced
    (call ``cache.advance(num_new)`` after the last block of the model so
    that several blocks of one pipeline see consistent write offsets).
    """
    inv_freq = rope_inv_freq(
        _rope_dim(cfg), cfg.rope_theta, cfg.rope_scaling, device=x.device
    )
    q_pos = cache.q_positions(x.shape[1])
    rot_pos = cache.rope_positions(x.shape[1], num_new)
    cos, sin = rope_cos_sin(rot_pos, inv_freq)
    rope = RopeAngles(inv_freq, cos, sin)

    stacks = cache.layer_stacks  # tuple of [L, ...] tensors
    whole_w, sliced_w = _split_int4_stacks(layer_params)
    for i in range(stacks[0].shape[0]):
        p = {name: w[i] for name, w in sliced_w.items()}
        p.update(_int4_views(whole_w, i))
        layer_state = tuple(stack[i] for stack in stacks)
        x, _ = _decoder_layer(
            cfg, p, x, layer_state, cache, rope, q_pos, num_new, attention_fn
        )
    return x, cache


def model_apply(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    cache,
    num_new: torch.Tensor,
    attention_fn=gqa_attention,
    head: str = "all",
):
    """Full model forward: embed → layers → final norm → logits.

    Returns ``(logits, cache)`` with the cache advanced by ``num_new``.
    ``head``: "all" computes logits at every position (``[B, S, V]``);
    "last" only at each row's final valid position ``max(num_new - 1, 0)``
    (``[B, 1, V]`` — a prefill only samples there; a row with
    ``num_new == 0`` still yields a token's worth of logits, which callers
    discard); "none" skips the head (chunked-prefill interiors), returning
    ``None`` logits.
    """
    x = F.embedding(tokens.long(), params["embed"])
    x, cache = block_apply(
        cfg, params["layers"], x, cache, num_new, attention_fn
    )
    if head == "none":
        return None, cache.advance(num_new)
    if head == "last":
        idx = (num_new - 1).clamp_min(0).long()[:, None, None]
        x = torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1]))
    logits = apply_head(cfg, params, x)
    return logits, cache.advance(num_new)


def apply_head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + lm_head (tied to the embedding when absent): ``[..., H]``
    hidden states → fp32 logits ``[..., V]``."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return qmatmul(x, head).float()


# ---------------------------------------------------------------------------
# Fused K-step decode with a write-behind KV tail
# ---------------------------------------------------------------------------


class _TailView:
    """Cache stand-in handed to ``_decoder_layer`` inside a fused window:
    its layer state is the cache's read-only big planes followed by the
    tail planes; ``attend`` splits them and delegates to the cache's
    ``tail_attend``, which updates the tail in place."""

    def __init__(self, cache, base_len, tail_len, step_idx, num_big):
        self.cache = cache
        self.base_len = base_len
        self.tail_len = tail_len
        self.step_idx = step_idx
        self.num_big = num_big

    def q_positions(self, seq_len):
        return (self.base_len + self.tail_len)[:, None]

    def rope_positions(self, seq_len, num_new):
        return self.q_positions(seq_len)

    def attend(self, layer_state, q, k_new, v_new, rope, q_pos, num_new,
               sliding_window, attention_fn, scale=None):
        big = layer_state[: self.num_big]
        tail = layer_state[self.num_big:]
        out, new_tail = self.cache.tail_attend(
            big, tail, q, k_new, v_new, rope, self.base_len, self.tail_len,
            self.step_idx, num_new, sliding_window, scale,
        )
        return out, (*big, *new_tail)


class DecodeWindow:
    """The device state of one fused K-step decode window over ``cache``,
    all of it updated in place: the next input tokens ``[B, 1]``, each
    row's ``num_new`` (1 while it writes, 0 once stopped) and ``tail_len``,
    the step index (one int32 on the device), the step function's state,
    the emitted tokens ``[K, B]``, the cache's tail planes and its read-only
    big planes.

    :meth:`begin` loads a window's inputs, :meth:`step` runs one token step
    (no host synchronisation, no allocation that outlives it), :meth:`end`
    flushes the tail into the cache. A window object is reused from window
    to window with the same storage, so a CUDA graph of :meth:`step`
    captured once serves every step of every later window (the engine's
    ``engine/graphs.py``). A window is tied to what fixes the cache's
    shapes, ``cache.window_anchor``: the page table of a paged pool, the
    buffers of a dense cache. A new table or a regrown buffer needs a new
    window.
    """

    def __init__(self, cache, num_steps: int, state: torch.Tensor):
        self.cache = cache
        self.num_steps = num_steps
        b = cache.lengths.shape[0]
        dev = cache.device
        self.anchor = cache.window_anchor
        self.tail = cache.tail_init(num_steps)
        self.whole_big = getattr(cache, "tail_reads_whole_big", False)
        self.whole_tail = getattr(cache, "tail_in_kernel", False)
        self.big = None
        self.tokens = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        self.num_new = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.tail_len = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.step_idx = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.state = torch.zeros_like(state)
        self.emits = torch.zeros((num_steps, b), dtype=torch.int32, device=dev)

    def begin(self, tokens, init_state, init_num_new) -> None:
        """Load a window's inputs: ``tokens`` ``[B, 1]``, the step
        function's initial state, ``init_num_new`` ``[B]``. The big planes
        are gathered here, once per window, where the cache gathers."""
        if self.cache.window_anchor is not self.anchor:
            raise RuntimeError("the cache's shapes changed under a window")
        self.tokens.copy_(tokens)
        self.state.copy_(init_state)
        self.num_new.copy_(init_num_new)
        self.tail_len.zero_()
        self.step_idx.zero_()
        for t in self.tail:
            t.zero_()
        if hasattr(self.cache, "tail_big_stacks"):
            self.big = self.cache.tail_big_stacks(out=self.big)
        else:
            self.big = self.cache.layer_stacks

    def step(self, cfg: ModelConfig, params: Params, step_fn) -> None:
        """One fused decode step. ``step_fn(i, logits, state)`` → ``(next
        tokens [B], next num_new [B] int32, state, emit [B])`` with ``i``
        the step index tensor; ``num_new`` must not increase (a stopped row
        stays stopped), so each row's tail slots stay contiguous."""
        cache = self.cache
        x = F.embedding(self.tokens.long(), params["embed"])
        view_num_big = len(self.big) + 1 if self.whole_big else len(self.big)
        view = _TailView(cache, cache.lengths, self.tail_len, self.step_idx,
                         view_num_big)
        q_pos = view.q_positions(1)
        inv_freq = rope_inv_freq(
            _rope_dim(cfg), cfg.rope_theta, cfg.rope_scaling, device=x.device
        )
        cos, sin = rope_cos_sin(q_pos, inv_freq)
        rope = RopeAngles(inv_freq, cos, sin)
        whole_w, sliced_w = _split_int4_stacks(params["layers"])
        for i in range(self.big[0].shape[0]):
            p = {name: w[i] for name, w in sliced_w.items()}
            p.update(_int4_views(whole_w, i))
            if self.whole_big:
                big_state = (*self.big, i)
            else:
                big_state = tuple(b[i] for b in self.big)
            if self.whole_tail:
                tail_state = self.tail
            else:
                tail_state = tuple(t[i] for t in self.tail)
            x, _ = _decoder_layer(
                cfg, p, x, (*big_state, *tail_state), view, rope, q_pos,
                self.num_new,
            )
        logits = apply_head(cfg, params, x)
        nxt, num_new, state, emit = step_fn(self.step_idx, logits[:, 0],
                                            self.state)
        self.emits.index_copy_(0, self.step_idx.long(),
                               emit.to(torch.int32)[None])
        self.tail_len.add_(self.num_new)
        self.tokens.copy_(nxt.reshape(-1, 1))
        self.num_new.copy_(num_new)
        self.state.copy_(state)
        self.step_idx.add_(1)

    def end(self) -> torch.Tensor:
        """Flush the tail into the cache (its ``lengths`` advance by each
        row's ``tail_len``); returns the emitted tokens ``[K, B]``."""
        self.cache.tail_flush(self.tail, self.tail_len)
        return self.emits


def multi_decode_apply(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    cache,
    num_steps: int,
    step_fn,
    init_state: torch.Tensor,
    init_num_new: torch.Tensor,
):
    """``num_steps`` fused decode steps with a write-behind KV tail
    (counterpart of the JAX package's ``multi_decode_apply``).

    The cache's big planes stay read-only for all K steps; each step's new
    K/V land in a small tail (``tail_init``) that the attention reads as a
    second segment under one softmax (``tail_attend``), and the tail is
    merged into the cache once at the end (``tail_flush``). ``tokens``:
    ``[B, 1]`` first inputs; ``step_fn`` as in :meth:`DecodeWindow.step`.
    Returns ``(emits [K, B] int32, cache)`` with the cache flushed and
    advanced. Caches with the tail protocol: ``PagedKVCache`` with the
    kernel, ``QuantizedPagedKVCache``, ``DenseKVCache``,
    ``QuantizedDenseKVCache``, ``QuantizedSinkKVCache``."""
    win = DecodeWindow(cache, num_steps, init_state)
    win.begin(tokens, init_state, init_num_new)
    for _ in range(num_steps):
        win.step(cfg, params, step_fn)
    return win.end(), cache
