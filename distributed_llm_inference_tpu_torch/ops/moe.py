"""Mixture-of-experts MLP, Mixtral-style (counterpart of the JAX package's
``ops/moe.py``).

Routing follows Mixtral: the router logits in f32 (an f32 product, TF32
off), softmax over ALL experts, top-k, the selected probabilities
renormalised. On exact ties the lower expert index wins, as ``lax.top_k``
picks.

Two compute strategies, as in the JAX package:

* **dense combine** (the default; decode, and prefill unless
  ``ModelConfig.moe_capacity_factor`` asks otherwise): every expert runs
  every token and a ``[B, S, E]`` combine matrix, zero off the top-k,
  weights their outputs. A decode step reads every expert's weights
  anyway. The combine matrix is built by ``scatter_`` into zeros: no op of
  the step validates its input on the host, so a fused decode step that
  holds it is captured into a CUDA graph whole.
* **sorted dispatch** (``moe_mlp_dispatch``, prefill-scale calls with
  ``moe_capacity_factor`` set): (token, expert) pairs are sorted stably by
  expert, each expert computes its capacity-bounded slice, and undoing the
  sort turns the combine into a ``[N, k]`` weighted sum.

The experts are computed by plain products (``torch.einsum``), as the JAX
package leaves them to XLA outside any Pallas kernel. int8 expert stacks
(``ops/quant.py:QuantizedTensor``, scales ``[E, out]``) are converted to
the activation type whole at every call, as the JAX package does.

Expert parallelism (the experts sharded over an ``ep`` mesh axis, the
combine then a sum across devices) waits for the port's multi-GPU slice
(``ROADMAP.md`` queue 1, item 12): these functions take no mesh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from . import quant

__all__ = ["moe_mlp", "moe_mlp_dispatch", "router_weights"]


def _f32_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """``x @ router`` in f32 with TF32 off whatever the caller set (the
    precision is read at the call, so this holds under graph capture)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return x.float() @ router.float()
    finally:
        torch.set_float32_matmul_precision(prev)


def _top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest of the last axis, in descending order, the lowest
    index first among equal values (``lax.top_k``'s order; ``torch.topk``
    leaves ties unspecified): ``k`` rounds of ``argmax``, which returns the
    first maximum."""
    vals, idx = [], []
    rest = probs
    for _ in range(k):
        i = rest.argmax(dim=-1, keepdim=True)
        vals.append(probs.gather(-1, i))
        idx.append(i)
        rest = rest.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)


def _route(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor):
    """``(top_p, top_i)``, each ``[..., k]``: the renormalised f32
    probabilities of each token's top-k experts and their indices."""
    probs = torch.softmax(_f32_logits(x, router), dim=-1)
    top_p, top_i = _top_k(probs, cfg.num_experts_per_tok)
    return top_p / top_p.sum(dim=-1, keepdim=True), top_i


def router_weights(
    cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor
) -> torch.Tensor:
    """Mixtral routing. ``x``: ``[B, S, H]``; ``router``: ``[H, E]``.
    Returns the dense f32 combine matrix ``[B, S, E]`` (sums to 1 over the
    selected experts, 0 elsewhere)."""
    top_p, top_i = _route(cfg, x, router)
    combine = torch.zeros(
        (*x.shape[:-1], cfg.num_experts), dtype=torch.float32, device=x.device
    )
    return combine.scatter_(-1, top_i, top_p)


def moe_mlp(cfg: ModelConfig, p, x: torch.Tensor, valid=None) -> torch.Tensor:
    """SwiGLU expert MLPs + weighted combine.

    ``p["router"]``: ``[H, E]``; ``p["we_g"]``/``p["we_u"]``: ``[E, H, F]``;
    ``p["we_d"]``: ``[E, F, H]`` (tensors or int8 ``QuantizedTensor``).
    The dense combine unless ``cfg.moe_capacity_factor`` is set and the
    call has S >= 16 positions, which takes :func:`moe_mlp_dispatch`;
    ``valid`` (``[B, S]`` bool) marks real tokens there, so that
    bucket-padding positions consume no expert capacity."""
    if cfg.moe_capacity_factor is not None and x.shape[1] >= 16:
        return moe_mlp_dispatch(cfg, p, x, cfg.moe_capacity_factor, valid)
    b, s, h = x.shape
    e, n = cfg.num_experts, b * s
    combine = router_weights(cfg, x, p["router"]).to(x.dtype).reshape(n, e)
    # The JAX package's "bsh,ehf->bsef" over the tokens flattened, with the
    # expert axis given to x as a broadcast batch axis: torch.einsum then
    # runs one batched product over the stacks as they lie, where the JAX
    # spec would have it copy each [E, H, F] stack into an [H, E*F] layout.
    xe = x.reshape(1, n, h).expand(e, n, h)
    t = quant.einsum("enh,ehf->nef", xe, p["we_g"])
    u = quant.einsum("enh,ehf->nef", xe, p["we_u"])
    t = F.silu(t).mul_(u)
    del u
    y = quant.einsum("nef,efh->neh", t, p["we_d"])
    return torch.einsum("ne,neh->nh", combine, y).reshape(b, s, h)


def moe_mlp_dispatch(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    capacity_factor: float = 2.0,
    valid=None,
    capacity=None,
) -> torch.Tensor:
    """Sorted (capacity-based) expert dispatch, the prefill MoE path.

    (token, expert) pairs are sorted stably by expert, each expert's ``C``
    slots gather their tokens (``C = ceil(N·k/E · capacity_factor)``, at
    most N, or ``capacity``), the expert MLPs run on ``[E, C, H]``, and the
    outputs return to pair order for a ``[N, k]`` weighted sum in f32. Pairs
    past an expert's capacity are dropped. Invalid (``valid`` False)
    tokens route to a sentinel expert ``E``, which the stable sort parks
    after every real expert's group: padding never evicts a real token.
    """
    b, s, h = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    n = b * s
    dev = x.device
    xf = x.reshape(n, h)
    top_p, top_i = _route(cfg, xf, p["router"])

    pair_e = top_i.reshape(-1)                                   # [N*k]
    pair_t = torch.arange(n, device=dev).repeat_interleave(k)   # [N*k]
    if valid is not None:
        vf = valid.reshape(-1)
        pair_e = torch.where(vf.repeat_interleave(k), pair_e, e)
        top_p = top_p * vf[:, None].to(top_p.dtype)

    order = torch.argsort(pair_e, stable=True)
    sorted_e = pair_e[order]
    sorted_t = pair_t[order]
    # e + 1 bounds so that sentinel (padding) pairs sit past every group end.
    bounds = torch.searchsorted(
        sorted_e, torch.arange(e + 1, device=dev), side="left"
    )
    group_start, group_end = bounds[:e], bounds[1:]
    expert = sorted_e.clamp(0, e - 1)
    pos_in_group = torch.arange(n * k, device=dev) - group_start[expert]

    c = capacity if capacity is not None else max(
        1, min(n, math.ceil((n * k) / e * capacity_factor))
    )
    # Slot (expert, c) holds the token at sorted position start_e + c.
    slot_pos = group_start[:, None] + torch.arange(c, device=dev)[None, :]
    slot_valid = slot_pos < group_end[:, None]
    slot_tok = sorted_t[slot_pos.clamp(0, n * k - 1)]           # [E, C]

    gathered = xf[slot_tok] * slot_valid[..., None].to(x.dtype)
    # The JAX package's "ech,ehf->ecf" with the output's expert axis second,
    # so that an int8 stack's [E, out] scale broadcasts at the end (its
    # _expert_matmul): [C, E, F], a view of the batched product's [E, C, F].
    t = quant.einsum("ech,ehf->cef", gathered, p["we_g"])
    u = quant.einsum("ech,ehf->cef", gathered, p["we_u"])
    y = quant.einsum("cef,efh->ceh", F.silu(t) * u, p["we_d"])   # [C, E, H]

    # Back to pair order (undo the sort), then a dense [N, k] combine.
    kept = pos_in_group < c
    pair_out_sorted = y[pos_in_group.clamp(0, c - 1), expert] * kept[
        :, None
    ].to(x.dtype)                                                # [N*k, H]
    inv = torch.argsort(order)
    pair_out = pair_out_sorted[inv].reshape(n, k, h)
    out = torch.einsum("nk,nkh->nh", top_p.float(), pair_out.float())
    return out.reshape(b, s, h).to(x.dtype)
