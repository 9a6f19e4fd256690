"""Pipeline parallelism: layer-block stages over the ``pp`` axis
(counterpart of the JAX package's ``parallel/pipeline.py``).

Each ``pp`` rank holds a contiguous block of the layer stack (its slice of
the stacked parameters and of the cache's layer axis, ``parallel/tp.py``)
and the batch is cut into microbatches on a GPipe schedule: ``M + S - 1``
iterations, stage ``s`` working on microbatch ``t - s`` at iteration ``t``.
Activations hop from stage to stage by send/recv on the ``pp`` group (the
JAX package's ``lax.ppermute``), posted together at the end of every
iteration; a stage sends only what its next stage will consume, so the
bubbles move nothing. The last stage alone holds the outputs and broadcasts
them over ``pp`` (the JAX package's ``psum``), so every stage runs the head
and samples the same tokens.

A rank's batch is its ``dp`` row group (``parallel/tp.py:
local_cache_shape``), so a microbatch here is the JAX ``_mb_slice`` cut of
the global batch, ``(dp, m, mbg)``, taken within one dp group. A cache's
microbatch is a row-range view of it (``row_range``), whose planes or page
table and lengths are views of the cache's: the layers write the pool in
place, and the page pools' shared planes pass through whole.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..config import ModelConfig
from ..models import llama
from ..ops.attention import gqa_attention
from . import comm

__all__ = ["pipeline_block_apply", "pipelined_model_apply"]


def pipeline_block_apply(
    cfg: ModelConfig,
    layer_params: Any,
    x: torch.Tensor,
    cache: Any,
    num_new: torch.Tensor,
    attention_fn=gqa_attention,
    mesh=None,
    num_microbatches: Optional[int] = None,
) -> Tuple[torch.Tensor, Any]:
    """Run the whole layer stack as a ``pp``-staged pipeline. Same contract
    as :func:`models.llama.block_apply` (hidden states in and out, the
    cache's planes written, lengths NOT advanced; the signature fits
    ``model_apply``'s ``block_fn``). ``layer_params`` and the cache hold
    this stage's layers; the batch must divide by the microbatch count
    (``pp`` when None)."""
    pp = mesh.axis("pp")
    stages, stage = pp.size, pp.index
    m = num_microbatches or stages
    b, s, h = x.shape
    if b % m != 0:
        raise ValueError(
            f"batch {b} not divisible by microbatches = {m} (each "
            "microbatch takes an equal row range of every dp group)"
        )
    mbg = b // m
    out = torch.zeros_like(x)
    buf = torch.empty((mbg, s, h), dtype=x.dtype, device=x.device)
    for t in range(m + stages - 1):
        idx = t - stage
        sends = []
        if 0 <= idx < m:
            r0, r1 = idx * mbg, (idx + 1) * mbg
            x_in = x[r0:r1] if stage == 0 else buf
            y, _ = llama.block_apply(
                cfg, layer_params, x_in, cache.row_range(r0, r1),
                num_new[r0:r1], attention_fn, mesh,
            )
            if stage == stages - 1:
                out[r0:r1] = y
            else:
                sends.append((y, stage + 1))
        nxt = t + 1 - stage
        recvs = [(buf, stage - 1)] if stage > 0 and 0 <= nxt < m else []
        comm.exchange(sends, recvs, pp)
    comm.broadcast(out, pp, src=stages - 1)
    return out, cache


def pipelined_model_apply(
    cfg: ModelConfig,
    params: Any,
    tokens: torch.Tensor,
    cache: Any,
    num_new: torch.Tensor,
    mesh,
    num_microbatches: Optional[int] = None,
    attention_fn=gqa_attention,
    head: str = "all",
):
    """Full forward with the layer stack pipelined: the ``pp`` form of
    :func:`models.llama.model_apply` (same returns; the cache advanced)."""

    def block_fn(cfg_, layers_, x_, cache_, num_new_, attention_fn_, mesh_):
        return pipeline_block_apply(cfg_, layers_, x_, cache_, num_new_,
                                    attention_fn_, mesh_, num_microbatches)

    return llama.model_apply(cfg, params, tokens, cache, num_new,
                             attention_fn, head=head, mesh=mesh,
                             block_fn=block_fn)
