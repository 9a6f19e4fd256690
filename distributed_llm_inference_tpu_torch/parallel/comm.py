"""The collectives of one mesh axis (no JAX module of its own: they are the
port's explicit form of what GSPMD inserts and of ``lax.ppermute`` /
``lax.psum`` inside the JAX package's ``shard_map`` programs).

An :class:`Axis` is one axis of a rank's mesh (``parallel/mesh.py``): its
size, this rank's index along it, the process group of the ranks that share
every other coordinate with this one, and the backend that group runs on.
Every function here is called whatever the axis size: a size-1 axis still
runs its collective (over a group of one), so a graph captured on one card
holds the same collectives as on many.

Under ``gloo`` a CUDA tensor cannot be handed to the backend, so it is
staged through host memory by an explicit copy there and back. That copy is
a property of the backend the caller chose (``init_distributed``); nothing
here picks a backend. ``nccl`` takes CUDA tensors as they are, on the
current stream, so its collectives can be captured into a CUDA graph.

``calls`` counts the collectives issued, by kind (a captured collective
counts once, at capture).
"""

from __future__ import annotations

import collections
from typing import List, Tuple

import torch
import torch.distributed as dist

__all__ = ["Axis", "all_reduce", "all_gather", "broadcast", "exchange",
           "calls"]

calls: collections.Counter = collections.Counter()


class Axis:
    """One mesh axis as seen from this rank. ``ranks`` are the global ranks
    of the group, in axis order (``ranks[index]`` is this rank)."""

    def __init__(self, name: str, size: int, index: int, group,
                 ranks: Tuple[int, ...], backend: str):
        self.name = name
        self.size = size
        self.index = index
        self.group = group
        self.ranks = tuple(ranks)
        self.backend = backend

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through host memory (the gloo backend)."""
        return self.backend == "gloo"

    def __repr__(self) -> str:
        return (f"Axis({self.name}, size={self.size}, index={self.index}, "
                f"backend={self.backend})")


def _host(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    return t.cpu() if axis.staged and t.is_cuda else t


def all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place; returns ``t``."""
    calls["all_reduce"] += 1
    h = _host(t, axis)
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=axis.group)
    if h is not t:
        t.copy_(h)
    return t


def all_gather(t: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The pieces of ``t`` from every rank of ``axis``, concatenated along
    ``dim`` in axis order (a new tensor on ``t``'s device)."""
    calls["all_gather"] += 1
    h = _host(t, axis).contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(h) for _ in range(axis.size)]
    dist.all_gather(parts, h, group=axis.group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if out.device != t.device else out


def broadcast(t: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    """``t`` of the rank at index ``src`` of ``axis``, written into ``t`` on
    every rank; returns ``t``."""
    calls["broadcast"] += 1
    h = _host(t, axis)
    dist.broadcast(h, src=axis.ranks[src], group=axis.group)
    if h is not t:
        t.copy_(h)
    return t


def exchange(sends, recvs, axis: Axis) -> None:
    """The sends and receives of one step between ranks of ``axis`` (a
    ring's rotation, a pipeline's hop; the JAX package's ``ppermute``),
    posted together so that no order of blocking calls can deadlock:
    ``sends`` ``[(tensor, dst index)]``, ``recvs`` ``[(tensor, src
    index)]``, received into in place."""
    ops, back = [], []
    for t, dst in sends:
        calls["send"] += 1
        ops.append(dist.P2POp(dist.isend, _host(t, axis).contiguous(),
                              axis.ranks[dst], axis.group))
    for t, src in recvs:
        calls["recv"] += 1
        h = _host(t, axis)
        back.append((t, h))
        ops.append(dist.P2POp(dist.irecv, h, axis.ranks[src], axis.group))
    if not ops:
        return
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for t, h in back:
        if h is not t:
            t.copy_(h)
