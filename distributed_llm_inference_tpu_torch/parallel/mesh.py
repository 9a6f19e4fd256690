"""The rank mesh of a sharded deployment (counterpart of the JAX package's
``parallel/mesh.py``).

The JAX package lays one ``jax.sharding.Mesh`` over every chip of a slice
and lets XLA insert the collectives. The port runs SPMD as Megatron does in
PyTorch: one process a device, each holding its own shard of the weights
and of the KV pool, every one running the same scheduler over the same
submissions, the collectives explicit (``parallel/comm.py``). This module
joins a process to the job (:func:`init_distributed`, the counterpart of
``initialize_distributed``) and lays the job's ranks out as a
``torch.distributed.device_mesh.DeviceMesh`` over the axes ``("dp", "pp",
"ep", "tp", "sp")``, outer to inner, in the JAX order (:func:`build_mesh`).

Axis meaning:
    ``dp``   data parallel: batch rows, independent replicas
    ``pp``   pipeline parallel: layer-block stages (``parallel/pipeline.py``)
    ``ep``   expert parallel: MoE experts (``ops/moe.py``)
    ``tp``   tensor parallel: attention heads / MLP features
    ``sp``   sequence parallel: prompt chunks of a ring prefill
             (``parallel/ring.py``)
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..utils.device import resolve_device
from .comm import Axis

__all__ = ["RankMesh", "build_mesh", "init_distributed", "single_device_mesh"]


def init_distributed(
    backend: str,
    init_method: str,
    world_size: int,
    rank: int,
    device: Optional[Union[str, torch.device]] = None,
    timeout_s: Optional[float] = None,
) -> None:
    """Join this process to a ``torch.distributed`` job as ``rank`` of
    ``world_size``. ``backend`` is the caller's choice (``"nccl"`` on cards,
    ``"gloo"`` on the CPU or to share one card between processes): it is
    never chosen here and never switched when it fails. ``init_method`` is
    ``tcp://host:port`` or ``file://path``. ``device``, a CUDA device with
    an index, becomes this process's current device first (one rank a
    card). ``timeout_s`` bounds every collective's wait (the backend's
    default when None)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if device is not None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)


class RankMesh:
    """This rank's view of the mesh: the :class:`MeshConfig`, the device
    its shards live on, the ``DeviceMesh``, and one :class:`Axis` a mesh
    axis. ``shape`` maps axis name to size, as the JAX ``Mesh.shape`` does."""

    def __init__(self, cfg: MeshConfig, device: torch.device, device_mesh,
                 axes: Dict[str, Axis], backend: str):
        self.cfg = cfg
        self.device = device
        self.device_mesh = device_mesh
        self.axes = axes
        self.backend = backend

    @property
    def shape(self) -> Dict[str, int]:
        return {name: ax.size for name, ax in self.axes.items()}

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    def index(self, name: str) -> int:
        return self.axes[name].index

    def __repr__(self) -> str:
        coord = {n: a.index for n, a in self.axes.items()}
        return (f"RankMesh({self.cfg}, rank {dist.get_rank()} at {coord}, "
                f"{self.backend} on {self.device})")


def build_mesh(mesh_cfg: MeshConfig,
               device: Union[str, torch.device] = "cuda") -> RankMesh:
    """The ``(dp, pp, ep, tp, sp)`` mesh of :class:`MeshConfig` over the
    ranks of the current job, which must number ``mesh_cfg.num_devices``
    (:func:`init_distributed` first). Rank ``r`` sits at the row-major
    coordinate of ``r`` in ``mesh_cfg.shape``, so the innermost axes (tp,
    sp) join neighbouring ranks."""
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs a torch.distributed job: call "
            "parallel.init_distributed(backend, init_method, world_size, "
            "rank) in every rank first"
        )
    n = mesh_cfg.num_devices
    world = dist.get_world_size()
    if n != world:
        raise ValueError(
            f"mesh {mesh_cfg.shape} needs {n} ranks, the job has {world}")
    dev = resolve_device(device)
    from torch.distributed.device_mesh import init_device_mesh

    names = mesh_cfg.axis_names
    dm = init_device_mesh(dev.type, mesh_cfg.shape, mesh_dim_names=names)
    coord = dm.get_coordinate()
    backend = dist.get_backend()
    axes = {}
    for i, name in enumerate(names):
        group = dm.get_group(name)
        axes[name] = Axis(name, mesh_cfg.shape[i], coord[i], group,
                          tuple(dist.get_process_group_ranks(group)), backend)
    return RankMesh(mesh_cfg, dev, dm, axes, backend)


def single_device_mesh(
        device: Union[str, torch.device] = "cuda") -> RankMesh:
    """The all-ones mesh over a job of one rank: every sharded code path,
    collectives included, runs unchanged on one device."""
    return build_mesh(MeshConfig(), device)
