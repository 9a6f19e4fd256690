"""Sharded serving on ``torch.distributed`` (counterpart of the JAX
package's ``parallel/``): the rank mesh (``mesh.py``), the axis
collectives (``comm.py``), the sharding rules (``tp.py``), the GPipe
pipeline (``pipeline.py``) and ring attention (``ring.py``)."""

from .comm import Axis
from .mesh import RankMesh, build_mesh, init_distributed, single_device_mesh
from .pipeline import pipeline_block_apply, pipelined_model_apply
from .ring import dense_cache_from_ring, ring_gqa_attention, ring_prefill
from .tp import (
    cache_pspecs,
    layer_pspecs,
    local_cache_shape,
    local_model_config,
    param_pspecs,
    shard_params,
    validate_tp,
)

__all__ = [
    "Axis",
    "RankMesh",
    "build_mesh",
    "init_distributed",
    "single_device_mesh",
    "pipeline_block_apply",
    "pipelined_model_apply",
    "dense_cache_from_ring",
    "ring_gqa_attention",
    "ring_prefill",
    "cache_pspecs",
    "layer_pspecs",
    "local_cache_shape",
    "local_model_config",
    "param_pspecs",
    "shard_params",
    "validate_tp",
]
