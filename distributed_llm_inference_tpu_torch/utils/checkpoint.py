"""Checkpoint loading from a local HF snapshot directory (counterpart of the
JAX package's ``utils/checkpoint.py``).

* Index discovery over the same four layouts: safetensors index, single
  ``model.safetensors``, torch ``.bin`` index, single ``.bin``.
* ``weight_map`` prefix filtering: a block of layers opens only the shard
  files that hold them.
* Safetensors files are read by the port's own reader
  (:mod:`.streader`: one ``mmap`` a file, tensors as views of it), ``.bin``
  files by ``torch.load(..., weights_only=True)``.
* Conversion (``models/llama.py:convert_hf_state_dict``) allocates each
  stacked ``[L, in, out]`` tensor once on the target device and copies each
  layer's tensor, transposed there, into its slot: the host holds no more
  than the mapped files' pages and one tensor at a time.
* An optional on-disk cache of converted parameters (``cache_dir``), keyed
  by the checkpoint files' identities, the layer span and the dtype. Its
  entries carry the port's own layout tag, so the JAX package's and the
  port's caches never read each other's entries.

Paths are local directories; a ``resolve`` callable maps a file name to its
path. Fetching a checkpoint over HTTP (the JAX package's ``utils/hub.py``)
is left out of the port.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import torch

from ..config import ModelConfig
from ..models import llama
from .device import resolve_device
from .streader import SafetensorsFile, save_file

__all__ = [
    "find_index",
    "block_state_dict",
    "load_block_params",
    "load_model_params",
    "load_client_params",
    "load_config",
    "save_safetensors",
    "shard_put",
]

INDEX_FILE_PATTERNS = (
    "model.safetensors.index.json",
    "model.safetensors",
    "pytorch_model.bin.index.json",
    "pytorch_model.bin",
)

_NON_LAYER_KEYS = (
    "model.embed_tokens.weight",
    "model.norm.weight",
    "lm_head.weight",
)

# The cache entries' layout tag (the JAX package writes "v1" entries of its
# own layout under other names).
_CACHE_LAYOUT = "torch-v1"

Device = Union[str, torch.device]


def _default_resolve(model_dir: str) -> Callable[[str], Optional[str]]:
    if model_dir.startswith(("http://", "https://")):
        raise NotImplementedError(
            f"{model_dir!r}: fetching a checkpoint over HTTP (the JAX "
            "package's utils/hub.py) is left out of the port; download it "
            "and pass the local directory"
        )

    def resolve(name: str) -> Optional[str]:
        path = os.path.join(model_dir, name)
        return path if os.path.exists(path) else None

    return resolve


def find_index(resolve: Callable[[str], Optional[str]]) -> str:
    """First existing checkpoint entry file, in :data:`INDEX_FILE_PATTERNS`
    order."""
    for pattern in INDEX_FILE_PATTERNS:
        path = resolve(pattern)
        if path is not None:
            return path
    raise FileNotFoundError(
        f"no checkpoint index/weights found (tried {INDEX_FILE_PATTERNS})"
    )


def _read_tensors(path: str, wanted: Callable[[str], bool]):
    if path.endswith(".safetensors"):
        f = SafetensorsFile(path)
        return {k: f.get(k) for k in f.keys() if wanted(k)}
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in state.items() if wanted(k)}


def _state_views(
    model_dir: str,
    layer_ids: Optional[Sequence[int]],
    include_non_layer: bool,
    resolve: Optional[Callable[[str], Optional[str]]],
) -> Dict[str, torch.Tensor]:
    """The wanted HF-keyed tensors, reading only the shard files that hold
    them: views of the mapped safetensors files (valid while the files stay
    as they are), or the tensors of a loaded ``.bin`` file."""
    resolve = resolve or _default_resolve(model_dir)
    entry = find_index(resolve)

    prefixes = None
    if layer_ids is not None:
        prefixes = tuple(f"model.layers.{i}." for i in layer_ids)

    def wanted(key: str) -> bool:
        if prefixes is None:
            return include_non_layer or key.startswith("model.layers.")
        if key.startswith(prefixes):
            return True
        return include_non_layer and key in _NON_LAYER_KEYS

    if entry.endswith(".index.json"):
        with open(entry) as f:
            index = json.load(f)
        if "weight_map" not in index:
            raise ValueError(f"{entry} has no weight_map")
        shard_files = sorted({
            shard for key, shard in index["weight_map"].items() if wanted(key)
        })
        state: Dict[str, torch.Tensor] = {}
        for shard in shard_files:
            path = resolve(shard)
            if path is None:
                raise FileNotFoundError(f"shard {shard} listed in index not found")
            state.update(_read_tensors(path, wanted))
        return state
    return _read_tensors(entry, wanted)


def block_state_dict(
    model_dir: str,
    layer_ids: Optional[Sequence[int]] = None,
    include_non_layer: bool = False,
    resolve: Optional[Callable[[str], Optional[str]]] = None,
) -> Dict[str, torch.Tensor]:
    """HF-keyed host tensors (the checkpoint's dtypes, copies of their own)
    for the given layers, reading only the shard files that contain them.

    ``layer_ids=None`` loads every layer. ``include_non_layer`` adds the
    embedding / final-norm / lm_head tensors."""
    return {
        k: v.clone()
        for k, v in _state_views(
            model_dir, layer_ids, include_non_layer, resolve
        ).items()
    }


def load_block_params(
    model_dir: str,
    cfg: ModelConfig,
    layer_ids: Sequence[int],
    dtype=torch.bfloat16,
    resolve: Optional[Callable[[str], Optional[str]]] = None,
    cache_dir: Optional[str] = None,
    device: Device = "cuda",
) -> Dict[str, Any]:
    """Stacked layer params ``{"layers": …}`` for a block of layers, on
    ``device`` (raises when it is ``cuda`` and there is no card).

    ``cache_dir`` enables the pre-converted on-disk cache: the first load
    writes the converted tensors there, later loads of the same block read
    them back instead of the HF shards."""
    dev = resolve_device(device)

    def build():
        state = _state_views(model_dir, layer_ids, False, resolve)
        return llama.convert_hf_state_dict(cfg, state, layer_ids, dtype, dev)

    return _cached_load(
        build, model_dir, cache_dir, layer_ids, dtype, resolve, "block", dev
    )


def load_model_params(
    model_dir: str,
    cfg: ModelConfig,
    dtype=torch.bfloat16,
    resolve: Optional[Callable[[str], Optional[str]]] = None,
    cache_dir: Optional[str] = None,
    device: Device = "cuda",
) -> Dict[str, Any]:
    """Full-model params (embedding + all layers + head) on ``device``.
    ``cache_dir``: see :func:`load_block_params`."""
    dev = resolve_device(device)

    def build():
        state = _state_views(model_dir, None, True, resolve)
        return llama.convert_hf_state_dict(cfg, state, None, dtype, dev)

    return _cached_load(
        build, model_dir, cache_dir, None, dtype, resolve, "model", dev
    )


def load_client_params(
    model_dir: str,
    cfg: ModelConfig,
    dtype=torch.bfloat16,
    resolve: Optional[Callable[[str], Optional[str]]] = None,
    device: Device = "cuda",
) -> Dict[str, Any]:
    """Embedding + final-norm + lm_head ONLY, on ``device``; no decoder
    layer's shard is opened."""
    dev = resolve_device(device)
    state = _state_views(model_dir, [], True, resolve)
    return llama.convert_hf_non_layer(cfg, state, dtype, dev)


# ---------------------------------------------------------------------------
# Pre-converted on-disk cache
# ---------------------------------------------------------------------------


def _flatten_params(params: Mapping[str, Any], prefix="") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten_params(v, prefix=f"{key}."))
        else:
            out[key] = v
    return out


def _unflatten_params(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _cache_key(
    entry_path: str,
    layer_ids: Optional[Sequence[int]],
    dtype,
    tag: str,
    resolve: Callable[[str], Optional[str]],
) -> str:
    """Content key: identity (path + size + mtime) of the entry file, every
    shard it maps to, and config.json, × layer span × dtype × layout — so
    replacing any shard (or the model config) invalidates the cache even
    when the index file itself is byte-identical."""
    def ident(path: Optional[str]):
        if path is None or not os.path.exists(path):
            return None
        st = os.stat(path)
        return [os.path.abspath(path), st.st_size, int(st.st_mtime_ns)]

    files = [ident(entry_path)]
    if entry_path.endswith(".index.json"):
        with open(entry_path) as f:
            shards = sorted(set(json.load(f).get("weight_map", {}).values()))
        files += [ident(resolve(s)) for s in shards]
    files.append(ident(resolve("config.json")))
    blob = json.dumps([
        _CACHE_LAYOUT, tag, files,
        list(layer_ids) if layer_ids is not None else None,
        str(dtype),
    ])
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


def _cached_load(build, model_dir, cache_dir, layer_ids, dtype, resolve, tag,
                 dev):
    if cache_dir is None:
        return build()
    resolve = resolve or _default_resolve(model_dir)
    entry = find_index(resolve)
    key = _cache_key(entry, layer_ids, dtype, tag, resolve)
    path = os.path.join(cache_dir, f"torch-{tag}-{key}.safetensors")
    if os.path.exists(path):
        try:
            f = SafetensorsFile(path)
        except ValueError:
            pass  # corrupt/partial cache entry: rebuild below
        else:
            return _unflatten_params(
                {k: f.get(k).to(dev, copy=True) for k in f.keys()}
            )
    params = build()
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    save_file(_flatten_params(params), tmp)
    os.replace(tmp, path)  # atomic: concurrent loaders see whole files only
    return params


def save_safetensors(state: Mapping[str, torch.Tensor], path: str) -> None:
    """Write an HF-keyed state dict of tensors (any device, any strides) as
    one ``.safetensors`` file, readable by the ``safetensors`` wheel."""
    save_file(state, path)


def load_config(
    model_dir: str,
    validate: bool = True,
    resolve: Optional[Callable[[str], Optional[str]]] = None,
) -> ModelConfig:
    """``config.json`` → :class:`ModelConfig`, without transformers.

    ``validate`` checks the model family against the registry — an
    unsupported ``model_type`` fails HERE rather than silently running the
    llama program over a foreign architecture's weights."""
    resolve = resolve or _default_resolve(model_dir)
    path = resolve("config.json")
    if path is None:
        raise FileNotFoundError(f"no config.json under {model_dir!r}")
    with open(path) as f:
        cfg = ModelConfig.from_hf_config(json.load(f))
    if validate:
        from ..models import registry

        registry.validate_config(cfg)
    return cfg


def shard_put(params: Dict[str, Any], mesh, use_pp: bool = False):
    """Place loaded params onto a mesh with their TP/PP shardings: waits for
    the port's multi-GPU slice."""
    raise NotImplementedError(
        "sharded placement (shard_put) is not ported yet (ROADMAP.md queue "
        "1, item 12)"
    )
