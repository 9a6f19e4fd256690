"""Model-family registry (counterpart of the JAX package's
``models/registry.py``, family for family).

The decoder stack (``models/llama.py``) is one parameterized program whose
config switches cover the families; this registry maps an HF ``model_type``
to that program and each family's quirks, and validates a config against
them. It lists the same five families as the JAX package, so that a
checkpoint is ``supported`` in both or in neither, and the port's program
runs all five: the latent family (``mla``) on the paged cache only, with
bf16/f32 weights (int4/int8 weights on its layers wait: ROADMAP.md queue 1,
item 20).

* ``llama``   — the baseline (GQA, RoPE incl. llama3 scaling, SwiGLU).
* ``mistral`` — + sliding-window attention (``ModelConfig.sliding_window``).
* ``qwen2``   — + q/k/v projection biases (``qkv_bias``) and (2.5-era
  configs) tied embeddings.
* ``mixtral`` — + MoE MLP (``num_experts``/``num_experts_per_tok``,
  ``ops/moe.py``).
* ``mla``     — latent (low-rank) KV attention (``ModelConfig.latent``;
  DeepSeek-V2/V3 checkpoints, ``cache/latent.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from ..config import ModelConfig
from . import llama

__all__ = ["ModelFamily", "FAMILIES", "get_family", "validate_config"]


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    # HF `model_type` strings served by this entry.
    hf_model_types: Tuple[str, ...]
    # Capability switches the family is allowed to use.
    sliding_window: bool = False
    qkv_bias: bool = False
    moe: bool = False
    # Latent (MLA) KV attention: the family both permits AND requires
    # ``ModelConfig.latent``.
    latent: bool = False
    # The compute/conversion program (shared stack for all families).
    apply: Callable = llama.model_apply
    block_apply: Callable = llama.block_apply
    init_params: Callable = llama.init_params
    convert_state_dict: Callable = llama.convert_hf_state_dict


FAMILIES: Dict[str, ModelFamily] = {
    f.name: f
    for f in (
        ModelFamily("llama", ("llama",)),
        ModelFamily("mistral", ("mistral",), sliding_window=True),
        ModelFamily("qwen2", ("qwen2",), sliding_window=True, qkv_bias=True),
        ModelFamily("mixtral", ("mixtral",), sliding_window=True, moe=True),
        ModelFamily(
            "mla", ("mla", "deepseek_v2", "deepseek_v3"), latent=True
        ),
    )
}

_BY_HF_TYPE = {
    t: fam for fam in FAMILIES.values() for t in fam.hf_model_types
}


def get_family(name_or_cfg) -> ModelFamily:
    """Look up by family name, HF ``model_type``, or a :class:`ModelConfig`."""
    name = (
        name_or_cfg.family
        if isinstance(name_or_cfg, ModelConfig)
        else str(name_or_cfg)
    )
    fam = FAMILIES.get(name) or _BY_HF_TYPE.get(name)
    if fam is None:
        raise KeyError(
            f"unsupported model family {name!r} (supported: "
            f"{sorted(FAMILIES)})"
        )
    return fam


def validate_config(cfg: ModelConfig) -> ModelFamily:
    """Fail fast when a config uses switches its family doesn't support
    (e.g. an MoE llama config is almost certainly a conversion bug)."""
    fam = get_family(cfg)
    if cfg.sliding_window is not None and not fam.sliding_window:
        raise ValueError(
            f"family {fam.name!r} does not use sliding_window "
            f"(got {cfg.sliding_window})"
        )
    if cfg.num_experts > 0 and not fam.moe:
        raise ValueError(
            f"family {fam.name!r} is dense but config has "
            f"num_experts={cfg.num_experts}"
        )
    if cfg.qkv_bias and not fam.qkv_bias:
        raise ValueError(f"family {fam.name!r} does not use qkv_bias")
    if cfg.latent is not None and not fam.latent:
        raise ValueError(
            f"family {fam.name!r} does not use latent KV attention "
            f"(use the 'mla' family)"
        )
    if fam.latent and (cfg.latent is None or not cfg.latent.enabled):
        raise ValueError(
            f"family {fam.name!r} requires an enabled ModelConfig.latent"
        )
    return fam
