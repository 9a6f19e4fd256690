"""Configuration dataclasses of the PyTorch/CUDA port.

Field for field the same names and defaults as the JAX package's
``distributed_llm_inference_tpu/config.py`` (``tests/test_torch_packaging.py``
holds the two together), kept as an independent copy so the port imports
nothing of the JAX package. Fields whose feature the port does not serve yet
stay as fields; ``InferenceEngine`` raises ``NotImplementedError`` for a
value that would switch such a feature on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Rotary-embedding scaling (Llama-3 style "llama3" or linear)."""

    rope_type: str = "default"  # "default" | "llama3" | "linear"
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192

    @staticmethod
    def from_hf(d: Optional[Mapping[str, Any]]) -> Optional["RopeScaling"]:
        if d is None:
            return None
        return RopeScaling(
            rope_type=d.get("rope_type", d.get("type", "default")),
            factor=float(d.get("factor", 1.0)),
            low_freq_factor=float(d.get("low_freq_factor", 1.0)),
            high_freq_factor=float(d.get("high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                d.get("original_max_position_embeddings", 8192)
            ),
        )


@dataclasses.dataclass(frozen=True)
class LatentConfig:
    """Latent (low-rank, MLA-style) KV attention: one shared ``rank``-dim
    latent per token plus a ``rope_head_dim``-dim decoupled rotary key. The
    port carries the fields only; the latent model branch is not ported."""

    enabled: bool = True
    rank: int = 64
    rope_head_dim: int = 16
    nope_head_dim: Optional[int] = None

    @property
    def lat_dim(self) -> int:
        """Stored per-token width: latent rank + decoupled rope key."""
        return self.rank + self.rope_head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a decoder-only transformer (the
    Llama family; Mistral's ``sliding_window``, Qwen2's ``qkv_bias`` and the
    MoE / latent fields ride along for the families ported later)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    # Mistral-style sliding-window attention; None = full causal.
    sliding_window: Optional[int] = None
    # Qwen2-style bias on q/k/v projections.
    qkv_bias: bool = False
    # MoE (Mixtral): 0 experts = dense MLP.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: Optional[float] = None
    # Latent (MLA-style) KV compression; None = conventional per-head K/V.
    latent: Optional[LatentConfig] = None
    # Model family tag ("llama", "mistral", "qwen2", "mixtral", "mla").
    family: str = "llama"

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def use_latent(self) -> bool:
        """The one latent predicate every consumer branches on."""
        return self.latent is not None and self.latent.enabled

    @staticmethod
    def from_hf_config(hf: Any) -> "ModelConfig":
        """Build from a ``transformers`` PretrainedConfig (or plain dict)."""
        get = (lambda k, d=None: hf.get(k, d)) if isinstance(hf, dict) else (
            lambda k, d=None: getattr(hf, k, d)
        )
        model_type = get("model_type", "llama")
        num_heads = get("num_attention_heads", 32)
        hidden = get("hidden_size", 4096)
        latent = None
        if get("kv_lora_rank", None):
            latent = LatentConfig(
                rank=int(get("kv_lora_rank")),
                rope_head_dim=int(get("qk_rope_head_dim", 64)),
                nope_head_dim=get("qk_nope_head_dim", None),
            )
            model_type = "mla"
        return ModelConfig(
            vocab_size=get("vocab_size", 32000),
            hidden_size=hidden,
            intermediate_size=get("intermediate_size", 11008),
            num_layers=get("num_hidden_layers", 32),
            num_heads=num_heads,
            num_kv_heads=get("num_key_value_heads", num_heads) or num_heads,
            head_dim=get("head_dim", None) or hidden // num_heads,
            rms_norm_eps=get("rms_norm_eps", 1e-5),
            rope_theta=get("rope_theta", 10000.0),
            rope_scaling=RopeScaling.from_hf(get("rope_scaling", None)),
            max_position_embeddings=get("max_position_embeddings", 4096),
            tie_word_embeddings=bool(get("tie_word_embeddings", False)),
            sliding_window=get("sliding_window", None),
            qkv_bias=bool(get("attention_bias", False)) or model_type in ("qwen2",),
            num_experts=get("num_local_experts", 0) or 0,
            num_experts_per_tok=get("num_experts_per_tok", 2) or 2,
            latent=latent,
            family=model_type,
        )


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh of one sharded deployment: the degrees of data
    (``dp``), pipeline (``pp``), expert (``ep``), tensor (``tp``) and
    sequence (``sp``) parallelism. The port lays it over the ranks of a
    ``torch.distributed`` job, one rank a device, in the order of
    :attr:`axis_names` (``parallel/mesh.py:build_mesh``)."""

    dp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1  # sequence/context parallel degree
    ep: int = 1  # expert parallel degree (MoE experts sharded across devices)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("dp", "pp", "ep", "tp", "sp")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.dp, self.pp, self.ep, self.tp, self.sp)

    @property
    def num_devices(self) -> int:
        return self.dp * self.pp * self.ep * self.tp * self.sp


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """KV-cache policy. The port serves ``kind="paged"``, ``kind="dense"``
    and ``kind="sink"`` (the StreamingLLM ring of ``window_length`` slots,
    ``num_sink_tokens`` of them sinks), each in the model dtype or with
    ``kv_quant="int8"``. ``prefix_caching`` (paged only) shares full prompt
    pages between sessions by content; :class:`PrefixConfig` sets its
    policy."""

    kind: str = "paged"  # "paged" | "sink" | "dense"
    kv_quant: Optional[str] = None  # None | "int8"
    max_sessions: int = 32
    page_size: int = 64
    num_pages: int = 512
    max_pages_per_session: int = 64
    prefix_caching: bool = False
    # sink-cache policy (kind == "sink")
    window_length: int = 1024
    num_sink_tokens: int = 4


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving engine policy: batching, buckets, dtypes, quantization."""

    max_batch_size: int = 8
    prefill_buckets: Tuple[int, ...] = (128, 512, 2048)
    max_seq_len: int = 4096
    max_new_tokens: int = 512
    dtype: str = "bfloat16"
    # None | "int8" | "int4" | "int8_outlier" (int8 with ``outlier_channels``
    # fp input channels a projection, chosen by ``act_scales`` when given).
    quantization: Optional[str] = None
    # Width ladder of the attended span: a paged table starts narrow and
    # gains columns, dense buffers start at the first rung and regrow, as
    # sessions lengthen. None = auto ladder; () disables.
    decode_windows: Optional[Tuple[int, ...]] = None
    # The attention kernels of the cache: decode rows of the paged pools
    # (ops/paged_attention.py), the int8 dense cache's own kernels
    # (ops/quant_attention.py), flash prefill for the model-dtype dense cache
    # (ops/flash_attention.py). None = auto: ON for the paged cache and the
    # int8 dense cache on a CUDA device, OFF on the CPU.
    use_pallas_attention: Optional[bool] = None
    # Ragged mixed-phase attention (engine/plan.py + ops/ragged_attention.py):
    # every prefill-family dispatch pads to ONE width, multi-token rows read
    # their pages in place through the ragged kernel, and long GREEDY prompts
    # chunk-admit beside live decode. None = auto: ON for the paged cache on
    # a CUDA device, OFF on the CPU.
    ragged_attention: Optional[bool] = None
    # Token width of one chunked-prefill dispatch under ragged mode. None =
    # the largest prefill bucket.
    prefill_chunk_tokens: Optional[int] = None
    # Fraction of decode ticks that may also carry a chunked-prefill
    # dispatch (credit accumulator; 1.0 = every tick, 0 = never).
    chunk_decode_share: float = 0.5
    # Tokens decoded per dispatch. None resolves as in the JAX engine: 16
    # where the cache's write-behind tail composes, else 1.
    decode_steps: Optional[int] = None
    ring_prefill_threshold: Optional[int] = None
    # Pipelined ticks and overlapped admission apply to decode_steps > 1
    # only; at 1 they are off, as in the JAX engine.
    pipelined_ticks: bool = True
    overlap_admission: bool = True
    overlap_admission_max_inflight: int = 4
    # Speculative decoding (an engine built with a draft model): proposals
    # a round, the adaptive controller's knobs, fused rounds a dispatch
    # (None: max(1, (decode_steps or 16) // (speculative_k + 1))).
    speculative_k: int = 0  # 0 = disabled
    speculative_adaptive: bool = True
    speculative_probe_below: Optional[float] = None
    speculative_probe_period: int = 48
    speculative_probe_len: int = 8
    speculative_rounds: Optional[int] = None
    # W8A8 prefill-activation quantization pins (not ported yet).
    act_quant_prefill: Optional[bool] = None
    act_quant_min_seq: Optional[int] = None
    outlier_channels: int = 32
    act_scales: Optional[Any] = dataclasses.field(
        default=None, hash=False, compare=False
    )


@dataclasses.dataclass(frozen=True)
class PrefixConfig:
    """Prefix/KV reuse policy (``prefixstore/``): copy-on-write shared
    prefix pages inside one engine, a bounded host-memory spill tier for
    evicted prefix pages, and the routing knobs of a fleet's gateways (kept
    for parity; the fleet is not ported). The engine-level layers need
    ``CacheConfig.prefix_caching`` (paged cache)."""

    # Live copy-on-write sharing: sessions register their full prompt pages
    # at ADMISSION (not just at release), so concurrent sessions sharing a
    # prefix attach to the same device pages; a session whose write offset
    # lands inside a shared page splits it copy-on-write first.
    prefix_share: bool = True
    # Host spill arena byte budget for evicted prefix pages (stored form:
    # int8 + scales or the pool's dtype). 0 disables spilling.
    spill_bytes_max: int = 0
    # Gateway backends route a request to the node advertising the longest
    # matching prefix head (falling back to least-loaded).
    route_by_prefix: bool = True
    # Minimum matched prefix TOKENS before prefix-aware routing overrides
    # the least-loaded choice.
    min_shared_tokens: int = 0


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """HTTP gateway policy (``serving/server.py``): admission control,
    per-request deadlines, and graceful drain for the OpenAI-compatible
    ``/v1/completions`` front door."""

    host: str = "0.0.0.0"
    port: int = 8000  # 0 = ephemeral (the bound port is reported after bind)
    # Admission bound: completions in flight through the gateway (waiting in
    # the engine queue + decoding). At the bound new requests get 429 with
    # a Retry-After header instead of growing an unbounded queue.
    max_queue_depth: int = 64
    retry_after_s: float = 1.0
    # Per-request deadline (seconds): the request body's "timeout_s"
    # overrides the default, capped at the max. An expired deadline cancels
    # the underlying generation (engine.cancel).
    default_timeout_s: float = 120.0
    max_timeout_s: float = 600.0
    # Cap on a request's max_tokens (an unbounded ask pins a decode slot).
    max_tokens_cap: int = 2048
    # Graceful drain (SIGTERM): stop admitting, give in-flight requests this
    # long to finish, cancel the rest, then exit.
    drain_timeout_s: float = 30.0
    # Driver-loop sleep when the engine has no work (seconds).
    idle_sleep_s: float = 0.002
    # Reported as the OpenAI "model" field in responses.
    model_name: str = "distributed-llm-inference-tpu"
    # Circuit breaker (serving/breaker.py): after this many consecutive
    # backend failures the gateway fails fast (503 + Retry-After) ...
    breaker_failure_threshold: int = 5
    # ... for this long, then admits trial traffic again (half-open) ...
    breaker_recovery_s: float = 5.0
    # ... and closes after this many consecutive trial successes.
    breaker_success_threshold: int = 1
    # Background backend health-probe period (seconds; 0 disables).
    breaker_probe_interval_s: float = 1.0
