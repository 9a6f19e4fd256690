"""AttentionPlan: one owner for dispatch shapes, phases, and kernel choice
(counterpart of the JAX package's ``engine/plan.py``).

* **Row classification & shapes.** A prompt is a PREFILL row (fits one
  dispatch), a CHUNKED-PREFILL row (walks the prompt ``chunk_tokens`` at a
  time), or a DECODE row. In ragged mode every prefill-family dispatch pads
  to ONE token width (``chunk_tokens``, default the largest bucket).
* **Partition preservation.** Ragged mode keeps the bucketed admission
  partition — group membership via :meth:`bucket_for` and the chunk cap —
  and changes only the padded dispatch widths. The engine draws one sampling
  key per admission group/single in admission order; keeping the partition
  keeps the key sequence, so ragged on/off gives the same streams for
  sampled decoding too (the noise depends on the key and row count, never on
  pad width). The port runs eagerly and compiles nothing per shape; the pad
  widths are kept because the partition and the order of key draws depend
  on them, and because they keep the port's dispatches identical to the JAX
  engine's.
* **Kernel selection.** Resolves ``use_pallas_attention`` (the decode
  kernel, ``ops/paged_attention.py``) and the ragged kernel
  (``ops/ragged_attention.py``) from one place; the paged cache reads the
  decision via its ``use_kernel``/``use_ragged`` fields. ``backend`` is the
  type of the engine's device: where the JAX plan asks for ``"tpu"`` this
  one asks for ``"cuda"``, so on the card both resolve ON for the paged
  cache and on the CPU both resolve OFF.
* **Chunk/decode co-scheduling budget.** A fractional credit accumulator
  (``chunk_decode_share``) rations how many decode ticks also carry a
  chunked-prefill dispatch, so admission of a long prompt stretches over
  ticks instead of stalling the decode batch behind one monolithic prefill.
* **Dispatch telemetry.** Every dispatch funnels through
  :meth:`note_dispatch`, which keeps the set of (kind, shape) pairs seen
  (:attr:`dispatch_shapes`; the port runs eagerly, so a new shape costs no
  compile, and the JAX package's ``attn_recompiles`` counter is here
  ``attn_dispatch_shapes``), counts
  ``attn_ragged_dispatches`` / ``attn_chunked_rows``, and publishes
  ``attn_grid_occupancy`` (valid / padded token fraction of the latest
  prefill-family dispatch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["AttentionPlan", "KernelSelection", "PREFILL", "CHUNKED", "DECODE"]

# Row phases (data, not shape: the ragged kernel serves all three in one
# grid call — see ops/ragged_attention.py).
PREFILL = "prefill"
CHUNKED = "chunked_prefill"
DECODE = "decode"


@dataclasses.dataclass(frozen=True)
class KernelSelection:
    """Resolved kernel routing for one engine instance.

    ``use_pallas``: the cache's decode kernel (``use_kernel=`` on the
    cache; the field keeps the JAX package's name).
    ``use_ragged``: paged caches serve multi-token rows through the ragged
    mixed-phase kernel instead of the contiguous ``update_and_gather`` copy.
    """

    use_pallas: bool
    use_ragged: bool


class AttentionPlan:
    """Owns dispatch-shape policy, phase classification, and kernel choice.

    ``enabled`` resolves ``EngineConfig.ragged_attention``: ``None`` means
    auto — ON for paged caches when ``backend`` is ``"cuda"`` (where the
    ragged kernel replaces the gather copy), OFF elsewhere so CPU defaults
    keep the bucketed path (tests opt in explicitly; the plan's shaping and
    co-scheduling do not depend on the backend).
    """

    def __init__(self, engine_cfg, cache_cfg, metrics=None, backend="cuda"):
        self.ecfg = engine_cfg
        self.ccfg = cache_cfg
        self.metrics = metrics
        self.backend = backend
        self.buckets: Tuple[int, ...] = tuple(engine_cfg.prefill_buckets)
        if engine_cfg.ragged_attention is not None:
            self.enabled = bool(engine_cfg.ragged_attention)
        else:
            self.enabled = (
                self.backend == "cuda" and cache_cfg.kind == "paged"
            )
        self.chunk_tokens = (
            engine_cfg.prefill_chunk_tokens
            if engine_cfg.prefill_chunk_tokens is not None
            else self.buckets[-1]
        )
        if self.chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1, got {self.chunk_tokens}"
            )
        self.share = float(engine_cfg.chunk_decode_share)
        if not 0.0 <= self.share <= 1.0:
            raise ValueError(
                f"chunk_decode_share must be in [0, 1], got {self.share}"
            )
        self._credit = 0.0
        self._shapes = set()
        # Last dispatch seen by note_dispatch, as (kind, shape, valid).
        self.last_dispatch: Optional[Tuple] = None
        # Set by the engine when the cache stores the latent (MLA) form:
        # every dispatch then reads the stored latents in place, which
        # note_dispatch counts as ``latent_decompress_dispatches``.
        self.latent = False

    # ------------------------------------------------------------------
    # Row classification / shape policy
    # ------------------------------------------------------------------
    def classify(self, new_tokens: int, total_prompt: int) -> str:
        """Phase of a dispatch serving ``new_tokens`` query rows of a
        ``total_prompt``-token prompt (1 query = decode)."""
        if new_tokens <= 1 and total_prompt > 1:
            return DECODE
        if new_tokens < total_prompt:
            return CHUNKED
        return PREFILL

    def bucket_for(self, n: int) -> int:
        """Prompt bucket — the admission-partition key, in ragged mode too
        (see module docstring: partition == sampling-key order)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def prefill_stride(self, legacy_cap: int) -> int:
        """Tokens consumed per chunk when a prompt walks in pieces. Capped
        at the bucketed path's chunk cap (``legacy_cap``) so the default
        config's chunk boundaries — hence the interior/final dispatch
        sequence — are the same with ragged mode on or off."""
        if not self.enabled:
            return legacy_cap
        return min(self.chunk_tokens, legacy_cap)

    def final_shape(self, rest: int, legacy_cap: int) -> int:
        """Pad width for the final (sampled) chunk of a single-row prefill.
        Ragged mode pads every final to the stride — ONE shape per row
        count — instead of the rest's bucket."""
        if not self.enabled:
            return self.bucket_for(rest)
        return self.prefill_stride(legacy_cap)

    def group_shape(self, bucket: int, legacy_cap: int) -> int:
        """Pad width for a batched admission group whose members share
        ``bucket``. Ragged mode pads every group to the largest width so
        all buckets share one shape per row count."""
        if not self.enabled:
            return bucket
        return max(self.prefill_stride(legacy_cap), bucket)

    # ------------------------------------------------------------------
    # Kernel selection
    # ------------------------------------------------------------------
    def select(self) -> KernelSelection:
        cc = self.ccfg
        cuda = self.backend == "cuda"
        # The kernels exist for CUDA devices only: elsewhere the plan keeps
        # the gather path (ragged SHAPES still apply — streams do not depend
        # on pad widths).
        use_ragged = self.enabled and cuda and cc.kind == "paged"
        if self.ecfg.use_pallas_attention is not None:
            use_pallas = self.ecfg.use_pallas_attention
        else:
            use_pallas = cuda and (
                (cc.kind in ("dense", "sink") and cc.kv_quant == "int8")
                or use_ragged
            )
        return KernelSelection(use_pallas=use_pallas, use_ragged=use_ragged)

    # ------------------------------------------------------------------
    # Chunk/decode co-scheduling
    # ------------------------------------------------------------------
    def co_schedule_ok(self, prompt_rest: int, temperature: float,
                       legacy_cap: int) -> bool:
        """Config-side eligibility for riding a prompt's prefill on the
        decode cadence: ragged mode on, a non-zero tick share, a prompt
        long enough to need chunking, and greedy decoding (a sampled
        session must keep its key-draw position — chunk ticks would
        move its key relative to admission order)."""
        return (
            self.enabled
            and self.share > 0.0
            and temperature == 0.0
            and prompt_rest > self.prefill_stride(legacy_cap)
        )

    def take_chunk_credit(self, decode_active: bool) -> bool:
        """True when this tick may carry a chunk dispatch. With no decode
        rows to protect the chunk streams at full speed; otherwise credits
        accrue at ``chunk_decode_share`` per tick."""
        if not decode_active:
            return True
        self._credit += self.share
        if self._credit >= 1.0:
            self._credit -= 1.0
            return True
        return False

    # ------------------------------------------------------------------
    # Dispatch telemetry
    # ------------------------------------------------------------------
    @property
    def dispatch_shapes(self) -> frozenset:
        """Every ``(kind, *shape)`` dispatched so far: kind ``"prefill"`` or
        ``"chunk"`` with (rows, token width), ``"decode"`` with (rows, 1,
        page-table width)."""
        return frozenset(self._shapes)

    def note_dispatch(self, kind: str, shape: Tuple[int, ...],
                      valid_tokens: Optional[int] = None) -> None:
        """Record one attention dispatch: a first-seen (kind, shape) counts
        in ``attn_dispatch_shapes``; prefill-family dispatches
        under ragged mode count ``attn_ragged_dispatches`` and publish the
        valid/padded occupancy gauge."""
        key = (kind,) + tuple(int(x) for x in shape)
        self.last_dispatch = (
            kind, tuple(int(x) for x in shape), valid_tokens
        )
        if key not in self._shapes:
            self._shapes.add(key)
            if self.metrics is not None:
                self.metrics.counter("attn_dispatch_shapes")
        if self.metrics is None:
            return
        if self.latent:
            self.metrics.counter("latent_decompress_dispatches")
        if self.enabled and kind != DECODE:
            self.metrics.counter("attn_ragged_dispatches")
        if valid_tokens is not None:
            padded = 1
            for x in shape:
                padded *= int(x)
            if padded > 0:
                self.metrics.gauge(
                    "attn_grid_occupancy", valid_tokens / padded
                )

    def note_chunk_rows(self, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter("attn_chunked_rows", n)
