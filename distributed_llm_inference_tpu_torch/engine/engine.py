"""Inference engine: continuous batching over one KV cache (a paged pool or
dense per-row buffers), with bucketed prefill and a decode step over the
active batch (counterpart of the core of the JAX package's
``engine/engine.py``).

Sessions are pinned to batch rows of ONE preallocated cache, admitted and
evicted between steps. The port runs eagerly: there is no per-shape compile,
so the JAX engine's executable warm-ups have no counterpart, but the padded
dispatch shapes of the :class:`AttentionPlan` are kept — the admission
partition and the order of sampling-key draws depend on them.

Step anatomy (host orchestrates, device computes):
  1. admit — move waiting sessions into free slots (pages allocated from the
     pool; a dense cache grows its buffers along the window ladder), run
     batched or single-row prefill(s), sample the first token;
     long greedy prompts park and walk their prompt one chunk per granted
     tick beside the live decode batch.
  2. decode — K fused steps over all slots (``decode_steps``; None resolves
     to 16 where the cache has the write-behind tail, as in the JAX
     engine): sampling, EOS stops and per-row budgets run on the device,
     the cache stays read-only until one flush per window, and on a CUDA
     device each step replays a CUDA graph (``engine/graphs.py``). Inactive
     rows carry ``num_new = 0`` and write nothing.
  3. retire — EOS / length / capacity sessions leave their slots; pages
     return to the allocator.

Pipelined ticks (``pipelined_ticks``, K > 1): ``step()`` enqueues tick N
from a device-resident carry of tick N-1's last tokens BEFORE it resolves
tick N-1, whose emitted tokens were copied to pinned host memory behind it;
a tick's tokens reach the caller one ``step()`` after their dispatch.
Overlapped admission (``overlap_admission``): with a tick in flight,
prefills are enqueued behind it and their first tokens are fetched at the
next tick boundary, scattered into the carry meanwhile.

What the port serves: a dense Llama-family model in bf16/f32, or with int4
(half-split), int8 or int8-with-outlier-channels weights
(``EngineConfig.quantization``), over the paged
or the dense cache or the StreamingLLM sink ring (``CacheConfig.kind``), in
the model dtype or int8 (``CacheConfig.kv_quant="int8"``); and a latent
(MLA, DeepSeek-V2) model in bf16/f32 over the latent page pool
(``cache/latent.py``: f32, or int8 with ``kv_quant="int8"``), which has no
write-behind tail: ``decode_steps=None`` resolves to 1 there, and K steps
``model_apply`` K times. The sink ring
never grows and never fills: its streams run to ``max_new_tokens`` (or a
bound of 2^20 tokens on the int8 ring, 2^30 on the other), prompts longer
than the ring span are chunked, and only the int8 ring has the fused
window (when its span holds K tokens). Prefix caching
(``CacheConfig.prefix_caching``, policy in :class:`PrefixConfig`) shares
full prompt pages of the paged pools (all four kinds) between sessions by
content, copy-on-write, with an optional host spill tier
(``prefixstore/``). Speculative decoding (``draft=(draft_cfg,
draft_params)``): greedy sessions that opt in (``SamplingOptions.
speculative``) get ``EngineConfig.speculative_k`` draft proposals a round,
verified by ONE target forward over ``k + 1`` positions a row, with the
other rows riding the same forward as one-token decodes; the tokens equal
plain greedy decoding. With ``pipelined_ticks`` a tick runs ``spec_rounds``
rounds on the device and the host fetches their packed result once, one
``step()`` later. Sharded serving (``mesh_cfg``, ``parallel/``): one
process a device, every rank running this scheduler over the same
submissions in the same order (the caller's part, cancels included), each
holding its shard of the weights and its cache: heads over tp, layers over
pp (the GPipe pipeline for every forward), rows over dp (the sampled
tokens gathered so every scheduler sees every row), experts over ep, and
prompts past ``ring_prefill_threshold`` prefilled over the sp ring. The
constructor raises ``NotImplementedError``, naming the ``ROADMAP.md``
queue item, for every feature that waits.
"""

from __future__ import annotations

import collections
import math
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..cache.base import window_ladder
from ..cache.dense import DenseKVCache, QuantizedDenseKVCache
from ..cache.latent import LatentPagedKVCache, QuantizedLatentPagedKVCache
from ..cache.paged import PageAllocator, PagedKVCache, QuantizedPagedKVCache
from ..cache.sink import QuantizedSinkKVCache, SinkKVCache
from ..config import CacheConfig, EngineConfig, ModelConfig, PrefixConfig
from ..models import llama
from ..ops import quant
from ..ops.attention import (
    int8_pages_error, kernel_widths_error, latent_widths_error)
from ..parallel import comm
from ..utils.device import resolve_device, to_device
from ..utils.metrics import Metrics
from .graphs import FusedDecode, SpeculativeRounds
from .plan import AttentionPlan
from .sampling import SamplingOptions, SamplingParams, sample
from .session import Session, SessionState


# The cache kinds of the StreamingLLM sink ring: unbounded streams in fixed
# memory, so the scheduler's capacity and growth paths skip them.
_SINK_KINDS = (SinkKVCache, QuantizedSinkKVCache)


def _expired(s: Session, now: float) -> bool:
    """Whether a reap ends ``s`` as a deadline expiry: its deadline had
    passed when it was first cancelled, or, uncancelled, has passed by
    ``now``. The gateway cancels a request once its deadline and a grace
    have run out; whether that cancel or this tick-boundary reap comes
    first depends only on how long the driver thread was between two
    ``step()``s, so the cancel's own time decides."""
    if s.deadline is None:
        return False
    when = s.cancel_time if s.cancel_requested else now
    return when is not None and when >= s.deadline


def _waits(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, {item})"
    )


def _check_mesh(cfg, ecfg, cc, mesh_cfg, draft) -> None:
    """The mesh refusals, in the JAX engine's words, and what waits; all of
    them before any process group is touched."""
    if mesh_cfg.sp != 1:
        # sp is a PREFILL-side program (parallel/ring.py): prompts past the
        # ring threshold prefill sequence-sharded over sp, then hand their
        # KV to the (sp-replicated) decode path.
        if mesh_cfg.pp != 1:
            raise ValueError(
                "sp>1 ring prefill does not compose with pp serving "
                f"(got {mesh_cfg})"
            )
        if cc.kind not in ("dense", "paged"):
            raise ValueError(
                "sp>1 ring prefill requires a dense or paged cache "
                "kind (contiguous ring KV ingest; the sink ring "
                f"evicts on write; got kind={cc.kind!r})"
            )
    if mesh_cfg.pp > 1 and cc.kind not in ("dense", "paged"):
        raise ValueError(
            f"pp>1 serving requires the dense or paged cache "
            f"(got {cc.kind!r})"
        )
    if ecfg.max_batch_size % (mesh_cfg.pp * mesh_cfg.dp) != 0:
        raise ValueError(
            f"max_batch_size {ecfg.max_batch_size} must divide by pp*dp = "
            f"{mesh_cfg.pp}*{mesh_cfg.dp} (microbatch row groups)"
        )
    if mesh_cfg.pp > 1 and cfg.num_layers % mesh_cfg.pp != 0:
        raise ValueError(
            f"num_layers {cfg.num_layers} not divisible by "
            f"pp={mesh_cfg.pp}"
        )
    from ..parallel.tp import validate_tp

    validate_tp(cfg, mesh_cfg.tp, ep=mesh_cfg.ep)
    if ecfg.quantization == "int4" and (mesh_cfg.tp > 1 or mesh_cfg.pp > 1):
        # The JAX engine switches int4 to its grouped layout there (the
        # half-split packing does not column-shard).
        raise _waits("int4 weights under a tp or pp mesh", "item 22")
    if cc.prefix_caching:
        raise _waits("prefix caching under a mesh", "item 22")
    if draft is not None:
        raise _waits("a draft model under a mesh", "item 22")


class InferenceEngine:
    """Continuous-batching engine over one model replica, on one device or,
    with ``mesh_cfg`` (a :class:`MeshConfig`), as one rank of a sharded
    deployment: the ``torch.distributed`` job must have
    ``mesh_cfg.num_devices`` ranks (``parallel.init_distributed``), and the
    mesh refusals of the JAX engine, in its words, come before any process
    group is touched. Under gloo the K-step window runs eagerly (gloo calls
    cannot be captured); under NCCL its step is captured with its
    collectives. A rank's attention runs the cache's kernels over its own
    heads, with the plan of the JAX mesh engine (``plan.enabled`` off).

    ``generator`` is the root of the engine's randomness: a CPU
    ``torch.Generator`` from which one sampling key is drawn per dispatch
    (seed 0 when None). ``device`` defaults to ``"cuda"`` and the constructor
    raises when there is no such device. ``attention_backend`` is what the
    :class:`AttentionPlan` resolves kernels for; it defaults to the device's
    type, and tests pass ``"cuda"`` with ``device="cpu"`` to route attention
    through the kernel wrappers, which take their plain versions for CPU
    tensors. On a CUDA device each fused decode step is replayed from a
    CUDA graph (``engine/graphs.py``). On a CUDA device the constructor
    raises ``NotImplementedError`` for a model whose head_dim or query heads
    a kv head no attention kernel takes (``ops/attention.py:
    kernel_widths_error``; a latent model's lat_dim and query heads:
    ``latent_widths_error``), and for bf16 over int8 pages of a page size the
    kernels cannot box (``int8_pages_error``), rather than at the first
    kernel call.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        engine_cfg: Optional[EngineConfig] = None,
        cache_cfg: Optional[CacheConfig] = None,
        generator: Optional[torch.Generator] = None,
        mesh_cfg=None,
        draft=None,
        prefix_cfg=None,
        trace_cfg=None,
        device: Union[str, torch.device] = "cuda",
        attention_backend: Optional[str] = None,
    ):
        self.cfg = cfg
        self.ecfg = engine_cfg or EngineConfig()
        self.ccfg = cache_cfg or CacheConfig()
        ecfg, cc = self.ecfg, self.ccfg
        if ecfg.decode_steps is not None and ecfg.decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got {ecfg.decode_steps}")
        if cc.kind not in ("paged", "dense", "sink"):
            raise ValueError(f"unknown cache kind {cc.kind}")
        if cc.kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv_quant {cc.kv_quant!r}")
        if cc.prefix_caching and cc.kind != "paged":
            raise ValueError(
                f"prefix_caching requires the paged cache (got kind={cc.kind!r})"
            )
        if cfg.use_latent:
            # Latent (MLA) attention stores one [rank + dr] latent a token
            # in the paged pool only; the mesh programs shard per-head
            # pools (the JAX engine's limits).
            if cc.kind != "paged":
                raise ValueError(
                    "ModelConfig.latent requires the paged cache "
                    f"(got kind={cc.kind!r})"
                )
            if mesh_cfg is not None:
                raise ValueError(
                    "latent KV attention is single-device only (mesh "
                    "sharding of the latent pool is not implemented)"
                )
            if ecfg.quantization is not None:
                raise _waits(
                    f"quantization={ecfg.quantization!r} on a latent (mla) "
                    f"model", "item 20")
        if ecfg.quantization not in (None, "int8", "int4", "int8_outlier"):
            raise ValueError(f"unknown quantization {ecfg.quantization!r}")
        if mesh_cfg is not None:
            _check_mesh(cfg, ecfg, cc, mesh_cfg, draft)
        if trace_cfg is not None:
            raise _waits("trace_cfg (spans and the flight recorder)", "item 16")

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            why = (latent_widths_error(cfg.latent.lat_dim, cfg.num_heads)
                   if cfg.use_latent else kernel_widths_error(
                       cfg.head_dim, cfg.num_heads // cfg.num_kv_heads))
            if why is not None:
                raise NotImplementedError(f"this model's attention: {why}")
            if (not cfg.use_latent and cc.kind == "paged"
                    and cc.kv_quant == "int8"
                    and ecfg.dtype == "bfloat16"):
                why = int8_pages_error(cfg.head_dim, cc.page_size)
                if why is not None:
                    raise NotImplementedError(f"this cache: {why}")
        # Pin the W8A8 prefill-activation policy for this deployment (module
        # flags, as in the JAX package; EngineConfig is the way to set them).
        if ecfg.act_quant_prefill is not None:
            quant.ACT_QUANT_PREFILL = ecfg.act_quant_prefill
        if ecfg.act_quant_min_seq is not None:
            quant.ACT_QUANT_MIN_SEQ = ecfg.act_quant_min_seq
        if ecfg.quantization is not None and mesh_cfg is not None and (
                getattr(params, "cut_for", None) is not None):
            raise ValueError(
                "a mesh engine quantizes the whole tree before cutting it "
                "(per-channel scales span the whole contracted axis): pass "
                "the whole parameters, not a rank's slice")
        if ecfg.quantization is not None:
            # Quantized where the weights lie (the engine's device), one
            # layer of one stack at a time. A single device takes the
            # half-split int4 layout, as the JAX engine does without a mesh.
            # int8_outlier: LLM.int8()-style fp input channels a projection,
            # chosen by calibration activation absmax (act_scales) when
            # given, else by weight-row absmax.
            qkw = {}
            if ecfg.quantization == "int8_outlier":
                qkw["outlier_channels"] = ecfg.outlier_channels
                if ecfg.act_scales is not None:
                    qkw["act_scales"] = ecfg.act_scales
            params = quant.quantize_params(
                params, bits=4 if ecfg.quantization == "int4" else 8, **qkw,
            )
        # Sharded serving (``parallel/``): this rank's mesh, its slice of
        # the weights (cut on the host, then copied to the device), its
        # config (its heads, MLP features and layers) and its rows of the
        # batch. Every rank runs this same scheduler over the same
        # submissions; a dp rank computes only its rows.
        self.mesh = None
        self._use_pp = False
        self._row0, self._nrows = 0, ecfg.max_batch_size
        if mesh_cfg is not None:
            from ..parallel import build_mesh, tp

            self.mesh = build_mesh(mesh_cfg, self.device)
            self._use_pp = mesh_cfg.pp > 1
            params = tp.shard_params(params, self.mesh, self._use_pp)
            _, self._nrows, _ = tp.local_cache_shape(
                cfg.num_layers, ecfg.max_batch_size, cfg.num_kv_heads,
                self.mesh.shape)
            self._row0 = self.mesh.index("dp") * self._nrows
            cfg = self.cfg = tp.local_model_config(cfg, self.mesh.shape)
        self.params = params
        self.generator = (
            generator if generator is not None
            else torch.Generator().manual_seed(0)
        )
        self.metrics = Metrics()
        self.pcfg = prefix_cfg or PrefixConfig()
        # Prefix caching's host spill arena (paged + prefix_caching + a
        # spill budget only) and the cumulative prompt-token reuse ratio
        # behind the prefix_hit_rate gauge.
        self._spill = None
        self._prefix_seen = 0
        self._prefix_hits = 0
        # Scheduler lock: slots/cache/allocator are mutated only by
        # step()/collect_finished() under this lock (single writer).
        # submit()/cancel() are deliberately LOCK-FREE — step() holds the
        # lock across whole device steps, and request admission/cancellation
        # must not stall on that; they rely on GIL-atomic deque/dict ops and
        # state flags the scheduler observes at tick boundaries.
        self._lock = threading.Lock()
        # Deferred page-table installs: (row, slot_idx, page) triples applied
        # by one scatter right before the dispatch that needs them.
        self._pending_installs: List[Tuple[int, int, int]] = []

        self.batch = ecfg.max_batch_size
        self.dtype = getattr(torch, ecfg.dtype)
        self.plan = AttentionPlan(
            ecfg, cc, metrics=self.metrics,
            backend=attention_backend or self.device.type,
        )
        # Every dispatch of a latent model reads the stored latents in place
        # (latent_decompress_dispatches).
        self.plan.latent = cfg.use_latent
        sel = self.plan.select()
        self._use_pallas = sel.use_pallas
        if self.mesh is not None:
            # The JAX mesh engine turns its plan off: no ragged pad widths,
            # no chunk co-scheduling, so the mesh engine's dispatches (and
            # its events, tick by tick) are the JAX mesh engine's. The
            # kernels stay those selected for the device: on a card every
            # rank attends over its own heads through the cache's kernels.
            self.plan.enabled = False
        # Sessions parked mid chunked-prefill (slot held, decode-ineligible;
        # advanced by _chunk_dispatch on the decode cadence).
        self._chunking: List[Session] = []

        if cc.kind == "dense":
            # Start at the smallest bucket; _ensure_capacity grows the
            # buffers (one pad-copy per growth) as sequences lengthen: decode
            # traffic tracks the LIVE context, not max_seq_len. For the int8
            # cache use_pallas_attention selects its OWN kernels (#8, and
            # #9/#10 in the window).
            self._windows = self._window_ladder()
            first = self._windows[0] if self._windows else ecfg.max_seq_len
            if cc.kv_quant:
                self.cache = QuantizedDenseKVCache.create(
                    cfg.num_layers, self._nrows, first, cfg.num_kv_heads,
                    cfg.head_dim, self.dtype, use_kernel=self._use_pallas,
                    device=self.device,
                )
            else:
                self.cache = DenseKVCache.create(
                    cfg.num_layers, self._nrows, first, cfg.num_kv_heads,
                    cfg.head_dim, self.dtype, device=self.device,
                )
            self.allocator = None
        elif cc.kind == "sink":
            # A fixed ring: no ladder, no growth, no idle shrink. The int8
            # ring under use_pallas_attention takes its own kernels (#11,
            # #12 in the window).
            self._windows = ()
            if cc.kv_quant:
                self.cache = QuantizedSinkKVCache.create(
                    cfg.num_layers, self._nrows, cc.window_length,
                    cc.num_sink_tokens, cfg.num_kv_heads, cfg.head_dim,
                    self.dtype, use_kernel=self._use_pallas,
                    device=self.device,
                )
            else:
                self.cache = SinkKVCache.create(
                    cfg.num_layers, self._nrows, cc.window_length,
                    cc.num_sink_tokens, cfg.num_kv_heads, cfg.head_dim,
                    self.dtype, device=self.device,
                )
            self.allocator = None
        else:
            # The gather path materializes [B, table_width * page_size, ...]
            # per layer, so its traffic tracks the TABLE WIDTH: start narrow
            # and pad columns as sessions lengthen (the pool never moves);
            # max_pages_per_session is the cap. Under a pp or dp mesh the
            # table keeps its full width, as in the JAX engine.
            grow_ok = mesh_cfg is None or (mesh_cfg.pp == 1
                                           and mesh_cfg.dp == 1)
            self._windows = () if not grow_ok else self._window_ladder(
                cap=min(ecfg.max_seq_len,
                        cc.max_pages_per_session * cc.page_size),
                strict=False,
            )
            self._first_slots = (
                max(1, -(-self._windows[0] // cc.page_size))
                if self._windows else cc.max_pages_per_session
            )
            if cfg.use_latent:
                # One latent "head" a token: the fused [rank + rope_head_dim]
                # stored form, f32 (or int8 + f32 scales), read in place by
                # the latent kernels (K = V = the stored latent).
                cache_cls = (QuantizedLatentPagedKVCache if cc.kv_quant
                             else LatentPagedKVCache)
                heads, width = 1, cfg.latent.lat_dim
            else:
                cache_cls = (QuantizedPagedKVCache if cc.kv_quant
                             else PagedKVCache)
                heads, width = cfg.num_kv_heads, cfg.head_dim
            self.cache = cache_cls.create(
                cfg.num_layers, self._nrows, cc.num_pages, cc.page_size,
                self._first_slots, heads, width, self.dtype,
                use_kernel=self._use_pallas, use_ragged=sel.use_ragged,
                device=self.device,
            )
            self.allocator = PageAllocator(cc.num_pages)
            if cc.prefix_caching and self.pcfg.spill_bytes_max > 0:
                # Registered prefix pages evicted by the refcount-aware LRU
                # snapshot their stored-form tiles into a bounded host
                # arena; a later admission whose chain reaches the key
                # reloads them with one host-to-device copy a plane.
                from ..prefixstore import HostSpillArena

                self._spill = HostSpillArena(self.pcfg.spill_bytes_max)
                # Through a weak reference: the allocator must not keep the
                # engine alive. An engine in a reference cycle dies when the
                # cyclic collector runs, at a time no one chose, maybe while
                # another engine captures a CUDA graph.
                engine = weakref.ref(self)
                self.allocator.on_evict = (
                    lambda page, key: engine()._spill_page(page, key))
        # Stored KV bytes per token over every plane (values and, for the
        # int8 kinds, the scale planes): a plane's bytes past its two
        # leading axes, over the slots they hold (a page, or a row's T).
        # The int8 sink ring states its own: its sink planes are not
        # per-token storage.
        slots = cc.page_size if self.allocator is not None else self.cache.max_len
        self.metrics.gauge(
            "kv_bytes_per_token",
            float(getattr(self.cache, "kv_bytes_per_token", None) or sum(
                plane.shape[0] * plane.element_size()
                * math.prod(plane.shape[2:]) // slots
                for plane in self.cache.layer_stacks
            )),
        )

        self.sessions: Dict[str, Session] = {}
        self.waiting: collections.deque[Session] = collections.deque()
        self.slots: List[Optional[str]] = [None] * self.batch
        # Admission-ordering hook (set_admission_order): None = FIFO.
        self._admission_order = None

        # The model-dtype dense cache and sink ring under use_pallas take
        # the flash kernel for their prefills (decode shapes fall back
        # inside it). Caches with their OWN kernels (int8 dense and sink,
        # paged) keep attention unset: flash there would force their
        # gather paths and disable the window.
        self._attention = None
        if self._use_pallas and isinstance(self.cache, (DenseKVCache,
                                                        SinkKVCache)):
            from ..ops.flash_attention import flash_attention

            self._attention = flash_attention
        self._mkw = (
            {} if self._attention is None
            else {"attention_fn": self._attention}
        )
        # The write-behind tail (the fused K-step window) needs the cache's
        # tail protocol and the default attention: both dense kinds, the
        # int8 pool always, the model-dtype pool with its decode kernel, the
        # int8 sink ring, as in the JAX engine (its pipeline-parallel branch
        # waits). The model-dtype sink ring has no tail, and neither have
        # the latent pools (the tail would rotate the stored form again):
        # they step model_apply K times.
        tail_capable = (
            self._attention is None
            and not self._use_pp
            and not isinstance(self.cache, LatentPagedKVCache)
            and (
                isinstance(self.cache, (DenseKVCache, QuantizedDenseKVCache,
                                        QuantizedPagedKVCache,
                                        QuantizedSinkKVCache))
                or (isinstance(self.cache, PagedKVCache)
                    and self.cache.use_kernel)
            )
        )
        if tail_capable and isinstance(self.cache, QuantizedSinkKVCache):
            # The window must fit the ring span: tail tokens evicting each
            # other is more than the tail's prefix validity can express.
            k_want = ecfg.decode_steps if ecfg.decode_steps is not None else 16
            tail_capable = self.cache.ring_slots >= max(1, k_want)
        # decode_steps=None resolves to the fused window wherever it
        # composes, as in the JAX engine.
        self.decode_steps = (
            ecfg.decode_steps if ecfg.decode_steps is not None
            else (16 if tail_capable else 1)
        )
        K = self.decode_steps
        self._fused = (
            FusedDecode(cfg, self.params, K, self._nrows, self.device,
                        self.metrics, self.mesh, self._row0)
            if tail_capable and K > 1 else None
        )
        # pp > 1: every batched model forward runs the GPipe-staged
        # pipeline over the stage's layers (microbatches of pp rows);
        # a single-row prefill runs it with one microbatch.
        self._block_fn = self._prefill_block_fn = None
        if self._use_pp:
            from ..parallel.pipeline import pipeline_block_apply

            def pp_block(num_microbatches):
                def block_fn(cfg_, layers, x, cache, num_new, attention_fn,
                             mesh):
                    return pipeline_block_apply(
                        cfg_, layers, x, cache, num_new, attention_fn, mesh,
                        num_microbatches)
                return block_fn

            self._block_fn = pp_block(None)
            self._prefill_block_fn = pp_block(1)
        self._mesh_kw = (
            {} if self.mesh is None
            else {"mesh": self.mesh, "block_fn": self._block_fn}
        )

        # -- pipelined decode ticks -------------------------------------------
        # Dispatch tick N from a device-resident carry of tick N-1's final
        # tokens, THEN resolve tick N-1's emitted tokens (their copy to the
        # host overlaps tick N's compute).
        self._pending = None
        self._carry: Optional[torch.Tensor] = None
        self._carry_ok = np.zeros(self.batch, np.bool_)
        # -- overlapped admission ------------------------------------------------
        # With a pipelined tick in flight, admission prefills are enqueued
        # behind it, but the blocking first-token fetch is deferred: each
        # record holds (sessions, device tokens, host copy, copy event) until
        # the next tick boundary. The tokens scatter into the carry, so the
        # next tick consumes them with no host round trip, and
        # ``_admit_pend`` charges one in-flight token per row. Device
        # programs and key order are those of the synchronous path.
        self._inflight_admits: List[Tuple[List[Session], torch.Tensor,
                                          torch.Tensor, object,
                                          List[int]]] = []
        self._admit_pend = np.zeros(self.batch, np.int32)
        # A draft-model engine keeps the synchronous flow: its speculative
        # ticks pipeline on their own (_speculative_rounds_tick).
        self._pipelined = (ecfg.pipelined_ticks and K > 1 and tail_capable
                           and draft is None)
        # Batched admission gathers and scatters rows (select_rows /
        # merge_rows): the model-dtype sink ring has neither, so its
        # admissions prefill one row at a time, as in the JAX engine, and
        # so do mesh engines (their rows lie on different dp ranks).
        self._batch_admission = (self.mesh is None
                                 and hasattr(self.cache, "select_rows"))
        # Ring (sequence-parallel) prefill of long prompts over sp.
        self._sp = 1 if mesh_cfg is None else mesh_cfg.sp

        # -- speculative decoding (a draft model) -----------------------------
        self.draft = None
        self.spec_stats = {"proposed": 0, "accepted": 0, "steps": 0}
        self._spec_pending = None
        if draft is not None:
            self._init_draft(draft)

    def _init_draft(self, draft) -> None:
        """The draft model's state: its dense cache in the model dtype at
        ``max_seq_len``, the fused rounds' state and device carries, and the
        adaptive controller. Refuses what the JAX engine refuses, in its
        words."""
        dcfg, dparams = draft
        if dcfg.vocab_size != self.cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if isinstance(self.cache, _SINK_KINDS):
            raise ValueError(
                "speculative decoding needs rollback-capable caches "
                "(dense/paged); the sink ring evicts on write"
            )
        ecfg = self.ecfg
        sk = ecfg.speculative_k
        if sk < 1:
            raise ValueError(
                f"speculative_k must be >= 1 with a draft model, got {sk}"
            )
        self.draft = (dcfg, dparams)
        # Created at full width once: it never moves, so a captured round
        # stays valid across ticks.
        self.draft_cache = DenseKVCache.create(
            dcfg.num_layers, self.batch, ecfg.max_seq_len, dcfg.num_kv_heads,
            dcfg.head_dim, self.dtype, device=self.device,
        )
        # Fused rounds a speculative tick (_spec_round_fn).
        self.spec_rounds = (
            ecfg.speculative_rounds if ecfg.speculative_rounds is not None
            else max(1, (ecfg.decode_steps or 16) // (sk + 1))
        )
        self._rounds = SpeculativeRounds(self.batch, sk, self.spec_rounds,
                                         self.device, self.metrics)
        self._draft_ladder = window_ladder(ecfg.max_seq_len)
        self._draft_view = None
        # The pipelined rounds' state: the device-resident token carry of
        # the in-flight tick, and the draft's pending catch-up pair (token,
        # mask) that the next round's first draft step consumes.
        self._spec_carry: Optional[torch.Tensor] = None
        self._spec_catch = None
        self._spec_carry_ok = np.zeros(self.batch, np.bool_)
        # The adaptive controller (config.py's speculative_probe_* knobs):
        # mode "spec" | "probe_plain" | "plain" | "probe_spec"; rates are
        # tokens/s a resident speculative row over windows of probe_len
        # ticks. The clock is injectable: tests drive the window's wall time.
        self._spec_suspended = False
        self._spec_clock = time.monotonic
        self._spec_ctl = {
            "mode": "spec", "win_t0": None, "win_tok0": 0.0,
            "win_ticks": 0, "spec_rate": None, "plain_rate": None,
            "cooldown": 0, "stat0": dict(self.spec_stats),
            "tpr_ema": None,
            # The resident set at the window's start: churn mid-window
            # re-baselines the window.
            "comp": None,
        }

    # -- device programs (eager) ----------------------------------------------

    def _i32(self, values) -> torch.Tensor:
        return to_device(np.asarray(values, np.int32), torch.int32, self.device)

    def _prefill(self, tokens, row: int, n_valid: int, key, sp) -> torch.Tensor:
        """One row's (final) prefill chunk; samples at its last position."""
        if self.mesh is not None:
            return self._row_prefill(tokens, row, n_valid, key, sp)
        sub = self.cache.select_row(row)
        logits, sub = llama.model_apply(
            self.cfg, self.params, tokens, sub, self._i32([n_valid]),
            head="last", **self._mkw,
        )
        self.cache.merge_row(sub, row)
        return sample(logits[:, 0], key, sp)[0]

    def _prefill_ns(self, tokens, row: int, n_valid: int) -> None:
        """Chunked-prefill interior: fill the cache; the head is skipped
        entirely (an interior chunk samples nothing)."""
        if self.mesh is not None:
            self._row_prefill(tokens, row, n_valid)
            return
        sub = self.cache.select_row(row)
        _, sub = llama.model_apply(
            self.cfg, self.params, tokens, sub, self._i32([n_valid]),
            head="none", **self._mkw,
        )
        self.cache.merge_row(sub, row)

    def _prefill_batch(self, tokens, rows, n_valid, key, sp) -> torch.Tensor:
        """Batched admission: k sessions' prompts in ONE padded dispatch over
        a compact k-row view of the cache (the page pool is shared, so the
        prefill writes straight into it; a dense cache's rows are a gathered
        copy that ``merge_rows`` writes back)."""
        sub = self.cache.select_rows(rows)
        logits, sub = llama.model_apply(
            self.cfg, self.params, tokens, sub, self._i32(n_valid),
            head="last", **self._mkw,
        )
        self.cache.merge_rows(sub, rows)
        return sample(logits[:, 0], key, sp)

    def _decode(self, tokens, active, key, sp) -> torch.Tensor:
        if self.mesh is not None:
            r0, r1 = self._row0, self._row0 + self._nrows
            tokens, active, sp = tokens[r0:r1], active[r0:r1], sp.rows(r0, r1)
        logits, _ = llama.model_apply(
            self.cfg, self.params, tokens, self.cache,
            active.to(torch.int32), **self._mkw, **self._mesh_kw,
        )
        return self._gather_rows(sample(logits[:, 0], key, sp, 0, self._row0))

    # -- the mesh's row groups ------------------------------------------------

    def _gather_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """A mesh rank's tensor of its rows, assembled over ``dp`` into the
        whole batch's along ``dim`` (every scheduler sees every row)."""
        if self.mesh is None:
            return t
        return comm.all_gather(t, self.mesh.axis("dp"), dim)

    def _local_row_mask(self, slot: int) -> torch.Tensor:
        """``[rows]`` bool over this rank's rows: True at ``slot`` if it is
        one of them."""
        return torch.arange(self._nrows, device=self.device) == (
            slot - self._row0)

    def _row_prefill(self, tokens, row: int, n_valid: int, key=None,
                     sp=None, ring: bool = False):
        """A mesh engine's single-row prefill chunk: the row's dp group
        computes it (through the pipeline, one microbatch, under pp; over
        the sp ring when ``ring``) and, when ``key`` is given, samples the
        token at its last position and broadcasts it over dp. Returns the
        token (``[1]`` int32) or None."""
        owner, local = divmod(row, self._nrows)
        tok = torch.zeros((1,), dtype=torch.int32, device=self.device)
        if owner == self.mesh.index("dp"):
            n = self._i32([n_valid])
            sub = self.cache.select_row(local)
            if ring:
                from ..parallel.ring import ring_prefill

                logits, ks, vs = ring_prefill(self.cfg, self.params, tokens,
                                              n, self.mesh)
                sub.ingest_row(ks, vs, n_valid)
            else:
                logits, sub = llama.model_apply(
                    self.cfg, self.params, tokens, sub, n,
                    head="last" if key is not None else "none", **self._mkw,
                    mesh=self.mesh, block_fn=self._prefill_block_fn,
                )
            self.cache.merge_row(sub, local)
            if key is not None:
                tok = sample(logits[:, 0], key, sp)
        if key is None:
            return None
        comm.broadcast(tok, self.mesh.axis("dp"), owner)
        return tok[0]

    def _decode_k(self, tokens, active, key, sp, eos_ids, budget):
        """``K`` fused decode steps in one dispatch (the JAX engine's
        ``_decode_scan``): sampling, EOS stops and per-row token budgets on
        the device. Rows that stop keep computing but write nothing
        (``num_new = 0``) and emit -1. Returns ``emitted [K, B]``.

        Tail-capable caches run the write-behind window
        (``engine/graphs.py``); the others step ``model_apply`` K times."""
        if self.mesh is not None:
            r0, r1 = self._row0, self._row0 + self._nrows
            tokens, active, sp = tokens[r0:r1], active[r0:r1], sp.rows(r0, r1)
            eos_ids, budget = eos_ids[r0:r1], budget[r0:r1]
        if self._fused is not None:
            return self._gather_rows(self._fused.run(
                self.cache, tokens, active, key, sp, eos_ids, budget), 1)
        tok, alive, emits = tokens, active, []
        for i in range(self.decode_steps):
            logits, _ = llama.model_apply(
                self.cfg, self.params, tok, self.cache, alive.to(torch.int32),
                **self._mkw, **self._mesh_kw,
            )
            nxt = sample(logits[:, 0], key, sp, i, self._row0)
            emits.append(torch.where(alive, nxt, -1))
            alive = alive & (nxt != eos_ids) & (i + 1 < budget)
            tok = nxt[:, None]
        return self._gather_rows(torch.stack(emits), 1)

    # -- the draft model's programs (eager; the draft attends by the gather
    # path over its dense cache, as the JAX draft takes XLA) ----------------

    def _draft_prefill(self, tokens, row: int, n_valid: int) -> None:
        """One chunk of a row's stream into the draft cache (no head)."""
        dcfg, dparams = self.draft
        sub = self.draft_cache.select_row(row)
        llama.model_apply(dcfg, dparams, tokens, sub, self._i32([n_valid]),
                          head="none")
        self.draft_cache.merge_row(sub, row)

    def _draft_propose(self, tokens, active) -> torch.Tensor:
        """``k`` greedy draft tokens for every active row (``[k, B]``); the
        draft cache advances ``k`` on active rows."""
        dcfg, dparams = self.draft
        num_new = active.to(torch.int32)
        tok, toks = tokens, []
        for _ in range(self.ecfg.speculative_k):
            logits, _ = llama.model_apply(dcfg, dparams, tok,
                                          self.draft_cache, num_new)
            nxt = torch.argmax(logits[:, 0], -1).to(torch.int32)
            toks.append(nxt)
            tok = nxt[:, None]
        return torch.stack(toks)

    def _draft_catchup(self, tokens, mask) -> None:
        """Feed ``tokens`` ``[B, 1]`` to the draft cache where ``mask``."""
        dcfg, dparams = self.draft
        llama.model_apply(dcfg, dparams, tokens, self.draft_cache,
                          mask.to(torch.int32), head="none")

    def _verify(self, tokens, prop, spec, num_new, key, sp):
        """ONE target forward over ``[last, p1..pk]`` (speculative rows,
        ``num_new = k + 1``) and ``[last, pad...]`` (the other rows, ``num_new
        = 1``; inactive rows 0): on the paged pools the cache's multi-token
        route, the ragged kernels on the card. Returns the argmax at every
        position ``[B, k + 1]`` and the position-0 sample (the other rows'
        token); the cache advanced by ``num_new`` (the caller rolls the
        speculative rows back)."""
        seq = torch.cat([tokens, torch.where(spec[:, None], prop.T, 0)], 1)
        logits, _ = llama.model_apply(self.cfg, self.params, seq, self.cache,
                                      num_new, **self._mkw)
        preds = torch.argmax(logits, -1).to(torch.int32)
        return preds, sample(logits[:, 0], key, sp)

    def _spec_round_fn(self, tokens, spec, active, eos_ids, budget, key, sp,
                       catch_tok, catch, width):
        """``spec_rounds`` fused propose -> verify -> accept rounds
        (:meth:`_spec_round`), every decision on the device; on a card one
        round is replayed from a CUDA graph (``engine/graphs.py:
        SpeculativeRounds``). Nothing here waits for the host. Returns
        ``(pack [R, B, k + 3] int32, tok_carry [B, 1], catch_tok [B, 1],
        catch [B])``: per round the emitted tokens (``k + 1`` slots, -1
        padded), the accepted count and whether the row speculated, in ONE
        tensor so the host fetches once.

        ``catch_tok`` / ``catch`` carry the draft's pending catch-up: on
        full acceptance the draft never consumed its own last proposal, so
        the next round's first draft step consumes ``[p_k, tok]`` as a
        2-position forward (``num_new = 1 + catch``), across ticks too.

        The draft attends the first ``width`` positions of its cache (a
        view, :meth:`DenseKVCache.narrowed`): a rung of the default window
        ladder that holds every row's tick."""
        self._draft_view = self.draft_cache.narrowed(width)
        return self._rounds.run(
            self.cache.window_anchor, width, self._spec_round, tokens, spec,
            active, eos_ids, budget, key, sp, catch_tok, catch)

    def _spec_round(self, st) -> None:
        """One round on the state ``st`` (a :class:`SpeculativeRounds`), in
        place: draft proposals, ONE target forward over ``[tok, p1..pk]``,
        acceptance, EOS and budget stops, the target's and the draft's
        rollback (``lengths`` decrements), the pending catch-up. A sampled
        plain row riding the rounds draws with the round index as its step,
        so no two rounds of a tick reuse a draw."""
        dcfg, dparams = self.draft
        sk = self.ecfg.speculative_k
        b, dev = self.batch, self.device
        i32 = torch.int32
        jidx = torch.arange(sk + 1, dtype=i32, device=dev)[None, :]
        tok, alive, spec, ctok, cm = st.tok, st.alive, st.spec, st.ctok, st.cm
        palive = (alive & spec).to(i32)
        cmi = cm.to(i32)
        # The first draft step folds the pending catch-up in: rows with cm
        # consume [p_k, tok], the rest [tok, pad]; the next-token logits sit
        # at position num_new - 1 = cm.
        first_seq = torch.where(cm[:, None], torch.cat([ctok, tok], 1),
                                F.pad(tok, (0, 1)))
        draft = self._draft_view
        lgd, _ = llama.model_apply(dcfg, dparams, first_seq, draft,
                                   palive * (1 + cmi))
        at = cmi.long()[:, None, None].expand(-1, 1, lgd.shape[-1])
        nxt = torch.argmax(torch.gather(lgd, 1, at)[:, 0], -1).to(i32)
        props = [nxt]
        for _ in range(sk - 1):
            lgd, _ = llama.model_apply(dcfg, dparams, nxt[:, None], draft,
                                       palive)
            nxt = torch.argmax(lgd[:, 0], -1).to(i32)
            props.append(nxt)
        prop = torch.stack(props, 1)                             # [B, k]
        seq = torch.cat([tok, torch.where(spec[:, None], prop, 0)], 1)
        num_new = torch.where(alive, torch.where(spec, sk + 1, 1), 0).to(i32)
        lg, _ = llama.model_apply(self.cfg, self.params, seq, self.cache,
                                  num_new, **self._mkw)
        preds = torch.argmax(lg, -1).to(i32)                     # [B, k + 1]
        sampled = sample(lg[:, 0], st.key, st.sp, st.step)

        # The longest agreeing prefix, then the target's own token.
        agree = (prop == preds[:, :sk]).to(i32)
        acc = torch.cumprod(agree, 1).sum(1).to(i32)             # [B]
        at_acc = torch.gather(preds, 1, acc.long()[:, None])
        cand = torch.where(jidx < acc[:, None], F.pad(prop, (0, 1)), at_acc)
        plain = F.pad(sampled[:, None], (0, sk))
        cand = torch.where(spec[:, None], cand, plain)

        count = torch.where(spec, acc + 1, 1).to(i32) * alive.to(i32)
        # EOS: truncate at the first emitted EOS; budget: at the row's
        # remaining allowance.
        first_eos = torch.where(cand == st.eos[:, None], jidx, sk + 2).amin(1)
        count = torch.minimum(count, first_eos + 1)
        count = torch.minimum(count, (st.budget - st.used).clamp_min(0))
        hit_eos = first_eos < count

        # Rollback: the verify wrote num_new positions; the accepted state
        # is base + count in the target AND the draft (both hold [..., tok,
        # emitted[:count - 1]]; the next round feeds emitted[count - 1]).
        self.cache.lengths.sub_(num_new - count)
        self.draft_cache.lengths.sub_(palive * (sk - count).clamp_min(0))
        # Full acceptance: the draft never consumed its last proposal; it
        # becomes the pending catch-up. Rows that did not speculate this
        # round keep theirs.
        new_ctok = torch.gather(cand, 1,
                                (count - 2).clamp_min(0).long()[:, None])
        last = torch.gather(cand, 1, (count - 1).clamp_min(0).long()[:, None])
        emit = torch.where(jidx < count[:, None], cand, -1)
        st.pack.index_copy_(0, st.step.long(), torch.cat(
            [emit, acc[:, None], palive[:, None]], 1)[None])
        st.ctok.copy_(torch.where(palive[:, None] == 1, new_ctok, ctok))
        st.cm.copy_(torch.where(palive == 1, count == sk + 1, cm))
        st.tok.copy_(torch.where(count[:, None] > 0, last, tok))
        st.alive.copy_(alive & ~hit_eos & (st.used + count < st.budget))
        st.used.add_(count)
        st.step.add_(1)

    # -- capacity ---------------------------------------------------------------

    def _window_ladder(
        self, cap: Optional[int] = None, strict: bool = True
    ) -> Tuple[int, ...]:
        """See :func:`cache.base.window_ladder`; ``decode_windows`` is the
        custom override."""
        return window_ladder(
            cap if cap is not None else self.ecfg.max_seq_len,
            custom=self.ecfg.decode_windows, strict=strict,
        )

    def _ensure_capacity(self, needed_len: int) -> None:
        """Grow the cache's attended span to the smallest ladder bucket
        covering ``needed_len``: dense kinds zero-pad-copy their buffers
        (new buffers: the windows over the old ones go); the paged kind just
        pads TABLE columns (the pool never moves)."""
        if not self._windows or needed_len <= self.cache.max_len:
            return
        if self.allocator is None:
            new_t = next((w for w in self._windows if w >= needed_len),
                         self.ecfg.max_seq_len)
            if new_t > self.cache.max_len:
                self.cache.grow_to(new_t)
                self.metrics.counter("cache_growths")
            return
        ps = self.ccfg.page_size
        slots_needed = -(-needed_len // ps)
        # Ladder entries never exceed max_pages_per_session * page_size
        # (the __init__ cap), so each candidate slot count is in range.
        new_slots = next(
            (-(-w // ps) for w in self._windows
             if -(-w // ps) >= slots_needed),
            self.ccfg.max_pages_per_session,
        )
        pad = new_slots - self.cache.page_table.shape[1]
        if pad > 0:
            self.cache.page_table = F.pad(self.cache.page_table, (0, pad))
            self.metrics.counter("cache_growths")

    def _queue_install(self, row: int, slot_idx: int, page: int) -> None:
        """Defer a page-table install; :meth:`_flush_installs` applies every
        pending one in a single batched scatter."""
        self._pending_installs.append((row, slot_idx, page))

    def _flush_installs(self) -> None:
        if not self._pending_installs:
            return
        # A mesh rank's table holds its own rows only.
        mine = [(r - self._row0, sl, pg) for r, sl, pg in self._pending_installs
                if 0 <= r - self._row0 < self._nrows]
        self._pending_installs = []
        if mine:
            self.cache.assign_pages_batch(*zip(*mine))

    # -- public API -------------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        options: Optional[SamplingOptions] = None,
        deadline: Optional[float] = None,
        sched_key: Optional[tuple] = None,
    ) -> str:
        """Queue a prompt; returns its generation_id. Thread-safe.

        ``deadline`` is an absolute ``time.monotonic()`` instant: past it the
        scheduler reaps the session like a cancel (finish_reason
        ``"deadline"``), whether it is still queued or actively decoding.

        ``sched_key`` is a scheduler's admission-ordering stamp (see
        :meth:`set_admission_order`); sessions without one are admitted
        FIFO."""
        return self._submit_session(
            prompt, options, deadline, sched_key=sched_key
        ).generation_id

    def _submit_session(self, prompt, options, deadline=None,
                        sched_key=None) -> Session:
        # Lock-free on purpose (see __init__): deque.append and dict
        # insertion are GIL-atomic; the scheduler only observes the session
        # at its next admission pass.
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        s = Session(
            prompt=list(prompt),
            options=options or SamplingOptions(),
            deadline=deadline,
            sched_key=sched_key,
        )
        self.sessions[s.generation_id] = s
        self.waiting.append(s)
        self.metrics.counter("sessions_submitted")
        return s

    def set_admission_order(self, fn) -> None:
        """Install an admission-ordering hook:
        ``fn(pending_sessions) -> ordered_sessions``, called under the
        engine lock at each tick with the reaped waiting queue. The engine
        admits a PREFIX of the returned order (free slots and page-pool
        pressure permitting) instead of FIFO-popping. The hook must be a
        pure reordering — a result that drops or invents sessions is
        discarded and the tick falls back to FIFO. Ordering affects WHICH
        sessions are admitted each tick, never the tokens any individual
        session produces. ``None`` restores FIFO."""
        self._admission_order = fn

    def cancel(self, generation_id: str) -> None:
        """Thread-safe and non-blocking: sets a monotonic flag; the
        scheduler converts it to the CANCELLED state at the next tick
        boundary (state transitions stay single-writer)."""
        s = self.sessions.get(generation_id)
        if s is None or s.state == SessionState.FINISHED:
            return
        if s.cancel_time is None:
            s.cancel_time = time.monotonic()
        s.cancel_requested = True

    def step(self) -> List[Tuple[str, int, bool]]:
        """One scheduler tick: admit + decode. Returns
        ``[(generation_id, token, finished), …]`` events. ``token == -1``
        signals a finish without a new token (capacity rejection/exhaustion,
        cancel, deadline) — streaming consumers must not append it.

        Pipelined engines (``EngineConfig.pipelined_ticks``) dispatch the
        next device tick BEFORE resolving the previous one, so a tick's
        tokens arrive one ``step()`` later than they were dispatched."""
        produced: List[Tuple[str, int, bool]] = []
        with self._lock:
            if self._pipelined:
                prev = self._pending
                self._pending = self._dispatch_tick(produced, prev)
                self._resolve_pending(produced, prev)
                # Chunked-prefill co-scheduling rides BEHIND the decode
                # dispatch and after the resolve, so a final chunk's
                # deferred first token rides the NEXT tick's fetch exactly
                # like an overlapped admission.
                self._chunk_dispatch(produced)
                self._admit(produced)
            else:
                self._admit(produced)
                self._chunk_dispatch(produced)
                if any(
                    gid is not None and not self.sessions[gid].chunking
                    for gid in self.slots
                ):
                    self._decode_tick(produced)
                elif self._spec_pending is not None:
                    # Every session left with a speculative tick in flight
                    # and nothing was admitted: _decode_tick will not run
                    # to drain it, so resolve it here (else has_work()
                    # would report the orphaned tick forever).
                    self._spec_flush(produced)
        return produced

    def has_work(self) -> bool:
        with self._lock:
            return (
                bool(self.waiting)
                or any(s is not None for s in self.slots)
                or self._pending is not None
                or bool(self._inflight_admits)
                or self._spec_pending is not None
            )

    def active_sessions(self) -> int:
        """Resident sessions. Lock-free snapshot for observability."""
        return sum(1 for g in self.slots if g is not None)

    def queue_depth(self) -> int:
        """Sessions waiting for a slot. Lock-free snapshot."""
        return len(self.waiting)

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        options: Optional[SamplingOptions] = None,
        max_steps: int = 100_000,
    ) -> List[List[int]]:
        """Blocking convenience API: run all prompts to completion."""
        # Hold the Session objects themselves: a concurrent
        # collect_finished() may reap the dict entries at any point.
        subs = [self._submit_session(p, options) for p in prompts]
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return [s.generated for s in subs]

    def collect_finished(self) -> Dict[str, Session]:
        """Remove and return finished/cancelled sessions. Callers that stream
        via ``step()`` must collect periodically or host memory grows with
        total requests served."""
        with self._lock:
            # list(): submit() inserts into the dict lock-free; a snapshot
            # keeps concurrent submission from breaking this iteration.
            done = {
                gid: s
                for gid, s in list(self.sessions.items())
                if s.state in (SessionState.FINISHED, SessionState.CANCELLED)
                and s.slot is None
            }
            for gid in done:
                del self.sessions[gid]
            return done

    # -- scheduler ----------------------------------------------------------------

    def _next_key(self) -> int:
        """One sampling key (a seed for :func:`sample`) from the engine's
        generator. Drawn once per dispatch, greedy or not, so the key order
        depends on the dispatch sequence alone."""
        return int(
            torch.randint(0, 2**62, (1,), generator=self.generator).item()
        )

    def _bucket_for(self, n: int) -> int:
        # The admission-partition key, in ragged mode too (plan docstring:
        # partition == sampling-key order), even though pad widths differ.
        return self.plan.bucket_for(n)

    def _max_chunk(self) -> int:
        """Largest prefill chunk the cache accepts: the sink ring's span at
        most."""
        if isinstance(self.cache, _SINK_KINDS):
            return min(self.ecfg.prefill_buckets[-1],
                       self.ccfg.window_length - self.ccfg.num_sink_tokens)
        return self.ecfg.prefill_buckets[-1]

    def _capacity_ok(self, s: Session) -> bool:
        """The prompt and one token fit a session: the dense buffers' cap,
        or the pages a session may map; any prompt fits the sink ring."""
        if isinstance(self.cache, _SINK_KINDS):
            return True
        limit = (self.ecfg.max_seq_len if self.allocator is None
                 else self.ccfg.max_pages_per_session * self.ccfg.page_size)
        return len(s.prompt) + 1 <= limit

    def _sink_cap(self) -> int:
        """Stream-length bound of a sink session. The model-dtype ring
        rotates at window-relative (bounded) positions: only its int32
        counter bounds it. The int8 ring stores keys rotated at ABSOLUTE
        positions, whose f32 angles (``pos * inv_freq``) lose about ``pos *
        6e-8`` rad on the fastest channel: 2^20 tokens (about 0.06 rad)."""
        return (1 << 20) if isinstance(self.cache, QuantizedSinkKVCache) else (
            1 << 30)

    def _span(self) -> int:
        """The cache width a decode dispatch attends over, for the plan's
        dispatch shapes: the page table's columns, or the dense T."""
        if self.allocator is None:
            return self.cache.max_len
        return self.cache.page_table.shape[1]

    def _shrink_if_idle(self) -> None:
        """With no resident sessions, shrink the cache back to its first
        width: one long-context session must not pin its high-water buffer
        or table width (the decode traffic) for the rest of the process. A
        dense cache is re-created at the first rung (nothing to copy); the
        paged table is truncated."""
        if not self._windows or any(g is not None for g in self.slots):
            return
        if self.allocator is None:
            if self.cache.max_len > self._windows[0]:
                c = self.cache
                self.cache = type(c).create(
                    self.cfg.num_layers, self._nrows, self._windows[0],
                    self.cfg.num_kv_heads, self.cfg.head_dim, self.dtype,
                    device=self.device,
                    **({"use_kernel": c.use_kernel}
                       if isinstance(c, QuantizedDenseKVCache) else {}),
                )
            return
        if self.cache.page_table.shape[1] > self._first_slots:
            # With no resident sessions every row is either already reset or
            # will be reset at its next admission.
            self.cache.page_table = self.cache.page_table[
                :, : self._first_slots
            ].contiguous()

    def _admit(self, produced) -> None:
        # Installs queued by a tick that ended up dispatching nothing must
        # land before _shrink_if_idle can re-shape the table.
        self._flush_installs()
        # Reap sessions cancelled or deadline-expired since the last tick
        # (cancel() only sets the flag; deadlines are observed here, at tick
        # boundaries). Each reap emits a terminal ``(gid, -1, True)`` event
        # so streaming consumers see every stream end.
        now = time.monotonic()
        for slot, gid in enumerate(self.slots):
            if gid is None:
                continue
            s = self.sessions[gid]
            expired = _expired(s, now)
            if (s.cancel_requested or expired) and s.slot is not None:
                s.state = SessionState.CANCELLED
                s.finish_reason = "deadline" if expired else "cancelled"
                if expired:
                    self.metrics.counter("sessions_deadline_expired")
                self._release(s)
                produced.append((gid, -1, True))
        self._shrink_if_idle()
        admitted: List[Tuple[Session, int]] = []
        free_slots = [i for i in range(self.batch) if self.slots[i] is None]
        candidates: List[Session] = []
        if free_slots and self.waiting:
            # Reap cancelled/expired entries anywhere in the queue; each reap
            # emits the terminal event streaming consumers are owed.
            for dropped in [
                w for w in self.waiting
                if w.cancel_requested
                or (w.deadline is not None and now >= w.deadline)
            ]:
                self.waiting.remove(dropped)
                dropped.state = SessionState.CANCELLED
                if _expired(dropped, now):
                    dropped.finish_reason = "deadline"
                    self.metrics.counter("sessions_deadline_expired")
                else:
                    dropped.finish_reason = "cancelled"
                produced.append((dropped.generation_id, -1, True))
            candidates = list(self.waiting)
            if self._admission_order is not None and len(candidates) > 1:
                # Defensive: a result that is not a permutation of the queue
                # is discarded — a buggy policy must never lose or invent
                # sessions.
                try:
                    ordered = list(self._admission_order(candidates))
                except Exception:  # noqa: BLE001 - policy must not kill ticks
                    ordered = candidates
                if len(ordered) == len(candidates) and (
                    {id(x) for x in ordered} == {id(x) for x in candidates}
                ):
                    candidates = ordered
        if candidates and free_slots:
            # ONE capacity widen for the whole admission burst (the
            # per-session _ensure_capacity below then no-ops).
            needs = [
                len(c.prompt) + 1
                for c in candidates[: len(free_slots)]
                if self._capacity_ok(c)
            ]
            if needs:
                self._ensure_capacity(max(needs))
        ci = 0
        for slot in free_slots:
            if ci >= len(candidates):
                break
            s = candidates[ci]
            ci += 1
            if not self._capacity_ok(s):
                self.waiting.remove(s)
                self._finish(s, "capacity", produced)
                self.metrics.counter("sessions_rejected")
                continue
            self._ensure_capacity(len(s.prompt) + 1)
            shared_len = 0
            if self.allocator is not None:
                ps = self.ccfg.page_size
                n = len(s.prompt)
                need = math.ceil((n + 1) / ps)
                shared: List[int] = []
                cow = False
                if self.ccfg.prefix_caching:
                    if s.prefix_keys is None:
                        s.prefix_keys = PageAllocator.chain_keys(s.prompt, ps)
                    # With CoW sharing every FULL prompt page is eligible: a
                    # fully matched final page is split copy-on-write below
                    # so the last prompt token (whose logits seed the first
                    # sample) recomputes into a private copy. Without it,
                    # cap so the last token's page is never shared.
                    cap = n // ps if self.pcfg.prefix_share else (n - 1) // ps
                    shared = self.allocator.lookup(s.prefix_keys[:cap])
                    if self._spill is not None and len(shared) < cap:
                        shared = self._reload_spilled(s.prefix_keys, shared,
                                                      cap)
                    # n > 1: a fully shared 1-token prompt (page_size 1)
                    # would leave nothing to prefill, no logits to sample
                    # from: it drops the match and recomputes instead.
                    cow = bool(shared) and len(shared) * ps == n and n > 1
                    if not cow and shared and len(shared) * ps == n:
                        self.allocator.free([shared.pop()])
                # CoW takes one extra page for the private copy of the fully
                # shared final page.
                if need - len(shared) + cow > self.allocator.free_count:
                    if shared:
                        self.allocator.free(shared)  # return the refs
                    break  # pool pressure: hold the queue, retry next tick
            # Reset the row BEFORE installing pages (reset wipes the row's
            # page table); the installs are queued and flushed once, right
            # before the prefill dispatch.
            self.cache.reset_rows(self._local_row_mask(slot))
            if self.draft is not None:
                self.draft_cache.reset_rows(
                    torch.arange(self.batch, device=self.device) == slot
                )
            if self.allocator is not None:
                fresh = self.allocator.alloc(need - len(shared) + cow)
                s.pages = shared + fresh  # owned: _release frees
                if cow:
                    # Copy-on-write split: the write offset (skip = n-1)
                    # lands INSIDE the last shared page, so the first fresh
                    # page takes its table slot. The device copy is deferred
                    # to dispatch time (_run_prefill), behind any same-tick
                    # writer's prefill; the source ref waits on s.cow_src.
                    k = len(shared) - 1
                    s.cow_src = s.pages[k]
                    s.pages[k] = s.pages.pop(k + 1)
                    self.metrics.counter("prefix_cow_copies")
                for i, pg in enumerate(s.pages):
                    self._queue_install(slot, i, pg)
                shared_len = n - 1 if cow else len(shared) * ps
                if shared_len:
                    self.cache.lengths[slot] = shared_len
                    self.metrics.counter("prefix_pages_shared", len(shared))
                if self.ccfg.prefix_caching:
                    self._note_prefix(n, shared_len)
                    if self.pcfg.prefix_share:
                        # Register-at-admission: this session's full prompt
                        # pages become shareable NOW, so concurrent sessions
                        # attach to them while the writer decodes. Safe on
                        # one stream: owned pages hold refs >= 1 (never
                        # evicted), and a same-tick sharer dispatches after
                        # the writer (groups before singles, singles in
                        # admission order, a sharer has skip > 0: a single).
                        for i, key in enumerate(s.prefix_keys):
                            if i >= len(s.pages):
                                break
                            self.allocator.register(s.pages[i], key)
            self.waiting.remove(s)
            s.slot = slot
            s.state = SessionState.ACTIVE
            self.slots[slot] = s.generation_id
            admitted.append((s, shared_len))
        self._dispatch_prefills(admitted, produced)

    def _dispatch_prefills(self, admitted, produced) -> None:
        """Prefill freshly admitted ``(session, skip)`` pairs: same-bucket
        groups of >= 2 prompts that need no chunking and skip no shared
        prefix go through ONE batched dispatch each; the rest keep the
        single-row path. Groups dispatch before singles, so a same-tick
        writer's prefill is enqueued before any sharer's."""
        if not admitted:
            return
        singles: List[Tuple[Session, int]] = []
        groups: Dict[int, List[Session]] = {}
        chunk_cap = self._max_chunk()
        for s, skip in admitted:
            if (self._batch_admission and skip == 0
                    and len(s.prompt) <= chunk_cap):
                groups.setdefault(
                    self._bucket_for(len(s.prompt)), []
                ).append(s)
            else:
                singles.append((s, skip))
        for bucket, group in groups.items():
            if len(group) < 2:
                singles.extend((s, 0) for s in group)
                continue
            while group:
                self._prefill_group(group[:8], bucket, produced)
                group = group[8:]
        if any(skip for _, skip in singles):
            # A sharer may have attached to pages a same-tick writer has yet
            # to prefill: singles then go in admission order, which puts
            # every writer first. (The JAX engine appends a lone bucket's
            # writer after the singles, so there a same-tick sharer reads
            # the writer's pages before they are written.)
            rank = {id(s): i for i, (s, _) in enumerate(admitted)}
            singles.sort(key=lambda e: rank[id(e[0])])
        for s, skip in singles:
            # Long greedy prompts may park for chunk/decode co-scheduling
            # instead of a monolithic synchronous prefill; _chunk_admit draws
            # the session's key HERE — the same stream position the
            # synchronous path would consume — so parking never perturbs the
            # engine's key order.
            if self._chunk_admit(s, skip):
                continue
            self._run_prefill(s, produced, skip)

    def _overlap_ok(self) -> bool:
        """Overlap THIS admission with the in-flight tick? Requires the
        pipelined carry (so the next tick consumes the deferred first token
        without a host fetch), a tick actually in flight (otherwise the
        synchronous path is already stall-free), and head-room under the
        in-flight cap (back-pressure: an admission flood spills to the
        synchronous path instead of queueing unbounded prefill work)."""
        if not (
            self.ecfg.overlap_admission
            and self._pipelined
            and self._pending is not None
            and self.mesh is None
        ):
            return False
        if (
            len(self._inflight_admits)
            >= max(1, self.ecfg.overlap_admission_max_inflight)
        ):
            self.metrics.counter("admit_overlap_spill")
            return False
        return True

    def _defer_admit(self, group, toks_dev, rows, skips) -> None:
        """Record an overlapped admission: the prefill is enqueued; the
        sampled first tokens stay on the device, scatter into the pipelined
        carry (the next tick consumes them with no host round trip), and
        start their copy to pinned host memory. ``_admit_pend`` charges one
        in-flight token per row; ``_resolve_pending`` delivers at the next
        tick boundary. ``skips``: each session's shared-prefix tokens, for
        its ``prefill_tokens`` count then."""
        toks_dev = toks_dev.reshape(-1)
        self._carry_scatter(toks_dev, rows)
        host, ready = self._to_host(toks_dev)
        now = time.monotonic()
        for s in group:
            s.prefill_inflight = True
            s.prefill_dispatch_t = now
            self._carry_ok[s.slot] = True
            self._admit_pend[s.slot] = 1
        self._inflight_admits.append(
            (list(group), toks_dev, host, ready, list(skips)))
        self.metrics.counter("admit_overlap_sessions", len(group))
        self.metrics.gauge(
            "admit_overlap_inflight", float(len(self._inflight_admits))
        )

    def _to_host(self, t: torch.Tensor):
        """Start copying ``t`` to pinned host memory behind the work queued
        on the card; returns ``(host tensor, event)`` — the copy is complete
        once the event is (None on the CPU, where there is nothing to
        wait for)."""
        if t.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    # Device-side carry updates (the JAX engine's jitted helpers).

    def _carry_combine(self, fresh, use_carry) -> torch.Tensor:
        return torch.where(use_carry[:, None], self._carry, fresh)

    def _carry_merge(self, em_last, act) -> None:
        old = (
            self._carry if self._carry is not None
            else torch.zeros((self.batch, 1), dtype=torch.int32,
                             device=self.device)
        )
        self._carry = torch.where(act[:, None], em_last[:, None], old)

    def _carry_scatter(self, toks, rows) -> None:
        """Deferred first tokens land in the carry at their rows; padding
        entries (an out-of-range row) are dropped."""
        rows = np.asarray(rows)
        keep = np.nonzero(rows < self.batch)[0]
        self._carry[to_device(rows[keep], torch.int64, self.device), 0] = (
            toks[to_device(keep, torch.int64, self.device)]
        )

    def _prefill_group(self, group, bucket, produced) -> None:
        """One batched prefill dispatch for <= 8 same-bucket sessions. Rows
        pad to a power of two with placeholder rows (``n_valid = 0``: no
        write, no delivery)."""
        self._flush_installs()
        k = len(group)
        nr = 2
        while nr < k:
            nr *= 2
        # Padding entries use an OUT-OF-RANGE row: select_rows clamps the
        # gather, merge_rows drops the write-back.
        rows = np.full((nr,), self.batch, np.int32)
        n_valid = np.zeros((nr,), np.int32)
        # Ragged mode pads every group to ONE width per row count (the group
        # keeps its bucket-keyed MEMBERSHIP — that is the key partition —
        # only the pad width changes).
        width = self.plan.group_shape(bucket, self._max_chunk())
        tokens = np.zeros((nr, width), np.int32)
        opts = [SamplingOptions()] * nr
        for i, s in enumerate(group):
            rows[i] = s.slot
            n_valid[i] = len(s.prompt)
            tokens[i, : len(s.prompt)] = s.prompt
            opts[i] = s.options
        sp = SamplingParams.stack(opts, self.device)
        self.plan.note_dispatch("prefill", (nr, width), int(n_valid.sum()))
        with self.metrics.timer("prefill"):
            toks = self._prefill_batch(
                self._i32(tokens), rows, n_valid, self._next_key(), sp
            )
            if self._overlap_ok():
                # Everything above was enqueued only; the token fetch waits
                # for the next tick boundary.
                self.metrics.counter("batched_prefills", k)
                self._defer_admit(group, toks, rows, [0] * k)
                return
            toks = toks.cpu().numpy()  # the one sync of this admission
        self.metrics.counter("batched_prefills", k)
        self.metrics.counter("admit_sync_sessions", k)
        for i, s in enumerate(group):
            self._finish_prefill(s, int(toks[i]), produced, 0)

    def _cow_copy(self, s: Session, skip: int) -> None:
        """Enqueue the deferred copy-on-write split of ``s``'s fully shared
        final page into its private page, then drop the parked source ref.
        Done at dispatch time, not at admission: on the one stream, the
        copy then follows any same-tick writer's prefill of the source."""
        if s.cow_src is None:
            return
        self.cache.copy_page(s.pages[skip // self.ccfg.page_size], s.cow_src)
        self.allocator.free([s.cow_src])
        s.cow_src = None

    def _run_prefill(self, s: Session, produced, skip: int = 0) -> None:
        """Chunked, padded prefill of one admitted session; samples the
        first generated token from the final chunk. ``skip`` tokens at the
        head are already in the cache (shared prefix pages): the row's
        write offset (``lengths``) was set past them at admission."""
        self._flush_installs()  # prefill writes through the page table
        self._cow_copy(s, skip)
        chunk_cap = self._max_chunk()
        prompt = np.asarray(s.prompt, np.int32)
        sp = SamplingParams.create(
            1, s.options.temperature, s.options.top_k, s.options.top_p,
            self.device,
        )
        if self._sp > 1 and skip == 0 and len(prompt) > self._ring_threshold():
            # Sequence-parallel: the whole prompt in one dispatch, each sp
            # rank computing bucket / sp positions; the ring's KV goes into
            # the row through the cache's ingest_row, and decode proceeds
            # as after a chunked prefill. Synchronous, as in the JAX engine.
            padded = np.zeros((1, self._ring_bucket(len(prompt))), np.int32)
            padded[0, : len(prompt)] = prompt
            with self.metrics.timer("prefill"):
                token = self._row_prefill(
                    self._i32(padded), s.slot, len(prompt), self._next_key(),
                    sp, ring=True)
            self.metrics.counter("ring_prefills")
            self.metrics.counter("admit_sync_sessions")
            self._finish_prefill(s, int(token), produced, skip)
            return
        offset = skip
        stride = self.plan.prefill_stride(chunk_cap)
        with self.metrics.timer("prefill"):
            while len(prompt) - offset > stride:
                chunk = prompt[offset : offset + stride]
                self.plan.note_dispatch("chunk", (1, stride), len(chunk))
                self._prefill_ns(self._i32(chunk[None, :]), s.slot, len(chunk))
                offset += stride
            rest = prompt[offset:]
            width = self.plan.final_shape(len(rest), chunk_cap)
            padded = np.zeros((1, width), np.int32)
            padded[0, : len(rest)] = rest
            self.plan.note_dispatch("prefill", (1, width), len(rest))
            token = self._prefill(
                self._i32(padded), s.slot, len(rest), self._next_key(), sp
            )
        if self._overlap_ok():
            # Single-row admissions defer the token fetch exactly like the
            # batched path.
            self._defer_admit([s], token, np.asarray([s.slot], np.int32),
                              [skip])
            return
        self.metrics.counter("admit_sync_sessions")
        self._finish_prefill(s, int(token), produced, skip)

    def _ring_threshold(self) -> int:
        thr = self.ecfg.ring_prefill_threshold
        return thr if thr is not None else self.ecfg.prefill_buckets[-1]

    def _ring_bucket(self, n: int) -> int:
        """Padded ring length for an ``n``-token prompt: the doubling ladder
        above the largest prefill bucket, capped at ``max_seq_len`` (the
        ingest crops anything above it), rounded up to a multiple of the
        ``sp`` degree."""
        b = self.ecfg.prefill_buckets[-1]
        while b < n:
            b *= 2
        b = min(b, max(n, self.ecfg.max_seq_len))
        return -(-b // self._sp) * self._sp

    def _chunk_admit(self, s: Session, skip: int) -> bool:
        """Park an admitted long GREEDY prompt for chunk/decode
        co-scheduling instead of a monolithic synchronous prefill: the
        session holds its slot (decode-ineligible) while _chunk_dispatch
        walks the prompt one ``plan.prefill_stride`` chunk per granted tick
        beside the live decode batch. Returns False — caller runs the
        synchronous path — unless eligible (ragged mode on, greedy, long
        enough, and at least one OTHER live row to ride beside; alone, the
        standalone prefill is strictly better for TTFT); never with a draft
        model (its prompt mirror and speculative ticks take whole prompts)."""
        if self.mesh is not None or self.draft is not None:
            return False
        if not self.plan.co_schedule_ok(
            len(s.prompt) - skip, s.options.temperature, self._max_chunk()
        ):
            return False
        if self.ccfg.prefix_caching and self.pcfg.prefix_share:
            # Register-at-admission already made this prompt's pages
            # shareable; stretching the writes over ticks would let a later
            # admission attach to pages whose KV is not written yet. Keep
            # the synchronous path (its writer-before-sharer dispatch order
            # is what makes register-at-admission safe).
            return False
        # Park only when another row is decode-LIVE (first token already
        # sampled — a same-tick co-admission that has not prefilled yet does
        # not count).
        others = any(
            gid is not None
            and gid != s.generation_id
            and not self.sessions[gid].chunking
            and self.sessions[gid].generated
            for gid in self.slots
        )
        if not others:
            return False
        # The deferred CoW split goes before any chunk writes this row.
        self._cow_copy(s, skip)
        s.chunking = True
        s.chunk_off = skip
        s.chunk_skip = skip
        # Draw the admission key NOW — the stream position the synchronous
        # prefill would have consumed — and park it for the final chunk's
        # sample, so co-scheduling never perturbs the engine's key order.
        s.parked_key = self._next_key()
        self._chunking.append(s)
        return True

    def _chunk_dispatch(self, produced) -> None:
        """Advance co-scheduled chunked prefills by one chunk per granted
        tick (``plan.take_chunk_credit`` rations grants at
        ``chunk_decode_share`` against live decode; full speed when no decode
        rows remain). Interior chunks are keyless cache writes — the same
        program the synchronous chunk loop runs — and the final chunk
        samples the first token with the session's parked admission key."""
        if not self._chunking:
            return
        decode_active = any(
            gid is not None and not self.sessions[gid].chunking
            for gid in self.slots
        )
        if not self.plan.take_chunk_credit(decode_active):
            return
        chunk_cap = self._max_chunk()
        stride = self.plan.prefill_stride(chunk_cap)
        for s in list(self._chunking):
            if s.state is not SessionState.ACTIVE or s.slot is None:
                # A cancel/deadline reap already released the row (and
                # cleared the chunking flags) — just drop the parked entry.
                if s in self._chunking:
                    self._chunking.remove(s)
                continue
            self._flush_installs()  # chunk writes go through the table
            prompt = np.asarray(s.prompt, np.int32)
            rest = len(prompt) - s.chunk_off
            if rest > stride:
                chunk = prompt[s.chunk_off : s.chunk_off + stride]
                self.plan.note_dispatch("chunk", (1, stride), len(chunk))
                with self.metrics.timer("prefill"):
                    self._prefill_ns(
                        self._i32(chunk[None, :]), s.slot, len(chunk)
                    )
                s.chunk_off += stride
                self.plan.note_chunk_rows()
                continue
            width = self.plan.final_shape(rest, chunk_cap)
            padded = np.zeros((1, width), np.int32)
            padded[0, :rest] = prompt[s.chunk_off :]
            sp = SamplingParams.create(
                1, s.options.temperature, s.options.top_k, s.options.top_p,
                self.device,
            )
            self.plan.note_dispatch("prefill", (1, width), rest)
            with self.metrics.timer("prefill"):
                token = self._prefill(
                    self._i32(padded), s.slot, rest, s.parked_key, sp
                )
            self.plan.note_chunk_rows()
            s.chunking = False
            s.parked_key = None
            self._chunking.remove(s)
            if self._overlap_ok():
                self._defer_admit([s], token, np.asarray([s.slot], np.int32),
                                  [s.chunk_skip])
                continue
            self.metrics.counter("admit_sync_sessions")
            # int(): the one sync per admission, as in _run_prefill.
            self._finish_prefill(s, int(token), produced, s.chunk_skip)

    def _finish_prefill(self, s, token, produced, skip):
        self._deliver(s, int(token), produced)
        self.metrics.counter("prefill_tokens", len(s.prompt) - skip)
        if s.slot is not None and self._session_speculative(s):
            # Mirror the FULL prompt into the draft cache (no prefix sharing
            # there; proposals start right after the prompt).
            self._draft_mirror(s.prompt, s.slot)

    def _draft_mirror(self, tokens, slot: int) -> None:
        """Chunked prefill of ``tokens`` into the draft cache's ``slot``
        row: the admission-time prompt mirror and the adaptive resume's
        resync share it, so their chunking cannot drift apart."""
        tokens = np.asarray(tokens, np.int32)
        cap = self.ecfg.prefill_buckets[-1]
        off = 0
        while len(tokens) - off > cap:
            chunk = tokens[off : off + cap]
            self._draft_prefill(self._i32(chunk[None, :]), slot, len(chunk))
            off += cap
        rest = tokens[off:]
        padded = np.zeros((1, self._bucket_for(len(rest))), np.int32)
        padded[0, : len(rest)] = rest
        self._draft_prefill(self._i32(padded), slot, len(rest))

    def _session_wants_spec(self, s: Session) -> bool:
        return (
            self.draft is not None
            and s.options.speculative
            and s.options.temperature == 0.0
        )

    def _session_speculative(self, s: Session) -> bool:
        """Speculating NOW: wants it, and the adaptive controller has not
        suspended speculation engine-wide (the greedy streams are the same
        either way)."""
        return self._session_wants_spec(s) and not self._spec_suspended

    # -- adaptive speculation (a throughput A/B controller) ---------------

    def _draft_resync_all(self) -> None:
        """Re-mirror every speculative session's accepted stream (prompt +
        generated[:-1]) into the draft cache: plain ticks advanced the
        sessions without the draft."""
        for slot, gid in enumerate(self.slots):
            if gid is None:
                continue
            s = self.sessions[gid]
            if not self._session_wants_spec(s):
                continue
            self.draft_cache.reset_rows(
                torch.arange(self.batch, device=self.device) == slot)
            self._draft_mirror(list(s.prompt) + s.generated[:-1], slot)

    def _spec_suspend(self, produced) -> None:
        if self._spec_pending is not None:
            self._spec_flush(produced)
        self._spec_suspended = True

    def _spec_resume(self) -> None:
        self._draft_resync_all()
        # Fresh tokens next dispatch; the device-carried catch-up pair is
        # gated off with the carry (the resync consumed everything).
        self._spec_carry_ok[:] = False
        self._spec_suspended = False

    def _decode_tokens_total(self) -> float:
        return self.metrics.get_counter("decode_tokens")

    def _spec_adapt(self, produced) -> None:
        """Windowed throughput controller (config.py's speculative_probe_*
        knobs): measures tokens/s a resident speculative row on the current
        path over windows of ``probe_len`` ticks; when the speculative
        tokens-per-round sags below the break-even band it probes the plain
        path, serves whichever measured faster, and re-probes speculation
        every ``probe_period`` ticks. The streams are the same in both
        modes."""
        if self.draft is None or not self.ecfg.speculative_adaptive:
            return
        c = self._spec_ctl
        nspec = sum(
            1 for g in self.slots
            if g is not None and self._session_wants_spec(self.sessions[g])
        )
        if nspec == 0:
            # Disengaged: the next engaged window must not span this gap.
            c["win_t0"] = None
            return
        now = self._spec_clock()
        tokens = self._decode_tokens_total()
        comp = tuple(self.slots)
        if comp != c.get("comp"):
            # The resident set changed mid-window: its tokens/s would mix
            # two sets and bias the comparison, so the window starts again.
            c["comp"] = comp
            if c["win_t0"] is not None:
                self.metrics.counter("spec_adapt_window_resets")
            c.update(win_t0=now, win_tok0=tokens, win_ticks=0,
                     stat0=dict(self.spec_stats))
            return
        if c["win_t0"] is None or c.get("skip", 0) > 0:
            # (Re-)baseline after a gap and for the first tick after a mode
            # change, which carries the change's flushed and resynced work.
            c["skip"] = max(0, c.get("skip", 0) - 1)
            c.update(win_t0=now, win_tok0=tokens, win_ticks=0,
                     stat0=dict(self.spec_stats))
            return
        c["win_ticks"] += 1
        if c["win_ticks"] < max(2, self.ecfg.speculative_probe_len):
            return
        # Window boundary: fold this window's rate a resident speculative
        # row into the mode's EMA (occupancy may differ between windows).
        rate = ((tokens - c["win_tok0"]) / max(now - c["win_t0"], 1e-9)
                / nspec)
        mode = c["mode"]
        rkey = ("plain_rate" if mode in ("probe_plain", "plain")
                else "spec_rate")
        c[rkey] = rate if c[rkey] is None else 0.5 * c[rkey] + 0.5 * rate
        if mode in ("spec", "probe_spec"):
            steps_d = self.spec_stats["steps"] - c["stat0"]["steps"]
            if steps_d > 0:
                tpr = 1.0 + (self.spec_stats["accepted"]
                             - c["stat0"]["accepted"]) / steps_d
                c["tpr_ema"] = tpr if c["tpr_ema"] is None else (
                    0.5 * c["tpr_ema"] + 0.5 * tpr)
        c.update(win_t0=now, win_tok0=tokens, win_ticks=0,
                 stat0=dict(self.spec_stats))
        c["cooldown"] = max(0, c["cooldown"] - 1)

        k = self.ecfg.speculative_k
        gate = (self.ecfg.speculative_probe_below
                if self.ecfg.speculative_probe_below is not None
                else 0.55 * (k + 1))
        period_windows = max(
            1, self.ecfg.speculative_probe_period
            // max(2, self.ecfg.speculative_probe_len))
        if mode == "spec":
            if (c["tpr_ema"] is not None and c["tpr_ema"] < gate
                    and c["cooldown"] == 0):
                self._spec_suspend(produced)
                c.update(mode="probe_plain", win_t0=None, skip=1)
                self.metrics.counter("spec_adapt_probes")
        elif mode == "probe_plain":
            # One full window of plain measured: decide.
            if c["plain_rate"] > (c["spec_rate"] or 0.0):
                c["mode"] = "plain"
                self.metrics.counter("spec_adapt_suspensions")
            else:
                self._spec_resume()
                c.update(mode="spec", win_t0=None, skip=1)
            c["cooldown"] = period_windows
        elif mode == "plain":
            if c["cooldown"] == 0:
                self._spec_resume()
                c.update(mode="probe_spec", win_t0=None, skip=1)
        elif mode == "probe_spec":
            if (c["spec_rate"] or 0.0) >= (c["plain_rate"] or 0.0):
                c["mode"] = "spec"
            else:
                self._spec_suspend(produced)
                c.update(mode="plain", win_t0=None, skip=1)
            c["cooldown"] = period_windows

    def _dispatch_tick(self, produced, prev):
        """Enqueue the next fused K-step tick from the device-resident
        token carry (tick N-1's final sampled tokens): no host fetch on the
        input path, so the card's queue never drains between ticks.
        Returns the new pending record, or None when nothing was
        dispatched.

        Budgets are CONSERVATIVE: they assume the in-flight tick (``prev``)
        delivers its full budget, so a session never over-writes its
        ``max_new_tokens`` or its pages; a row whose conservative budget
        is zero idles one tick instead of rolling anything back."""
        K = self.decode_steps
        if prev is not None:
            # A slot whose tenant changed since the in-flight tick was
            # dispatched (finish -> admit) is not charged the previous
            # tenant's pending budget.
            pend_b = np.where(
                np.array([g == pg for g, pg in zip(self.slots, prev[3])]),
                prev[1], 0,
            )
        else:
            pend_b = np.zeros((self.batch,), np.int32)
        # A row whose in-flight budget was cut below K (page capacity) stops
        # before that window's last step: its carry will hold -1, and the
        # host learns its last token only at the resolve. It idles a tick.
        cut = (pend_b > 0) & (pend_b < K)
        if self._admit_pend.any():
            # Overlapped admissions dispatched last tick: each row's first
            # token is still in flight (this tick consumes it via the
            # carry) — charged like in-flight tick budget.
            pend_b = pend_b + self._admit_pend
        fresh = np.zeros((self.batch, 1), np.int32)
        use_carry = np.zeros((self.batch,), np.bool_)
        opts: List[SamplingOptions] = [SamplingOptions()] * self.batch
        budget = np.zeros((self.batch,), np.int32)
        for slot, gid in enumerate(self.slots):
            if gid is None:
                continue
            s = self.sessions[gid]
            if s.chunking or cut[slot]:
                # Mid chunked-prefill (holds its slot but is not
                # decode-eligible until its final chunk samples), or cut.
                continue
            opts[slot] = s.options
            fresh[slot, 0] = s.last_token
            use_carry[slot] = self._carry_ok[slot]
            pend = int(pend_b[slot])
            paged = self.allocator is not None
            if isinstance(self.cache, _SINK_KINDS):
                cap = self._sink_cap()  # the ring evicts: no capacity
            elif paged:
                cap = len(s.pages) * self.ccfg.page_size
            else:
                cap = self.ecfg.max_seq_len
            if pend == 0 and s.total_len + 1 > cap:
                if paged:
                    # One more growth attempt before declaring capacity.
                    cap = self._grow_pages(s, 1)
                if s.total_len + 1 > cap:
                    # Nothing in flight for this row and no room for one
                    # more token: the session ends here.
                    self._finish(s, "capacity", produced)
                    continue
            desired = max(0, min(
                K, s.options.max_new_tokens - len(s.generated) - pend
            ))
            if paged and desired > 0:
                # Pages must cover the in-flight tick's budget AND this one.
                cap = self._grow_pages(s, pend + desired)
            budget[slot] = max(0, min(desired, cap - s.total_len - pend))
        active = np.array(
            [g is not None for g in self.slots], np.bool_
        ) & (budget > 0)
        if not active.any():
            return None
        if self._windows:
            self._ensure_capacity(max(
                self.sessions[g].total_len + int(pend_b[i]) + int(budget[i])
                for i, g in enumerate(self.slots) if g is not None
            ))
        sp = SamplingParams.stack(opts, self.device)
        eos_ids = np.asarray([o.eos_token_id for o in opts], np.int32)
        fresh_dev = self._i32(fresh)
        tokens_dev = (
            fresh_dev if self._carry is None
            else self._carry_combine(
                fresh_dev, to_device(use_carry, torch.bool, self.device))
        )
        # An idle row's carry may hold -1 (it stopped before its last
        # window's end, or its budget was cut): it computes without writing
        # or emitting, but its token must still index the embedding.
        tokens_dev = tokens_dev.clamp_min(0)
        act_dev = to_device(active, torch.bool, self.device)
        self._flush_installs()
        self.plan.note_dispatch("decode", (self.batch, K, self._span()))
        with self.metrics.timer("decode_step"):
            emitted = self._decode_k(
                tokens_dev, act_dev, self._next_key(), sp,
                self._i32(eos_ids), self._i32(budget),
            )
        self._carry_merge(emitted[-1], act_dev)
        self._carry_ok = self._carry_ok | active
        host, ready = self._to_host(emitted)
        return (host, budget, active, list(self.slots), ready)

    def _resolve_pending(self, produced, prev) -> None:
        """Deliver the PREVIOUS tick's tokens (their copy overlapped the
        tick just dispatched). A row that stopped before its window's last
        step but keeps serving gets its device carry invalidated: the next
        dispatch feeds it the host-known last token.

        Overlapped admissions dispatched last step resolve here too: their
        first tokens were copied behind the same queue; then the usual
        prefill bookkeeping runs. Sessions cancelled while their prefill
        was in flight drop the token (``_deliver``'s guard); the admission
        reap frees their slot and pages right after."""
        admits, self._inflight_admits = self._inflight_admits, []
        if prev is None and not admits:
            return
        with self.metrics.timer("decode_resolve"):
            for _, _, _, ready, _ in admits:
                if ready is not None:
                    ready.synchronize()
            if prev is not None and prev[4] is not None:
                prev[4].synchronize()
        if admits:
            self._admit_pend[:] = 0
            self.metrics.gauge("admit_overlap_inflight", 0.0)
            now = time.monotonic()
            for group, _, host, _, skips in admits:
                toks = host.numpy().reshape(-1)
                for i, s in enumerate(group):
                    s.prefill_inflight = False
                    if s.prefill_dispatch_t is not None:
                        self.metrics.observe(
                            "admit_to_merge", now - s.prefill_dispatch_t
                        )
                        s.prefill_dispatch_t = None
                    self._finish_prefill(s, int(toks[i]), produced, skips[i])
        if prev is None:
            return
        host, budget, active, gids, _ = prev
        emitted = host.numpy()
        delivered_total = 0
        for slot, gid in enumerate(gids):
            if gid is None or not active[slot]:
                continue
            s = self.sessions.get(gid)
            if s is None or self.slots[slot] != gid:
                continue  # cancelled/reaped since dispatch
            delivered = 0
            for i in range(int(budget[slot])):
                if s.state != SessionState.ACTIVE:
                    break
                tok = int(emitted[i, slot])
                if tok == -1:  # stopped on the device at an earlier step
                    break
                self._deliver(s, tok, produced)
                delivered += 1
            delivered_total += delivered
            # The carry holds this row's token of the window's LAST step:
            # -1 if the row stopped before it. (The JAX engine tests
            # delivered < budget, which leaves a -1 carry behind a
            # capacity-cut budget; see ROADMAP.md queue 3.)
            if (delivered < self.decode_steps
                    and s.state == SessionState.ACTIVE):
                self._carry_ok[slot] = False
        self.metrics.counter("decode_tokens", delivered_total)

    def _decode_tick(self, produced) -> None:
        """The synchronous tick: K steps (K = ``decode_steps``) for every
        decode-eligible row, fetched and delivered before returning. With a
        draft model and a speculative session resident, a speculative tick
        instead (the fused, pipelined rounds with ``pipelined_ticks``)."""
        if self.draft is not None:
            self._spec_adapt(produced)
            if any(g is not None
                   and self._session_speculative(self.sessions[g])
                   for g in self.slots):
                if self.ecfg.pipelined_ticks:
                    return self._speculative_rounds_tick(produced)
                return self._speculative_tick(produced)
            if self._spec_pending is not None:
                # The last speculative session left with a tick in flight.
                self._spec_flush(produced)
        K = self.decode_steps
        tokens = np.zeros((self.batch, 1), np.int32)
        opts: List[SamplingOptions] = [SamplingOptions()] * self.batch
        # Per-row token budget for this tick: how many of the K steps may
        # append (remaining max_new_tokens and page capacity). Page tables
        # grow to cover it before the step.
        budget = np.zeros((self.batch,), np.int32)
        for slot, gid in enumerate(self.slots):
            if gid is None:
                continue
            s = self.sessions[gid]
            if s.chunking:  # mid chunked-prefill: not decode-eligible
                continue
            tokens[slot, 0] = s.last_token
            opts[slot] = s.options
            want = min(K, s.options.max_new_tokens - len(s.generated))
            if self.allocator is None:
                cap = (self._sink_cap() if isinstance(self.cache, _SINK_KINDS)
                       else self.ecfg.max_seq_len)
                if s.total_len + 1 > cap:
                    self._finish(s, "capacity", produced)
                    continue
            else:
                cap = self._grow_pages_for(s, want, produced)
                if cap is None:
                    continue
            budget[slot] = min(want, cap - s.total_len)

        # Chunking rows hold slots but must NOT be decode-written (their
        # rows are mid-prefill; a decode write would land at the chunk
        # offset and corrupt the prompt KV).
        active = np.array(
            [
                self.slots[i] is not None
                and not self.sessions[self.slots[i]].chunking
                for i in range(self.batch)
            ],
            np.bool_,
        )
        if not active.any():
            return

        if self._windows:
            self._ensure_capacity(max(
                self.sessions[g].total_len + int(budget[i])
                for i, g in enumerate(self.slots) if g is not None
            ))

        sp = SamplingParams.stack(opts, self.device)
        self._flush_installs()
        self.plan.note_dispatch("decode", (self.batch, K, self._span()))
        act_dev = to_device(active, torch.bool, self.device)
        with self.metrics.timer("decode_step"):
            if K == 1:
                next_tokens = self._decode(
                    self._i32(tokens), act_dev, self._next_key(), sp,
                )
                # The one per-tick fetch.
                emitted = next_tokens.cpu().numpy()[None, :]
            else:
                eos_ids = np.asarray([o.eos_token_id for o in opts], np.int32)
                emitted = self._decode_k(
                    self._i32(tokens), act_dev, self._next_key(), sp,
                    self._i32(eos_ids), self._i32(budget),
                ).cpu().numpy()

        delivered = 0
        for slot, gid in enumerate(list(self.slots)):
            if gid is None or not active[slot]:
                continue
            s = self.sessions[gid]
            for i in range(int(budget[slot])):
                if s.state != SessionState.ACTIVE:
                    break
                self._deliver(s, int(emitted[i, slot]), produced)
                delivered += 1
        self.metrics.counter("decode_tokens", delivered)

    def _grow_pages(self, s: Session, want: int) -> int:
        """Grow ``s``'s page run to cover ``want`` more tokens (best
        effort); returns the mapped capacity."""
        ps = self.ccfg.page_size
        while len(s.pages) * ps < s.total_len + want:
            if (
                len(s.pages) >= self.ccfg.max_pages_per_session
                or self.allocator.free_count == 0
            ):
                break
            # Widen the page table first: the new slot index must exist.
            self._ensure_capacity(len(s.pages) * ps + 1)
            new = self.allocator.alloc(1)
            self._queue_install(s.slot, len(s.pages), new[0])
            s.pages.extend(new)
        return len(s.pages) * ps

    def _grow_pages_for(self, s: Session, want: int, produced) -> Optional[int]:
        """:meth:`_grow_pages` plus the tick's rule: a session without room
        for even one more token finishes (capacity)."""
        cap = self._grow_pages(s, want)
        if s.total_len + 1 > cap:
            self._finish(s, "capacity", produced)
            return None
        return cap

    # -- speculative ticks ------------------------------------------------

    def _spec_rounds_capacity_ok(self, pend_b=None) -> bool:
        """The fused rounds cannot grow pages or finish sessions mid-tick,
        so every resident session must have room for the worst case: ``R *
        (k + 1)`` positions (each round's verify writes k + 1 before the
        rollback trims it) plus the in-flight tick's. Grows pages and
        buffers up front; returns False (the synchronous tick, which grows
        and degrades round by round) when a row falls short."""
        worst = self.spec_rounds * (self.ecfg.speculative_k + 1)
        for slot, gid in enumerate(self.slots):
            if gid is None:
                continue
            s = self.sessions[gid]
            need = s.total_len + worst + (
                int(pend_b[slot]) if pend_b is not None else 0)
            if self.allocator is not None:
                if self._grow_pages(s, need - s.total_len) < need:
                    return False
            elif need > self.ecfg.max_seq_len:
                return False
        if self._windows and self.allocator is None:
            live = [self.sessions[g] for g in self.slots if g is not None]
            if live:
                self._ensure_capacity(
                    max(s.total_len for s in live) + worst + (
                        int(pend_b.max()) if pend_b is not None else 0))
        return True

    def _speculative_rounds_tick(self, produced) -> None:
        """Fused, pipelined speculation: each ``step()`` enqueues
        ``spec_rounds`` rounds (:meth:`_spec_round_fn`) from the
        device-resident token carry and THEN resolves the previous tick's
        packed result, whose copy to pinned memory overlapped the new tick.
        The streams equal :meth:`_speculative_tick`'s; events arrive one
        ``step()`` later."""
        prev = self._spec_pending
        if not self._spec_rounds_capacity_ok(self._spec_pend(prev)):
            # Drain the pipeline first, then the synchronous tick, which
            # grows and finishes sessions round by round.
            self._spec_flush(produced)
            return self._speculative_tick(produced)
        self._spec_pending = self._spec_dispatch(prev)
        self._spec_resolve(produced, prev)

    def _spec_pend(self, prev):
        """Conservative in-flight tokens a slot (0 where the slot's tenant
        changed since the dispatch)."""
        if prev is None:
            return np.zeros((self.batch,), np.int32)
        return np.where(
            np.array([g == pg for g, pg in zip(self.slots, prev[5])]),
            prev[4], 0)

    def _spec_flush(self, produced) -> None:
        """Resolve the in-flight speculative tick (the pipeline's drain)."""
        prev = self._spec_pending
        self._spec_pending = None
        self._spec_resolve(produced, prev)

    def _spec_dispatch(self, prev):
        """Enqueue one fused multi-round tick; returns the pending record
        ``(host pack, copy event, active, spec, pend, slots)`` or None.
        Budgets are conservative against the in-flight tick, as
        :meth:`_dispatch_tick`'s."""
        k, b = self.ecfg.speculative_k, self.batch
        pend_b = self._spec_pend(prev)
        fresh = np.zeros((b, 1), np.int32)
        use_carry = np.zeros((b,), np.bool_)
        opts: List[SamplingOptions] = [SamplingOptions()] * b
        spec = np.zeros((b,), np.bool_)
        budget = np.zeros((b,), np.int32)
        for slot, gid in enumerate(self.slots):
            if gid is None:
                continue
            s = self.sessions[gid]
            fresh[slot, 0] = s.last_token
            use_carry[slot] = self._spec_carry_ok[slot]
            opts[slot] = s.options
            spec[slot] = self._session_speculative(s)
            budget[slot] = max(0, s.options.max_new_tokens
                               - len(s.generated) - int(pend_b[slot]))
        active = np.array([g is not None for g in self.slots],
                          np.bool_) & (budget > 0)
        if not active.any():
            return None
        sp = SamplingParams.stack(opts, self.device)
        eos_ids = np.asarray([o.eos_token_id for o in opts], np.int32)
        carry_dev = to_device(use_carry, torch.bool, self.device)
        tokens = self._i32(fresh)
        if self._spec_carry is not None:
            tokens = torch.where(carry_dev[:, None], self._spec_carry, tokens)
        if self._spec_catch is None:
            ctok = torch.zeros((b, 1), dtype=torch.int32, device=self.device)
            cmask = torch.zeros((b,), dtype=torch.bool, device=self.device)
        else:
            # A row whose carry is off (a fresh admission) has a freshly
            # mirrored draft row: no pending catch-up.
            ctok, cmask = self._spec_catch
            cmask = cmask & carry_dev
        # The draft's attended width: every row's tokens, the in-flight
        # tick's and this tick's R rounds of k + 1 fit below it.
        need = max(self.sessions[g].total_len + int(pend_b[i])
                   for i, g in enumerate(self.slots) if g is not None)
        need += self.spec_rounds * (k + 1)
        width = next((w for w in self._draft_ladder if w >= need),
                     self.ecfg.max_seq_len)
        self._flush_installs()
        with self.metrics.timer("decode_step"):
            pack, tok, ctok, cmask = self._spec_round_fn(
                tokens, to_device(spec, torch.bool, self.device),
                to_device(active, torch.bool, self.device),
                self._i32(eos_ids), self._i32(budget), self._next_key(), sp,
                ctok, cmask, width)
        self._spec_carry = tok
        self._spec_catch = (ctok, cmask)
        self._spec_carry_ok = self._spec_carry_ok | active
        host, ready = self._to_host(pack)  # the tick's one fetch
        # The tick delivers at most min(R * (k + 1), budget) a row.
        pend = np.minimum(self.spec_rounds * (k + 1), budget).astype(
            np.int32) * active
        return (host, ready, active, spec, pend, list(self.slots))

    def _spec_resolve(self, produced, prev) -> None:
        """Deliver the previous speculative tick's tokens (its packed copy
        overlapped the tick just dispatched)."""
        if prev is None:
            return
        host, ready, active, spec, _, gids = prev
        k = self.ecfg.speculative_k
        with self.metrics.timer("decode_resolve"):
            if ready is not None:
                ready.synchronize()
        pack = host.numpy()                                 # [R, B, k + 3]
        emits = pack[:, :, : k + 1]
        accs, palive = pack[:, :, k + 1], pack[:, :, k + 2]
        delivered_total = 0
        for slot, gid in enumerate(gids):
            if gid is None or not active[slot]:
                continue
            s = self.sessions.get(gid)
            if s is None or self.slots[slot] != gid:
                continue  # cancelled/reaped since dispatch
            in_graph = int((emits[:, slot] != -1).sum())
            delivered = 0
            for r in range(emits.shape[0]):
                for j in range(k + 1):
                    if s.state != SessionState.ACTIVE:
                        break
                    tok = int(emits[r, slot, j])
                    if tok == -1:
                        break
                    self._deliver(s, tok, produced)
                    delivered += 1
            delivered_total += delivered
            if delivered < in_graph:
                # A host-side stop mid-pack: the device carry lies past the
                # session's true last token.
                self._spec_carry_ok[slot] = False
            if spec[slot]:
                rounds_run = int(palive[:, slot].sum())
                self.spec_stats["proposed"] += k * rounds_run
                self.spec_stats["accepted"] += int(
                    (accs[:, slot] * palive[:, slot]).sum())
                self.spec_stats["steps"] += rounds_run
        self.metrics.counter("decode_tokens", delivered_total)

    def _speculative_tick(self, produced) -> None:
        """The synchronous speculative tick: draft proposals, then ONE
        target forward over ``[last, p1..pk]`` for speculative rows (the
        others ride it as one-token decodes), acceptance on the host,
        rollback by ``lengths``. A speculative row short of ``k + 1``
        positions decodes plainly this tick and its draft is caught up."""
        k, b = self.ecfg.speculative_k, self.batch
        tokens = np.zeros((b, 1), np.int32)
        opts: List[SamplingOptions] = [SamplingOptions()] * b
        spec = np.zeros((b,), np.bool_)
        for slot, gid in enumerate(self.slots):
            if gid is None:
                continue
            s = self.sessions[gid]
            tokens[slot, 0] = s.last_token
            opts[slot] = s.options
            spec[slot] = self._session_speculative(s)
        # Capacity disables speculation a row: k + 1 positions, or 1.
        for slot, gid in enumerate(self.slots):
            if gid is None:
                continue
            s = self.sessions[gid]
            if self.allocator is not None:
                cap = self._grow_pages_for(s, (k + 1) if spec[slot] else 1,
                                           produced)
                if cap is None:
                    continue
            else:
                cap = self.ecfg.max_seq_len
                if s.total_len + 1 > cap:
                    self._finish(s, "capacity", produced)
                    continue
            if spec[slot] and s.total_len + k + 1 > cap:
                spec[slot] = False

        active = np.array([g is not None for g in self.slots], np.bool_)
        if not active.any():
            return
        if self._windows:
            self._ensure_capacity(max(
                self.sessions[g].total_len + ((k + 1) if spec[i] else 1)
                for i, g in enumerate(self.slots) if g is not None
            ))
        tokens_dev = self._i32(tokens)
        spec_dev = to_device(spec, torch.bool, self.device)
        if (active & spec).any():
            prop_d = self._draft_propose(
                tokens_dev, to_device(active & spec, torch.bool, self.device))
        else:
            # Every speculative row was capacity-disabled: no draft steps
            # (the verify is a plain batched decode with k unused positions).
            prop_d = torch.zeros((k, b), dtype=torch.int32, device=self.device)
        num_new = np.where(active, np.where(spec, k + 1, 1), 0).astype(
            np.int32)
        sp = SamplingParams.stack(opts, self.device)
        self._flush_installs()
        with self.metrics.timer("decode_step"):
            preds_d, sampled_d = self._verify(
                tokens_dev, prop_d, spec_dev, self._i32(num_new),
                self._next_key(), sp)
            # The tick's one fetch: proposals, argmaxes and samples together.
            got = torch.cat([prop_d.T, preds_d, sampled_d[:, None]],
                            1).cpu().numpy()
        prop, preds, sampled = got[:, :k], got[:, k : 2 * k + 1], got[:, -1]

        rollback = np.zeros((b,), np.int32)
        d_rollback = np.zeros((b,), np.int32)
        catch_mask = np.zeros((b,), np.bool_)
        catch_tok = np.zeros((b, 1), np.int32)
        delivered = 0
        for slot, gid in enumerate(list(self.slots)):
            if gid is None or not active[slot]:
                continue
            s = self.sessions[gid]
            if spec[slot]:
                a = 0
                while a < k and prop[slot, a] == preds[slot, a]:
                    a += 1
                emitted = [int(t) for t in prop[slot, :a]]
                emitted.append(int(preds[slot, a]))
                rollback[slot] = k - a
                if a == k:
                    # Full acceptance: the draft never consumed its own
                    # last proposal; caught up below.
                    catch_mask[slot] = True
                    catch_tok[slot, 0] = prop[slot, -1]
                else:
                    d_rollback[slot] = k - a - 1
                self.spec_stats["proposed"] += k
                self.spec_stats["accepted"] += a
                self.spec_stats["steps"] += 1
            else:
                emitted = [int(sampled[slot])]
            for t in emitted:
                if s.state != SessionState.ACTIVE:
                    break
                self._deliver(s, t, produced)
                delivered += 1
            if (not spec[slot] and self._session_speculative(s)
                    and s.state == SessionState.ACTIVE):
                # A speculative session that decoded plainly (capacity): its
                # draft row did not see the consumed token; feed it, or every
                # later proposal is out of place.
                catch_mask[slot] = True
                catch_tok[slot, 0] = tokens[slot, 0]
        self.metrics.counter("decode_tokens", delivered)

        # Roll lengths back to the true sequence (rejected positions become
        # invisible); the draft over-ran by k - a - 1 on partial acceptance.
        if rollback.any():
            self.cache.lengths.sub_(self._i32(rollback))
        if d_rollback.any():
            self.draft_cache.lengths.sub_(self._i32(d_rollback))
        if catch_mask.any():
            self._draft_catchup(self._i32(catch_tok),
                                to_device(catch_mask, torch.bool, self.device))

    def _deliver(self, s: Session, token: int, produced) -> None:
        if s.cancel_requested or s.state == SessionState.CANCELLED:
            return  # cancelled mid-step; the scheduler reaps the slot next tick
        s.record_token(token)
        done_eos = token == s.options.eos_token_id
        done_len = len(s.generated) >= s.options.max_new_tokens
        if done_eos or done_len:
            self._finish(s, "eos" if done_eos else "length", produced, token_emitted=token)
        else:
            produced.append((s.generation_id, token, False))

    def _finish(self, s: Session, reason: str, produced, token_emitted=None) -> None:
        s.state = SessionState.FINISHED
        s.finish_reason = reason
        s.finish_time = time.monotonic()
        # -1 = finish without a new token (the last real token was already
        # streamed on a prior step); consumers must not append it.
        produced.append(
            (s.generation_id, token_emitted if token_emitted is not None else -1, True)
        )
        self._release(s)
        self.metrics.counter("sessions_finished")

    def _release(self, s: Session) -> None:
        # A session reaped mid chunked-prefill has INCOMPLETE prompt KV
        # (only chunk_off tokens written): its pages must not be registered
        # as shareable prefix content below.
        partial = s.chunking
        if partial:
            s.chunking = False
            s.parked_key = None
        if s in self._chunking:
            self._chunking.remove(s)
        if s.slot is not None:
            self.slots[s.slot] = None
            # The device carry holds THIS session's last token; the slot's
            # next tenant must be fed its own.
            self._carry_ok[s.slot] = False
            if self.draft is not None:
                self._spec_carry_ok[s.slot] = False
            s.slot = None
        if s.cow_src is not None:
            # A parked copy-on-write source ref (normally dropped when the
            # prefill enqueues the copy).
            self.allocator.free([s.cow_src])
            s.cow_src = None
        if s.pages:
            if self.ccfg.prefix_caching and not partial:
                # Content-address the pages fully covered by PROMPT tokens
                # so later sessions with the same prefix reuse their KV
                # (pages touching generated tokens depend on sampling).
                ps = self.ccfg.page_size
                if s.prefix_keys is None:
                    s.prefix_keys = PageAllocator.chain_keys(s.prompt, ps)
                for i, key in enumerate(s.prefix_keys):
                    if i < len(s.pages):
                        self.allocator.register(s.pages[i], key)
            self.allocator.free(s.pages)
            s.pages = []

    # -- prefix/KV reuse (prefixstore/) -----------------------------------------

    def _note_prefix(self, total: int, reused: int) -> None:
        """Prefix-reuse accounting of every admission: the
        ``prefix_cached_tokens`` counter and the cumulative token-weighted
        ``prefix_hit_rate`` gauge (spill reloads land in the shared
        pages)."""
        self._prefix_seen += total
        self._prefix_hits += reused
        if reused:
            self.metrics.counter("prefix_cached_tokens", reused)
        if self._prefix_seen:
            self.metrics.gauge(
                "prefix_hit_rate", self._prefix_hits / self._prefix_seen
            )

    def _spill_page(self, page: int, key: bytes) -> None:
        """Allocator ``on_evict`` hook: snapshot an evicted registered
        prefix page's stored-form tiles into the host arena (under the
        scheduler lock, inside ``alloc``, BEFORE the page returns to the
        free list, so its content is still valid; on a card ``read_page``
        waits for the work enqueued before it)."""
        tiles = self.cache.read_page(page)
        if self._spill.put(key, tiles):
            self.metrics.counter("prefix_spilled_pages")
        self.metrics.gauge("prefix_spill_bytes", float(self._spill.bytes_used))

    def _reload_spilled(self, keys, shared: List[int], cap: int) -> List[int]:
        """Extend a device-registry prefix match with host-arena reloads:
        walk ``keys[len(shared):cap]``, re-checking the registry first (an
        earlier admission may have reloaded a key), then writing arena tiles
        into a fresh page. A rejected (corrupted) entry degrades to
        recompute from that point. Returned pages are referenced like
        ``lookup``'s."""
        while len(shared) < cap:
            key = keys[len(shared)]
            page = self.allocator.lookup_one(key)
            if page is None:
                tiles = self._spill.take(key)
                if tiles is None:
                    break
                t0 = time.perf_counter()
                try:
                    [page] = self.allocator.alloc(1)
                except MemoryError:
                    self._spill.put(key, tiles)  # park it for a calmer tick
                    break
                try:
                    self.cache.write_page(page, tiles)
                except ValueError:
                    # Corrupted arena entry: rejected before it can poison
                    # the pool; recompute covers the rest of the prompt.
                    self.allocator.free([page])
                    self.metrics.counter("prefix_reload_errors")
                    break
                self.allocator.register(page, key)
                self.metrics.counter("prefix_spill_reloads")
                self.metrics.observe(
                    "prefix_reload_ms", (time.perf_counter() - t0) * 1e3
                )
            shared.append(page)
        self.metrics.gauge("prefix_spill_bytes", float(self._spill.bytes_used))
        return shared

    def advertised_prefix_heads(self, limit: int = 1024) -> List[str]:
        """Hex chain keys this engine can serve a prefix hit from (device
        registry, then spill arena), newest-biased and bounded."""
        if self.allocator is None or not self.ccfg.prefix_caching:
            return []
        with self._lock:
            keys = self.allocator.registered_keys(limit)
            if self._spill is not None:
                dev = set(keys)
                keys += [k for k in self._spill.keys() if k not in dev]
        return [k.hex() for k in keys[-limit:]]

    def prefix_match_tokens(self, prompt) -> int:
        """Longest locally cached prefix of ``prompt`` in TOKENS
        (page-granular), WITHOUT taking page references: a routing probe."""
        if self.allocator is None or not self.ccfg.prefix_caching:
            return 0
        ps = self.ccfg.page_size
        keys = PageAllocator.chain_keys(prompt, ps)
        matched = 0
        with self._lock:
            for key in keys:
                if self.allocator.peek(key) is None and not (
                    self._spill is not None and key in self._spill
                ):
                    break
                matched += ps
        return matched

    def export_prefix_pages(self, prompt):
        """Stored-form tiles of the longest locally cached prefix of
        ``prompt`` (device registry pages, then spill-arena entries),
        page-granular, WITHOUT taking page references. Returns ``(page_size,
        [(chain_key, tiles), ...])``; empty when prefix caching is off or
        nothing matches. Tiles round-trip verbatim through
        :meth:`import_prefix_pages`."""
        if self.allocator is None or not self.ccfg.prefix_caching:
            return self.ccfg.page_size, []
        ps = self.ccfg.page_size
        keys = PageAllocator.chain_keys(prompt, ps)
        items = []
        with self._lock:
            for key in keys:
                page = self.allocator.peek(key)
                if page is not None:
                    items.append((key, self.cache.read_page(page)))
                    continue
                tiles = (self._spill.peek(key)
                         if self._spill is not None else None)
                if tiles is None:
                    break
                items.append((key, tiles))
        return ps, items

    def import_prefix_pages(self, page_size: int, items) -> int:
        """Install exported prefix pages into this engine's pool: each page
        lands registered at refcount 0, servable to prefix-matching
        admissions and evictable under pressure like a page a released
        session left behind. Already-resident keys are skipped; under pool
        pressure tiles park in the arena instead; a tile mismatch raises
        ``ValueError`` after freeing the staged page. Returns the pages made
        servable."""
        if self.allocator is None or not self.ccfg.prefix_caching:
            return 0
        if int(page_size) != self.ccfg.page_size:
            raise ValueError(
                f"page-ship size {page_size} != pool page size "
                f"{self.ccfg.page_size}")
        installed = 0
        with self._lock:
            for key, tiles in items:
                if self.allocator.peek(key) is not None:
                    continue  # already device-resident
                if self._spill is not None and key in self._spill:
                    continue  # already arena-resident
                try:
                    [page] = self.allocator.alloc(1)
                except MemoryError:
                    if self._spill is not None and self._spill.put(key, tiles):
                        installed += 1  # servable from the arena
                        continue
                    break
                try:
                    self.cache.write_page(page, tiles)
                except ValueError:
                    self.allocator.free([page])
                    self.metrics.counter("prefix_reload_errors")
                    raise
                self.allocator.register(page, key)
                self.allocator.free([page])  # registered, refcount 0
                installed += 1
        if installed:
            self.metrics.counter("fleet_pages_imported", installed)
        return installed
