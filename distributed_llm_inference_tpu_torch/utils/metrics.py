"""Structured metrics and timing (counterpart of the JAX package's
``utils/metrics.py``): counters, gauges and latency histories good enough to
derive tokens/sec, TTFT and batch occupancy, and their Prometheus text
exposition for the gateway's ``/metrics`` endpoint (the JAX package's text,
line for line).
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import re
import statistics
import threading
import time
from typing import Dict, List, Optional

_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")

logger = logging.getLogger("distributed_llm_inference_tpu_torch")

# Every metric name the port emits, declared once: name -> (kind, help).
# Kinds: ``counter`` (monotonic, ``_total`` on /metrics), ``gauge`` (last
# write wins), ``summary`` (observe()/timer() histories; ``_seconds`` on
# /metrics). Names and meanings are the JAX package's; entries arrive with
# the module that emits them; ``*`` entries match suffixed families.
METRICS = {
    # engine: admission + sessions
    "sessions_submitted": ("counter", "Sessions accepted by submit()"),
    "sessions_finished": ("counter", "Sessions retired (any reason)"),
    "sessions_rejected": ("counter", "Sessions refused at admission"),
    "sessions_deadline_expired": ("counter", "Sessions reaped past deadline"),
    "admit_sync_sessions": ("counter", "Sessions admitted synchronously"),
    "admit_overlap_sessions": ("counter", "Sessions admitted via overlap"),
    "admit_overlap_spill": ("counter", "Overlap admissions spilled to sync"),
    "admit_overlap_inflight": ("gauge", "Prefills in flight behind decode"),
    "admit_to_merge": ("summary", "Overlap admission to KV-merge latency"),
    # engine: prefill / decode hot path
    "prefill": ("summary", "Prefill dispatch latency"),
    "prefill_tokens": ("counter", "Prompt tokens prefilled"),
    "batched_prefills": ("counter", "Prefills served by batched dispatch"),
    "ring_prefills": ("counter", "Prefills served by the ring pipeline"),
    "prefix_cached_tokens": ("counter", "Prompt tokens served from prefix cache"),
    # prefixstore: CoW sharing / host spill tier
    "prefix_hit_rate": ("gauge", "Cumulative fraction of prompt tokens reused"),
    "prefix_pages_shared": ("counter", "Shared prefix-page attachments"),
    "prefix_cow_copies": ("counter", "Copy-on-write splits of shared pages"),
    "prefix_spill_bytes": ("gauge", "Host spill arena bytes resident"),
    "prefix_spilled_pages": ("counter", "Prefix pages spilled to host DRAM"),
    "prefix_spill_reloads": ("counter", "Prefix pages reloaded from the arena"),
    "prefix_reload_ms": ("summary", "Host->device prefix page reload time"),
    "prefix_reload_errors": ("counter", "Arena entries rejected at reload"),
    "fleet_pages_imported": ("counter", "Shipped prefix pages installed"),
    # engine: attention plan (ragged mixed-phase dispatch — engine/plan.py)
    "attn_dispatch_shapes": ("counter", "First-seen attention dispatch shapes"),
    "attn_ragged_dispatches": ("counter", "Prefill-family ragged dispatches"),
    "attn_chunked_rows": ("counter", "Chunk rows co-scheduled with decode"),
    "attn_grid_occupancy": ("gauge", "Valid/padded tokens, last dispatch"),
    "decode_step": ("summary", "One decode tick (dispatch+resolve)"),
    "decode_tokens": ("counter", "Tokens emitted by decode"),
    "decode_resolve": ("summary", "Deferred decode fetch latency"),
    # engine/graphs.py: the fused window's captured step (no JAX
    # counterpart: jax.jit compiles instead)
    "decode_graph_captures": ("counter", "Fused decode steps captured"),
    "decode_graph_replays": ("counter", "Captured decode steps replayed"),
    "decode_graph_capture": ("summary", "Capture time of one decode step"),
    "decode_graphs": ("gauge", "Captured decode steps alive"),
    "decode_graph_pool_bytes": ("gauge", "Memory reserved by captures"),
    "spec_round_graph_captures": ("counter", "Speculative rounds captured"),
    "spec_round_graph_replays": ("counter", "Captured rounds replayed"),
    "spec_round_graph_capture": ("summary", "Capture time of one round"),
    "cache_growths": ("counter", "Page-table widenings"),
    # latent (MLA) KV compression (cache/latent.py)
    "kv_bytes_per_token": ("gauge", "Stored KV bytes per token, all layers"),
    "latent_decompress_dispatches": (
        "counter", "Attention dispatches reading the latent stored form"
    ),
    # engine: speculative decoding
    "spec_adapt_window_resets": ("counter", "Adaptive-k A/B window resets"),
    "spec_adapt_probes": ("counter", "Adaptive-k probe windows started"),
    "spec_adapt_suspensions": ("counter", "Speculation suspensions (low accept)"),
    # serving gateway
    "http_requests": ("counter", "Completion requests received"),
    "http_429": ("counter", "Requests shed at capacity"),
    "http_503_breaker": ("counter", "Requests failed fast by the breaker"),
    "ttft": ("summary", "Gateway time to first token"),
    "gateway_tokens": ("counter", "Tokens delivered to HTTP clients"),
    "queue_depth": ("gauge", "Backend queue depth at scrape"),
    "active_sessions": ("gauge", "Live backend sessions at scrape"),
    "http_inflight": ("gauge", "Gateway in-flight completions"),
    "engine_ttft": ("summary", "Engine-side TTFT (sync admission)"),
    # circuit breaker
    "breaker_state": ("gauge", "0 closed / 1 open / 2 half-open"),
    "breaker_*_transitions": ("counter", "Breaker transitions into a state"),
    "breaker_failures_recorded": ("counter", "Failure signals seen"),
}


class Metrics:
    """Thread-safe counters, gauges and timers (request threads submit and
    cancel while the scheduler thread steps)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._timings: Dict[str, List[float]] = collections.defaultdict(list)
        self._gauges: Dict[str, float] = {}

    def counter(self, name: str, inc: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += inc

    def gauge(self, name: str, value: float) -> None:
        """Set a persistent gauge (last-write-wins) — for state that an
        owner updates on transition (circuit-breaker state, pool size)
        rather than the caller sampling it at scrape time."""
        with self._lock:
            self._gauges[name] = float(value)

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self._timings[name].append(time.perf_counter() - t0)

    def get_counter(self, name: str) -> float:
        """One counter's current value (snapshot() is unsuitable for
        per-tick reads — it sorts every timing list)."""
        with self._lock:
            return self._counters.get(name, 0.0)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._timings[name].append(value)

    def percentile(self, name: str, q: float) -> float:
        with self._lock:
            vals = sorted(self._timings.get(name, []))
        if not vals:
            return float("nan")
        idx = min(len(vals) - 1, int(q / 100.0 * len(vals)))
        return vals[idx]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
            for name, vals in self._timings.items():
                if not vals:
                    continue
                out[f"{name}_count"] = len(vals)
                out[f"{name}_mean_s"] = statistics.fmean(vals)
                srt = sorted(vals)
                out[f"{name}_p50_s"] = srt[len(srt) // 2]
                out[f"{name}_p99_s"] = srt[min(len(srt) - 1, int(0.99 * len(srt)))]
        return out

    def log_snapshot(self) -> None:
        logger.info("metrics %s", json.dumps(self.snapshot(), sort_keys=True))

    def prometheus(
        self,
        prefix: str = "dli",
        extra_gauges: Optional[Dict[str, float]] = None,
    ) -> str:
        """Prometheus text exposition (the ``/metrics`` endpoint body).

        Counters become ``<prefix>_<name>_total`` counters; timings become
        ``<prefix>_<name>_seconds`` summaries (p50/p99 quantiles + _sum +
        _count); ``extra_gauges`` are point-in-time gauges (queue depth,
        active sessions) sampled by the caller and merged over the
        persistent ``gauge()`` values."""

        def clean(name: str) -> str:
            return _PROM_NAME.sub("_", f"{prefix}_{name}")

        with self._lock:
            counters = dict(self._counters)
            timings = {k: list(v) for k, v in self._timings.items()}
            gauges = dict(self._gauges)
        gauges.update(extra_gauges or {})
        lines: List[str] = []
        for name in sorted(counters):
            metric = clean(name) + "_total"
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {counters[name]:.10g}")
        for name in sorted(timings):
            vals = sorted(timings[name])
            if not vals:
                continue
            # Summaries default to seconds; names that already carry their
            # unit keep it as-is.
            suffix = "" if name.endswith(("_bytes", "_ms")) else "_seconds"
            metric = clean(name) + suffix
            lines.append(f"# TYPE {metric} summary")
            p50 = vals[len(vals) // 2]
            p99 = vals[min(len(vals) - 1, int(0.99 * len(vals)))]
            lines.append(f'{metric}{{quantile="0.5"}} {p50:.10g}')
            lines.append(f'{metric}{{quantile="0.99"}} {p99:.10g}')
            lines.append(f"{metric}_sum {sum(vals):.10g}")
            lines.append(f"{metric}_count {len(vals)}")
        for name in sorted(gauges):
            metric = clean(name)
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {gauges[name]:.10g}")
        return "\n".join(lines) + "\n"
