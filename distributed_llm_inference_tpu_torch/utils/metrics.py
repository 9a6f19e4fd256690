"""Structured metrics and timing (counterpart of the JAX package's
``utils/metrics.py``): counters, gauges and latency histories good enough to
derive tokens/sec, TTFT and batch occupancy. The text exposition for a
``/metrics`` endpoint comes with the serving gateway.
"""

from __future__ import annotations

import collections
import contextlib
import statistics
import threading
import time
from typing import Dict, List

# Every metric name the port emits, declared once: name -> (kind, help).
# Kinds: ``counter`` (monotonic), ``gauge`` (last write wins), ``summary``
# (observe()/timer() histories, seconds). Names and meanings are the JAX
# package's; entries arrive with the module that emits them.
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
    "cache_growths": ("counter", "Page-table widenings"),
    "kv_bytes_per_token": ("gauge", "Stored KV bytes per token, all layers"),
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
