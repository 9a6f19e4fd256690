"""Fused K-step decode windows, one step captured as a CUDA graph (no JAX
module of its own: it is the port's counterpart of ``jax.jit`` of the JAX
engine's ``_decode_scan``).

A window is ``models/llama.py:DecodeWindow``: K token steps over a
read-only cache with a write-behind tail, then one flush. Eager, a step is
about 2,900 launches at Llama-3-8B widths (int4 weights over int8 pages),
so a window would be some 46,000. On a CUDA device this module captures ONE
step into a graph and replays it K times: the step's inputs and state live
in tensors the graph captured (the window's buffers, the sampling
parameters, the key, EOS ids and budgets below), every kernel reads the
step index from device memory, and nothing in the step synchronises with
the host. The flush and the per-window gather of the big planes run
eagerly around the replays.

Graphs are keyed by (the cache's width ``max_len``, ``all_greedy``): the
width (a page table's columns times the page size, or a dense buffer's T)
fixes every shape and the window's form (the int8 pool gathers below
``INPLACE_CTX`` and reads in place above it; the int8 dense cache runs its
kernels at widths that are multiples of 32), and ``all_greedy`` is the
sampler's host flag. A graph holds the addresses it captured, so when what
fixes the cache's shapes is replaced (``cache.window_anchor``: a paged
pool's table, widened or shrunk; a dense cache's buffers, regrown, or the
cache itself, re-created when idle) every graph and window goes. The graphs
of one anchor share one memory pool.
The first window of a key runs its first step eagerly (on a side stream,
the warm-up capture needs), captures the step, and replays the rest; a
failed capture raises.

Launch counters: a captured launch runs at every replay, not at capture.
So the counters that the kernel wrappers raised while being captured are
taken back after the capture, and added again at every replay: they count
the kernels that ran.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from ..models.llama import DecodeWindow
from ..ops import flash_attention as _fa
from ..ops import paged_attention as _pa
from ..ops import quant_attention as _qa
from ..ops import quant_matmul as _qm
from ..ops import ragged_attention as _ra
from .sampling import SamplingParams, sample

# Every kernel wrapper's launch counter: (module, attribute).
LAUNCH_COUNTERS = (
    (_pa, "launches"), (_pa, "quantized_launches"), (_pa, "fused_launches"),
    (_pa, "flush_launches"), (_qa, "fused_launches"), (_qa, "decode_launches"),
    (_qa, "flush_launches"), (_qa, "sink_launches"),
    (_qa, "sink_flush_launches"), (_fa, "launches"), (_qm, "launches"),
    (_qm, "stacked_launches"), (_ra, "launches"), (_ra, "quantized_launches"),
)


def _counts() -> Tuple[int, ...]:
    return tuple(getattr(m, a) for m, a in LAUNCH_COUNTERS)


class FusedDecode:
    """Runs the engine's fused decode windows.

    ``capture``: replay each step from a CUDA graph, on for a CUDA device.
    Set to False before the first window, the same steps run eagerly (the
    captured-against-eager check); a CPU device runs them eagerly. The
    inputs of :meth:`run` are copied into tensors owned here, so the
    caller's may be freed or reused at once."""

    def __init__(self, cfg, params, num_steps: int, batch: int,
                 device: torch.device, metrics):
        self.cfg = cfg
        self.params = params
        self.num_steps = num_steps
        self.metrics = metrics
        self.capture = device.type == "cuda"
        self.key = torch.zeros((1,), dtype=torch.int64, device=device)
        self.eos = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.budget = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.sp = SamplingParams(
            temperature=torch.zeros((batch,), dtype=torch.float32, device=device),
            top_k=torch.zeros((batch,), dtype=torch.int32, device=device),
            top_p=torch.ones((batch,), dtype=torch.float32, device=device),
        )
        self._anchor = None
        self._windows: Dict[int, DecodeWindow] = {}
        self._graphs: Dict[Tuple[int, bool], Tuple] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.capture else None
        self._pool_bytes = 0

    def _step_fn(self, i, logits, alive):
        """Sampling, EOS stops and budgets of one step, all on the device
        (the JAX engine's ``step_fn``)."""
        nxt = sample(logits, self.key, self.sp, i)
        emitted = torch.where(alive, nxt, -1)
        alive = alive & (nxt != self.eos) & (i + 1 < self.budget)
        return nxt, alive.to(torch.int32), alive, emitted

    def drop(self) -> None:
        """Forget every window and graph (the shapes they captured are
        gone). Their memory pool goes with them: the next graphs share a
        new one (the allocator does not take captures into a pool whose
        graphs are all gone)."""
        self._windows.clear()
        self._graphs.clear()
        self._anchor = None
        if self.capture:
            self._pool = torch.cuda.graph_pool_handle()
        self.metrics.gauge("decode_graphs", 0.0)

    def run(self, cache, tokens: torch.Tensor, active: torch.Tensor, key: int,
            sp: SamplingParams, eos: torch.Tensor,
            budget: torch.Tensor) -> torch.Tensor:
        """One window of K steps over ``cache``: ``tokens`` ``[B, 1]`` first
        inputs, ``active`` ``[B]`` bool rows that decode, ``key`` the
        window's sampling key, ``eos``/``budget`` ``[B]`` int32 per-row
        stop token and token budget. Rows stop at EOS or their budget; a
        stopped row writes nothing more and emits -1. Returns the emitted
        tokens ``[K, B]`` (a tensor of its own); the cache is flushed and
        advanced."""
        if cache.window_anchor is not self._anchor:
            self.drop()
            self._anchor = cache.window_anchor
        width = cache.max_len
        win = self._windows.get(width)
        if win is None:
            win = DecodeWindow(cache, self.num_steps, active)
            self._windows[width] = win
        self.key.fill_(key)
        self.eos.copy_(eos)
        self.budget.copy_(budget)
        self.sp.temperature.copy_(sp.temperature)
        self.sp.top_k.copy_(sp.top_k)
        self.sp.top_p.copy_(sp.top_p)
        self.sp.all_greedy = sp.all_greedy
        win.begin(tokens, active, active.to(torch.int32))

        def step():
            win.step(self.cfg, self.params, self._step_fn)

        if not self.capture:
            for _ in range(self.num_steps):
                step()
        else:
            gkey = (width, sp.all_greedy)
            entry = self._graphs.get(gkey)
            done = 0
            if entry is None:
                entry = self._capture(step)
                self._graphs[gkey] = entry
                done = 1
            graph, deltas = entry
            for _ in range(done, self.num_steps):
                graph.replay()
                for (m, a), d in zip(LAUNCH_COUNTERS, deltas):
                    setattr(m, a, getattr(m, a) + d)
            self.metrics.counter("decode_graph_replays", self.num_steps - done)
        return win.end().clone()

    def _capture(self, step):
        """Run ``step`` once for real on a side stream (the window's first
        step, and the warm-up the capture needs), then capture it."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        t0 = time.perf_counter()
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            # Read here: entering the capture empties the allocator's cache.
            reserved = torch.cuda.memory_reserved()
            step()
        deltas = tuple(a - b for a, b in zip(_counts(), before))
        for (m, a), d in zip(LAUNCH_COUNTERS, deltas):
            setattr(m, a, getattr(m, a) - d)
        self._pool_bytes += torch.cuda.memory_reserved() - reserved
        self.metrics.counter("decode_graph_captures")
        self.metrics.observe("decode_graph_capture", time.perf_counter() - t0)
        self.metrics.gauge("decode_graphs", float(len(self._graphs) + 1))
        self.metrics.gauge("decode_graph_pool_bytes", float(self._pool_bytes))
        return graph, deltas

    def graph_count(self) -> int:
        return len(self._graphs)
