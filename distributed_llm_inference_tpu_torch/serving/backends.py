"""Generation backends behind the HTTP gateway (counterpart of the JAX
package's ``serving/backends.py``: its protocol and ``EngineBackend``).

:class:`EngineBackend` serves a local :class:`InferenceEngine`. A single
driver thread owns ``engine.step()`` (the engine's contract: submit and
cancel are thread-safe, ``step`` must stay single-caller) and fans
per-token events out to per-request asyncio queues via
``loop.call_soon_threadsafe``.

The gateway's event-loop thread never touches the device: ``submit``,
``cancel``, ``queue_depth``, ``active_sessions`` and ``probe`` read and
write host state only. On a card the driver captures the fused decode
window's step as a CUDA graph (``engine/graphs.py``, capture mode
"global"), and a CUDA call from any other thread during a capture would
fail it.

The JAX package's ``DisaggBackend``, ``ClientBackend`` and ``FleetBackend``
wait for ROADMAP.md queue 1, items 13-15.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..engine.sampling import SamplingOptions
from ..utils.metrics import Metrics

logger = logging.getLogger("distributed_llm_inference_tpu_torch")


@dataclasses.dataclass
class TokenEvent:
    """One item on a request's stream queue. ``token == -1`` with
    ``finished`` means the stream ended without a new token (cancel,
    deadline, capacity, a dead driver)."""

    token: int
    finished: bool
    finish_reason: Optional[str] = None


@dataclasses.dataclass(eq=False)  # identity-hashed: handles live in sets
class Handle:
    gen_id: str
    queue: "asyncio.Queue[TokenEvent]"


class Backend:
    """Interface contract (duck-typed; this base just documents it)."""

    metrics: Metrics

    def start(self, loop: asyncio.AbstractEventLoop) -> None:
        raise NotImplementedError

    def submit(
        self,
        prompt: Sequence[int],
        options: SamplingOptions,
        deadline: Optional[float],
    ) -> Handle:
        raise NotImplementedError

    def cancel(self, handle: Handle) -> None:
        raise NotImplementedError

    def active_sessions(self) -> int:
        raise NotImplementedError

    def queue_depth(self) -> int:
        raise NotImplementedError

    def probe(self) -> bool:
        """Cheap health check for the gateway's circuit-breaker probe
        loop (runs on an executor thread — may block briefly)."""
        return True

    def stop(self, timeout: float = 10.0) -> None:
        raise NotImplementedError


class EngineBackend(Backend):
    """Local-engine backend: one driver thread steps the scheduler, on the
    engine's device.

    An exception in ``engine.step()`` ends the driver: it is logged and kept
    in :attr:`error`, every open stream ends with finish reason
    ``"error: …"`` (which the gateway counts as a backend failure), later
    submissions end at once the same way, and :meth:`probe` reports the
    dead driver, so the breaker opens."""

    def __init__(self, engine, idle_sleep_s: float = 0.002):
        self.engine = engine
        self.metrics = engine.metrics  # one /metrics covers engine + gateway
        self.error: Optional[BaseException] = None
        # The driver's card: a new thread starts on device 0, and a device
        # without an index ("cuda") is the constructing thread's current
        # one.
        dev = engine.device
        self._cuda_index = None
        if dev.type == "cuda":
            self._cuda_index = (
                dev.index if dev.index is not None
                else torch.cuda.current_device()
            )
        self._idle_sleep_s = idle_sleep_s
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._handles: Dict[str, Handle] = {}
        # Held across engine.submit + handle registration (and by the
        # fan-out when resolving handles): the driver may produce this
        # generation's first event the instant the session is visible, and
        # must not find the handle missing.
        self._hlock = threading.Lock()
        self._stop_evt = threading.Event()
        self._unpaused = threading.Event()
        self._unpaused.set()
        self._thread: Optional[threading.Thread] = None

    def start(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop
        self._thread = threading.Thread(
            target=self._drive, name="engine-driver", daemon=True
        )
        self._thread.start()

    # Test/drain hook: a paused driver stops ticking the engine (submitted
    # sessions stay queued), which makes queue-full and deadline scenarios
    # deterministic.
    def pause(self) -> None:
        self._unpaused.clear()

    def resume(self) -> None:
        self._unpaused.set()

    def _drive(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        try:
            while not self._stop_evt.is_set():
                if not self._unpaused.is_set() or not self.engine.has_work():
                    time.sleep(self._idle_sleep_s)
                    continue
                events = self.engine.step()
                if events:
                    self._fanout(events)
                self.engine.collect_finished()
        except Exception as e:  # noqa: BLE001 - the driver's boundary
            logger.exception("engine driver died")
            with self._hlock:
                self.error = e
                handles = list(self._handles.values())
                self._handles.clear()
            for h in handles:
                self._post(h, self._error_event())

    def _error_event(self) -> TokenEvent:
        return TokenEvent(-1, True, f"error: engine driver died: {self.error!r}")

    def _post(self, h: Handle, ev: TokenEvent) -> None:
        try:
            self._loop.call_soon_threadsafe(h.queue.put_nowait, ev)
        except RuntimeError:
            pass  # loop already closed (server exited mid-tick)

    def _fanout(self, events: List) -> None:
        with self._hlock:
            for gid, token, finished in events:
                if finished:
                    h = self._handles.pop(gid, None)
                else:
                    h = self._handles.get(gid)
                if h is None:
                    continue  # caller already gone (disconnect races a tick)
                reason = None
                if finished:
                    s = self.engine.sessions.get(gid)
                    reason = s.finish_reason if s is not None else "cancelled"
                    if s is not None and s.ttft is not None:
                        # Engine-side TTFT (submit → first token recorded by
                        # the scheduler): the admission stall alone, beside
                        # the gateway's wall-clock ``ttft``.
                        self.metrics.observe("engine_ttft", s.ttft)
                self._post(h, TokenEvent(token, finished, reason))

    def submit(self, prompt, options, deadline) -> Handle:
        with self._hlock:
            if self.error is not None:
                h = Handle(gen_id="", queue=asyncio.Queue())
                h.queue.put_nowait(self._error_event())
                return h
            gid = self.engine.submit(prompt, options, deadline=deadline)
            h = Handle(gen_id=gid, queue=asyncio.Queue())
            self._handles[gid] = h
        return h

    def cancel(self, handle: Handle) -> None:
        # The scheduler reaps at the next tick and emits the terminal
        # event; _fanout pops the handle then.
        self.engine.cancel(handle.gen_id)

    def active_sessions(self) -> int:
        return self.engine.active_sessions()

    def queue_depth(self) -> int:
        return self.engine.queue_depth()

    def probe(self) -> bool:
        # The engine is local: healthy means the driver thread is alive
        # (a dead driver strands every queued session).
        return (
            self._thread is not None
            and self._thread.is_alive()
            and not self._stop_evt.is_set()
        )

    def stop(self, timeout: float = 10.0) -> None:
        self._stop_evt.set()
        self._unpaused.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
