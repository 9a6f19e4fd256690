"""Circuit breaker for the HTTP gateway's backend (counterpart of the JAX
package's ``serving/breaker.py``, transition for transition).

When the backend is down (its engine driver dead), each admitted
request burns a full client timeout before failing — a thundering herd
of doomed requests. The
breaker fails them fast instead: after ``failure_threshold`` consecutive
failures it OPENS (requests get 503 + Retry-After immediately); after
``recovery_s`` it goes HALF_OPEN and lets a limited number of trial
requests through; ``success_threshold`` consecutive successes CLOSE it
again, any failure re-opens it.

Signals come from two places: real request outcomes
(:meth:`record_success`/:meth:`record_failure`, fed by the server's
completion paths) and background health probes (:meth:`record_probe`,
fed by the server's probe loop pinging the backend). Probe failures
always count — the breaker must open even when no traffic is arriving —
but probe successes only act when the breaker is already tripped, so a
healthy-looking probe can never mask live request failures.

State is observable: transition counters plus a ``breaker_state`` gauge
(0 = closed, 1 = open, 2 = half-open) land in ``Metrics`` and therefore
in ``/metrics``. The clock is injectable for deterministic tests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..utils.metrics import Metrics

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_GAUGE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        recovery_s: float = 5.0,
        success_threshold: int = 1,
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1 or success_threshold < 1:
            raise ValueError("breaker thresholds must be >= 1")
        self.failure_threshold = failure_threshold
        self.recovery_s = recovery_s
        self.success_threshold = success_threshold
        self.metrics = metrics if metrics is not None else Metrics()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0  # consecutive, while CLOSED
        self._successes = 0  # consecutive, while HALF_OPEN
        self._opened_at = 0.0
        self._trials = 0  # requests admitted since entering HALF_OPEN
        self.metrics.gauge("breaker_state", _STATE_GAUGE[CLOSED])

    # -- state machine (callers hold self._lock) ------------------------------

    def _set_state(self, state: str) -> None:  # caller holds _lock
        if state == self._state:
            return
        self._state = state
        self.metrics.counter(f"breaker_{state}_transitions")
        self.metrics.gauge("breaker_state", _STATE_GAUGE[state])
        if state == OPEN:
            self._opened_at = self._clock()
        elif state == HALF_OPEN:
            self._successes = 0
            self._trials = 0
        else:  # CLOSED
            self._failures = 0

    def _maybe_half_open(self) -> None:  # caller holds _lock
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.recovery_s
        ):
            self._set_state(HALF_OPEN)

    # -- admission ------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def allow(self) -> bool:
        """May a request proceed right now? OPEN → no (503); HALF_OPEN →
        only the trial budget (``success_threshold`` requests) passes."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return False
            if self._trials >= self.success_threshold:
                return False
            self._trials += 1
            return True

    def retry_after(self) -> float:
        """Seconds until the next trial is worth attempting (the 503's
        Retry-After value; >= 1 so clients don't busy-spin)."""
        with self._lock:
            remaining = self.recovery_s - (self._clock() - self._opened_at)
            return max(1.0, remaining)

    # -- outcome signals ------------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._successes += 1
                if self._successes >= self.success_threshold:
                    self._set_state(CLOSED)
            elif self._state == CLOSED:
                self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self.metrics.counter("breaker_failures_recorded")
            if self._state == HALF_OPEN:
                self._set_state(OPEN)  # trial failed: back off again
            elif self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._set_state(OPEN)
            else:  # already OPEN: refresh the window
                self._opened_at = self._clock()

    def record_probe(self, ok: bool) -> None:
        """Background health-probe outcome. Failures always count toward
        opening; successes only advance recovery (OPEN → HALF_OPEN →
        CLOSED) — they never reset the live-failure streak, so probes
        cannot mask a failing request path."""
        if not ok:
            self.record_failure()
            return
        with self._lock:
            self._maybe_half_open()
            if self._state == HALF_OPEN:
                self._successes += 1
                if self._successes >= self.success_threshold:
                    self._set_state(CLOSED)
