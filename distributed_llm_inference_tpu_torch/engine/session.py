"""Host-side session bookkeeping (counterpart of the JAX package's
``engine/session.py``, field for field).

A session is one generation stream. Device state is integer-slot-indexed
(batch row, page table); everything string-keyed lives here on the host.
Fields that belong to features the port does not serve yet (disaggregated
serving, resume, tracing) stay, unused, so the later slices find them.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from typing import Any, List, Optional

from .sampling import SamplingOptions

_ids = itertools.count()


class SessionState(enum.Enum):
    WAITING = "waiting"
    ACTIVE = "active"
    FINISHED = "finished"
    CANCELLED = "cancelled"


@dataclasses.dataclass
class Session:
    prompt: List[int]
    options: SamplingOptions
    generation_id: str = dataclasses.field(
        default_factory=lambda: f"gen-{next(_ids)}"
    )
    state: SessionState = SessionState.WAITING
    # Set (only ever False→True) by cancel() from any thread; the scheduler
    # converts it to the CANCELLED state at tick boundaries. A plain state
    # write from cancel() could be stomped by the scheduler's own
    # WAITING→ACTIVE transition mid-admission.
    cancel_requested: bool = False
    # time.monotonic() of the first cancel() (None: never cancelled). A
    # cancel that comes after the deadline (the gateway's, once its grace
    # has run out) still ends the session as a deadline expiry.
    cancel_time: Optional[float] = None
    slot: Optional[int] = None
    # Absolute time.monotonic() budget: past it the scheduler reaps the
    # session at the next tick boundary exactly like a cancel (the serving
    # gateway's per-request deadline — abandoned requests must not keep
    # burning decode slots). None = no deadline.
    deadline: Optional[float] = None
    pages: List[int] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None  # "eos" | "length" | "capacity" | "cancelled" | "deadline"
    # Memoized prompt-prefix chain keys (prefix caching; computed once even
    # when pool pressure re-runs admission over many ticks).
    prefix_keys: Optional[List[bytes]] = None
    # Copy-on-write source page: set at admission when the prompt fully
    # matched a cached chain and the final shared page must be split. The
    # device copy (and this ref's release) happens at prefill-dispatch time
    # — after any same-tick writer's prefill is enqueued — in _run_prefill.
    cow_src: Optional[int] = None
    # True while an overlapped-admission prefill is in flight on device
    # (dispatched, first token not yet fetched — engine._inflight_admits).
    # Cancels/deadlines that land in this window drop the fetched result;
    # the scheduler's normal reap frees the slot and pages.
    prefill_inflight: bool = False
    # When the prefill was dispatched (overlap path) — the admit-to-merge
    # latency observed at resolve time is ``resolve_t - prefill_dispatch_t``.
    prefill_dispatch_t: Optional[float] = None
    # Admitted via engine.admit_prefilled (disaggregated serving): the
    # prompt's KV was prefilled on a remote pool and imported here, so TTFT
    # accounting splits into prefill-side (gateway-observed) and
    # decode-side (this session's submit→first-token) components.
    disagg: bool = False
    # How many times this logical stream has been re-admitted from a
    # snapshot (engine.resume_session). Carried through checkpoints so a
    # twice-migrated session reports 2, not 1.
    resumes: int = 0
    # Chunked-prefill co-scheduling state (engine/plan.py): while True the
    # session occupies its slot but is NOT decode-eligible — the engine's
    # chunk dispatcher walks the prompt ``plan.prefill_stride`` tokens per
    # granted tick and flips this off when the final chunk samples the
    # first token. ``chunk_off`` is the next unprefilled prompt offset;
    # ``chunk_skip`` carries the admission-time prefix-cache skip;
    # ``parked_key`` is the sampling key drawn AT ADMISSION (the stream
    # position the legacy synchronous prefill would have consumed) and
    # spent by the final chunk's sample.
    chunking: bool = False
    chunk_off: int = 0
    chunk_skip: int = 0
    parked_key: Optional[Any] = None
    # Admission-ordering stamp from the gateway scheduler (sched/): a
    # sortable ``(lane_rank, virtual_finish, seq)`` tuple consumed by the
    # engine's admission-order hook. None = direct engine user, admitted
    # in FIFO order ahead of scheduled sessions.
    sched_key: Optional[tuple] = None
    # Distributed-trace context (utils.tracing.TraceContext) minted at the
    # gateway and threaded through Handle/ticket plumbing; None for
    # unsampled requests and direct engine users — every tracing hook
    # short-circuits on that None, keeping the disabled path free.
    trace: Optional[Any] = None
    # timing (metrics: TTFT, tokens/sec — SURVEY §5.5)
    submit_time: float = dataclasses.field(default_factory=time.monotonic)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def last_token(self) -> int:
        return self.generated[-1] if self.generated else self.prompt[-1]

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    def record_token(self, token: int) -> None:
        if self.first_token_time is None:
            self.first_token_time = time.monotonic()
        self.generated.append(token)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time
