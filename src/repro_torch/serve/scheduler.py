"""Admission/retirement scheduling for the continuous-batching engine.

Pure host-side bookkeeping: the waiting queue, each request's lifecycle
record (submit -> admit -> first token -> finish), and running aggregates.
The engine asks it each tick which requests to admit into free slots.

Policies
--------
* "fcfs"    — admit in arrival order, at most `max_prefills_per_tick`
              (default 1) per tick.
* "prefill" — admit in arrival order into every free slot each tick.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np

from repro_torch.serve.sampling import SamplingParams

POLICIES = ("fcfs", "prefill")
LOOKAHEAD = 8          # unadmittable queue entries pick() may look past
HEAD_AGE_CAP = 64      # ticks after which a blocked head gets strict order
KEEP_FINISHED = 100_000   # retired records kept for metrics


@dataclasses.dataclass
class RequestState:
    """One request's lifecycle record (host-side)."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    # lifecycle marks (ticks are engine decode steps; times are perf_counter)
    submit_tick: int = -1
    admit_tick: int = -1
    finish_tick: int = -1
    submit_time: float = 0.0
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    slot: int = -1
    blocks: List[int] = dataclasses.field(default_factory=list)
    finish_reason: str = ""
    arrival_seq: int = -1
    # chunked-prefill state machine: next grid position to compute, the
    # context target, and the grid chunks still to run
    prefill_pos: int = 0
    prefill_ctx: int = 0
    computed_prefill_tokens: int = 0
    table_row: Optional[np.ndarray] = None
    pending_chunks: List[int] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    def wait_age(self, tick: int) -> int:
        return tick - self.submit_tick

    @property
    def queue_ticks(self) -> int:
        return self.admit_tick - self.submit_tick if self.admit_tick >= 0 else -1

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


class Scheduler:
    def __init__(self, policy: str = "fcfs",
                 prefill_token_budget: Optional[int] = None):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.policy = policy
        self.max_prefills_per_tick = 1 if policy == "fcfs" else 1 << 30
        # chunked-prefill pacing: at most this many prefill tokens per tick
        self.prefill_token_budget = prefill_token_budget
        self.waiting: Deque[RequestState] = deque()
        self.finished: Deque[RequestState] = deque(maxlen=KEEP_FINISHED)
        self.submitted = 0
        self.admitted = 0
        self.retired = 0
        self.max_queue_depth = 0
        self._queue_tick_sum = 0
        self._ttft_sum = 0.0
        self._ttft_n = 0

    def submit(self, rs: RequestState, tick: int, now: float) -> None:
        rs.submit_tick = tick
        rs.submit_time = now
        rs.arrival_seq = self.submitted
        self.waiting.append(rs)
        self.submitted += 1
        self.max_queue_depth = max(self.max_queue_depth, len(self.waiting))

    def pick(self, free_slots: int, tick: int,
             can_admit: Callable[[RequestState], bool]) -> List[RequestState]:
        """Requests to admit this tick, in arrival order, looking past up to
        LOOKAHEAD blocked entries (which keep their queue position) until
        the head has waited HEAD_AGE_CAP ticks (then strict order)."""
        budget = min(free_slots, self.max_prefills_per_tick)
        chosen: List[RequestState] = []
        now = time.perf_counter()
        skipped: List[RequestState] = []
        allow_skip = LOOKAHEAD
        if self.waiting and self.waiting[0].wait_age(tick) >= HEAD_AGE_CAP:
            allow_skip = 0
        while self.waiting and len(chosen) < budget:
            if not can_admit(self.waiting[0]):
                if len(skipped) >= allow_skip:
                    break
                skipped.append(self.waiting.popleft())
                continue
            rs = self.waiting.popleft()
            rs.admit_tick = tick
            rs.admit_time = now
            self._queue_tick_sum += rs.queue_ticks
            self.admitted += 1
            chosen.append(rs)
        for rs in reversed(skipped):
            self.waiting.appendleft(rs)
        return chosen

    def requeue_front(self, rs: RequestState) -> None:
        """Return a picked-but-unadmittable request to the queue head,
        reverting its admission marks."""
        if rs.admit_tick >= 0:
            self._queue_tick_sum -= rs.queue_ticks
            self.admitted -= 1
            rs.admit_tick = -1
            rs.admit_time = None
        self.waiting.appendleft(rs)

    def retire(self, rs: RequestState, tick: int, now: float,
               reason: str) -> None:
        rs.finish_tick = tick
        rs.finish_time = now
        rs.finish_reason = reason
        self.retired += 1
        if rs.ttft is not None:
            self._ttft_sum += rs.ttft
            self._ttft_n += 1
        self.finished.append(rs)

    def metrics(self) -> dict:
        return {
            "policy": self.policy,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "retired": self.retired,
            "waiting": len(self.waiting),
            "max_queue_depth": self.max_queue_depth,
            "mean_queue_ticks": (self._queue_tick_sum / self.admitted
                                 if self.admitted else 0.0),
            "mean_ttft_s": (self._ttft_sum / self._ttft_n
                            if self._ttft_n else None),
        }
