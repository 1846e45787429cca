"""Admission/retirement scheduling for the continuous-batching engine.

Pure host-side bookkeeping: the waiting queue, each request's lifecycle
record (submit -> admit -> first token -> finish, with preemptions between),
and running aggregates. The engine asks it each tick which requests to admit
into free slots.

Policies
--------
* "fcfs"    — admit in arrival order, at most `max_prefills_per_tick`
              (default 1) per tick.
* "prefill" — admit in arrival order into every free slot each tick.

Both look past up to `lookahead` unadmittable queue entries (the head keeps
its position) until the head has waited `head_age_cap` ticks.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np

from repro_torch.serve import telemetry as tel
from repro_torch.serve.sampling import SamplingParams

POLICIES = ("fcfs", "prefill")
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
    finish_reason: str = ""        # tel.ServingMetrics.retired_by_reason keys
    # per-request deadline in ms from submit (None = no deadline), enforced
    # at tick boundaries: an expired request retires with reason "deadline"
    deadline_ms: Optional[float] = None
    # preemption: evictions from a decode slot under KV pressure and the tick
    # of the latest — waiting is measured from it, so a requeued victim
    # cannot at once trigger a counter-preemption
    preempt_count: int = 0
    preempt_tick: int = -1
    # arrival order (total, unlike submit_tick which same-tick submissions
    # share): a blocked head may only preempt later arrivals
    arrival_seq: int = -1
    # generated tokens already folded into `prompt` by past preemptions
    # (out_tokens itself is never truncated: it aliases the user's Request)
    folded_tokens: int = 0
    # chunked-prefill state machine: next grid position to compute, the
    # context target, and the grid chunks still to run; prefix-cache
    # accounting rides along
    prefill_pos: int = 0
    prefill_ctx: int = 0
    cached_prefix_tokens: int = 0
    computed_prefill_tokens: int = 0
    cached_blocks: List[int] = dataclasses.field(default_factory=list)
    radix_nodes: List = dataclasses.field(default_factory=list)
    table_row: Optional[np.ndarray] = None
    # incremental radix publish cursor: full blocks already in the trie and
    # the deepest published node (pinned, so eviction cannot detach it)
    published_blocks: int = 0
    radix_tail: Optional[object] = None
    pending_chunks: List[int] = dataclasses.field(default_factory=list)
    # memoized prefix match, keyed on the radix mutation clock
    match_memo: Optional[tuple] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    def wait_age(self, tick: int) -> int:
        """Ticks waited since the last queue entry (submit, or the latest
        preemption)."""
        base = (self.preempt_tick if self.preempt_tick >= 0
                else self.submit_tick)
        return tick - base

    @property
    def queue_ticks(self) -> int:
        return self.admit_tick - self.submit_tick if self.admit_tick >= 0 else -1

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first (needs >= 2 tokens
        and a finish time)."""
        n = len(self.out_tokens)
        if (self.first_token_time is None or self.finish_time is None
                or n < 2):
            return None
        return (self.finish_time - self.first_token_time) / (n - 1)


class Scheduler:
    def __init__(self, policy: str = "fcfs",
                 max_prefills_per_tick: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 metrics: Optional[tel.ServingMetrics] = None,
                 lookahead: int = 8, head_age_cap: int = 64):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if lookahead < 0:
            raise ValueError(f"lookahead must be >= 0, got {lookahead}")
        if head_age_cap < 1:
            raise ValueError(f"head_age_cap must be >= 1, got {head_age_cap}")
        self.policy = policy
        self.lookahead = lookahead
        self.head_age_cap = head_age_cap
        if max_prefills_per_tick is None:
            max_prefills_per_tick = 1 if policy == "fcfs" else 1 << 30
        self.max_prefills_per_tick = max_prefills_per_tick
        # chunked-prefill pacing: at most this many prefill tokens per tick
        self.prefill_token_budget = prefill_token_budget
        self.waiting: Deque[RequestState] = deque()
        self.finished: Deque[RequestState] = deque(maxlen=KEEP_FINISHED)
        self.submitted = 0
        self.admitted = 0
        self.retired = 0
        self.preempted = 0
        self.hol_skips = 0       # unadmittable entries looked past by pick()
        self.max_queue_depth = 0
        self._queue_tick_sum = 0
        self._ttft_sum = 0.0
        self._ttft_n = 0
        self._computed_prefill_sum = 0
        self._cached_prefix_sum = 0
        # latency distributions: fixed-bucket histograms (bounded memory,
        # cheap quantiles). With the engine's ServingMetrics the same
        # observations land in the exported registry; otherwise standalone
        # histograms keep metrics() cheap
        self._tel = metrics
        if metrics is not None:
            self._ttft_hist = metrics.ttft
            self._tpot_hist = metrics.tpot
            self._qwait_hist = metrics.queue_wait
        else:
            self._ttft_hist, self._tpot_hist, self._qwait_hist = (
                tel.Histogram(name, "", (),
                              tel.DEFAULT_LATENCY_BUCKETS).labels()
                for name in ("serve_ttft_seconds", "serve_tpot_seconds",
                             "serve_queue_wait_seconds"))

    def submit(self, rs: RequestState, tick: int, now: float) -> None:
        rs.submit_tick = tick
        rs.submit_time = now
        rs.arrival_seq = self.submitted
        self.waiting.append(rs)
        self.submitted += 1
        self.max_queue_depth = max(self.max_queue_depth, len(self.waiting))
        if self._tel is not None:
            self._tel.requests_submitted.inc()
            self._tel.queue_depth.set(len(self.waiting))

    def pick(self, free_slots: int, tick: int,
             can_admit: Callable[[RequestState], bool]) -> List[RequestState]:
        """Requests to admit this tick, in arrival order, looking past up to
        `lookahead` blocked entries (which keep their queue position) until
        the head has waited `head_age_cap` ticks (then strict order)."""
        budget = min(free_slots, self.max_prefills_per_tick)
        chosen: List[RequestState] = []
        now = time.perf_counter()
        skipped: List[RequestState] = []
        allow_skip = self.lookahead
        if (self.waiting
                and self.waiting[0].wait_age(tick) >= self.head_age_cap):
            allow_skip = 0
        while self.waiting and len(chosen) < budget:
            if not can_admit(self.waiting[0]):
                if len(skipped) >= allow_skip:
                    break
                skipped.append(self.waiting.popleft())
                self.hol_skips += 1
                continue
            rs = self.waiting.popleft()
            rs.admit_tick = tick
            rs.admit_time = now
            self._queue_tick_sum += rs.queue_ticks
            self.admitted += 1
            chosen.append(rs)
        for rs in reversed(skipped):
            self.waiting.appendleft(rs)
        if self._tel is not None and chosen:
            # the admitted counter is published by the engine once the
            # reservation lands (requeue_front never walks it backwards)
            self._tel.queue_depth.set(len(self.waiting))
        return chosen

    def revert_admission(self, rs: RequestState) -> None:
        """Undo the admission marks pick() stamped, without touching the
        queue (shared by requeue_front and preempt)."""
        if rs.admit_tick >= 0:
            self._queue_tick_sum -= rs.queue_ticks
            self.admitted -= 1
            rs.admit_tick = -1
            rs.admit_time = None

    def requeue_front(self, rs: RequestState) -> None:
        """Return a picked-but-unadmittable request (a same-tick
        over-commit) to the queue head, reverting its admission marks."""
        self.revert_admission(rs)
        self.waiting.appendleft(rs)
        if self._tel is not None:
            self._tel.queue_depth.set(len(self.waiting))

    def preempt(self, rs: RequestState, tick: int) -> None:
        """Return an admitted-and-running request to the queue head: the
        engine evicted it from its slot under KV-pool pressure and will
        re-admit it through pick(). Admission marks are reverted and the
        preempt tick stamped, so its wait is measured from here."""
        self.preempted += 1
        rs.preempt_count += 1
        rs.preempt_tick = tick
        self.revert_admission(rs)
        self.waiting.appendleft(rs)
        if self._tel is not None:
            self._tel.preemptions.inc()
            self._tel.queue_depth.set(len(self.waiting))

    def retire(self, rs: RequestState, tick: int, now: float,
               reason: str) -> None:
        rs.finish_tick = tick
        rs.finish_time = now
        rs.finish_reason = reason
        self.retired += 1
        if rs.ttft is not None:
            self._ttft_sum += rs.ttft
            self._ttft_n += 1
            self._ttft_hist.observe(rs.ttft)
        if rs.tpot is not None:
            self._tpot_hist.observe(rs.tpot)
        if rs.admit_time is not None:
            self._qwait_hist.observe(rs.admit_time - rs.submit_time)
        self._computed_prefill_sum += rs.computed_prefill_tokens
        self._cached_prefix_sum += rs.cached_prefix_tokens
        self.finished.append(rs)
        if self._tel is not None:
            self._tel.retired_by_reason[reason].inc()

    def ttft_percentiles(self, qs=(50, 90, 99)) -> List[Optional[float]]:
        """Exact TTFT percentiles over the retained `finished` window (the
        live metrics() snapshot uses the histogram estimates instead)."""
        return tel.percentiles(
            [rs.ttft for rs in self.finished if rs.ttft is not None], qs)

    def metrics(self) -> dict:
        return {
            "policy": self.policy,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "retired": self.retired,
            "preempted": self.preempted,
            "hol_skips": self.hol_skips,
            "waiting": len(self.waiting),
            "max_queue_depth": self.max_queue_depth,
            "mean_queue_ticks": (self._queue_tick_sum / self.admitted
                                 if self.admitted else 0.0),
            "mean_ttft_s": (self._ttft_sum / self._ttft_n
                            if self._ttft_n else None),
            "p50_ttft_s": self._ttft_hist.quantile(50),
            "p90_ttft_s": self._ttft_hist.quantile(90),
            "p99_ttft_s": self._ttft_hist.quantile(99),
            "p50_tpot_s": self._tpot_hist.quantile(50),
            "p99_tpot_s": self._tpot_hist.quantile(99),
            "p50_queue_wait_s": self._qwait_hist.quantile(50),
            "p99_queue_wait_s": self._qwait_hist.quantile(99),
            "prefill_tokens_per_request": (
                self._computed_prefill_sum / self.retired
                if self.retired else 0.0),
            "cached_prefix_tokens_per_request": (
                self._cached_prefix_sum / self.retired
                if self.retired else 0.0),
        }
