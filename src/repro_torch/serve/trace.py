"""Per-request lifecycle tracing for the serving engine.

Every request leaves a span of events — submit -> queued -> admit (with the
cached-prefix split) -> each prefill chunk -> first_token -> finish — in a
bounded ring buffer with monotonic (``time.perf_counter``) timestamps,
exported as JSONL. This is the "where did this request's latency go?" record
the metrics registry's aggregates cannot answer, and the substrate later
ROADMAP items (preemption, speculative decode) will add event types to.

Like serve/telemetry.py this module is host-side only (no torch import):
recording an event is a dict append on a deque, it happens at points where
the engine is already running host code, and it can never launch a kernel
or add a device sync. Decode is deliberately recorded as ONE
span-closing summary on ``finish`` (token count + TPOT), not one event per
token — per-token host work is exactly what the on-device decode loop
exists to avoid.

Ring-buffer semantics: the event ring is bounded (`capacity`), so a
long-lived engine's trace cost is O(capacity); old events fall off. Span
*accounting* (opened/closed request ids) is tracked separately and exactly,
so leak detection — a request submitted but never finished — survives ring
eviction. The port's engine tests validate every live recorder after each
test via the module-level registry below (drain_recorders).

Event schema (stable — tests/test_torch_telemetry.py pins it):

  every event:  {"ts": float, "rid": int, "event": str, ...}
  submit:       prompt_len, max_new_tokens
  queued:       queue_depth
  admit:        slot, cached_prefix_tokens, suffix_tokens, blocks_reserved
  prefill_chunk: p0, tokens, kind ("computed"; cached chunks are skipped by
                 construction and show up as admit.cached_prefix_tokens)
  activate:     slot, context_tokens            (decode-visible from here)
  first_token:  ttft_s
  preempt:      slot, tokens_generated, blocks_freed   (the span stays open:
                 the request is requeued and later re-admitted — its next
                 admit/activate pair is the resume)
  finish:       reason (a ServingMetrics.retired_by_reason key), tokens,
                 decode_s, tpot_s
  handoff:      tokens_generated — the request was transferred to another
                 engine (live handoff / snapshot extraction); closes the
                 span on THIS recorder like finish (the request is no
                 longer this engine's), the target engine opens a new one
  restore:      delivered_tokens — a request re-admitted from a journal/
                 snapshot (follows its submit event on the new engine)
  health:       state ("healthy"|"degraded"|"draining"|"handoff"), reason —
                 engine health transitions (rid is -1: not a request event)
  epoch:        wall_time_s  (export-time header, not a ring event: one
                 ``time.time()`` <-> ``perf_counter`` pair anchoring every
                 monotonic ts to the wall clock, so traces correlate across
                 processes and with Prometheus scrape times)
"""
from __future__ import annotations

import json
import time
import weakref
from collections import deque
from typing import Dict, Iterable, List, Optional, Set

__all__ = ["TraceRecorder", "NullTraceRecorder", "EVENT_FIELDS",
           "validate_event", "live_recorders"]

# event type -> required attribute keys (besides ts/rid/event)
EVENT_FIELDS: Dict[str, tuple] = {
    "submit": ("prompt_len", "max_new_tokens"),
    "queued": ("queue_depth",),
    "admit": ("slot", "cached_prefix_tokens", "suffix_tokens",
              "blocks_reserved"),
    "prefill_chunk": ("p0", "tokens", "kind"),
    "activate": ("slot", "context_tokens"),
    "first_token": ("ttft_s",),
    "preempt": ("slot", "tokens_generated", "blocks_freed"),
    "finish": ("reason", "tokens", "decode_s", "tpot_s"),
    "handoff": ("tokens_generated",),
    "restore": ("delivered_tokens",),
    "health": ("state", "reason"),
    "epoch": ("wall_time_s",),
}

_OPENING = "submit"
# both close a span: finish retires the request; handoff transfers it to
# another engine (whose recorder opens a fresh span on readmission)
_CLOSING = ("finish", "handoff")

# every recorder constructed in this process since the last drain — the
# tests' span-leak fixture validates and clears this after each test.
# Strong references on purpose: the fixture must still see recorders whose
# engine was a test-local that has already been garbage-collected (leak
# detection that needs the engine uses the owner weakref and degrades to
# recorder-internal checks when it is gone).
_LIVE: List["TraceRecorder"] = []


def live_recorders() -> List["TraceRecorder"]:
    return list(_LIVE)


def drain_recorders() -> List["TraceRecorder"]:
    """Hand back and forget every recorder created since the last drain
    (the tests' per-test sweep)."""
    global _LIVE
    out, _LIVE = _LIVE, []
    return out


def validate_event(ev: dict) -> Optional[str]:
    """Schema-check one event dict; returns an error string or None."""
    for field in ("ts", "rid", "event"):
        if field not in ev:
            return f"event missing {field!r}: {ev!r}"
    kind = ev["event"]
    if kind not in EVENT_FIELDS:
        return f"unknown event type {kind!r}: {ev!r}"
    if not isinstance(ev["ts"], float):
        return f"non-float ts: {ev!r}"
    missing = [f for f in EVENT_FIELDS[kind] if f not in ev]
    if missing:
        return f"{kind} event missing {missing}: {ev!r}"
    return None


class TraceRecorder:
    """Bounded ring of lifecycle events + exact open-span accounting."""

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError("trace capacity must be >= 1")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._open: Set[int] = set()       # rids submitted, not yet finished
        self._slot_owner: Dict[int, int] = {}   # slot -> open rid decoding
        self._leaks: List[str] = []        # exact, survives ring eviction
        self._owner: Optional[weakref.ref] = None
        self.dropped = 0                   # events evicted by the ring bound
        self.recorded = 0
        _LIVE.append(self)

    @property
    def enabled(self) -> bool:
        return True

    def attach_owner(self, engine) -> None:
        """Weakly remember the owning engine so leak checks can cross-check
        open spans against its live request table while it exists."""
        self._owner = weakref.ref(engine)

    # --- recording ------------------------------------------------------

    def record(self, rid: int, event: str, **attrs) -> None:
        rid = int(rid)
        ev = {"ts": time.perf_counter(), "rid": rid, "event": event}
        ev.update(attrs)
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(ev)
        self.recorded += 1
        if event == _OPENING:
            self._open.add(rid)
        elif event in _CLOSING:
            self._open.discard(rid)
            self._slot_owner = {s: r for s, r in self._slot_owner.items()
                                if r != rid}
        elif event == "preempt":
            # the span stays open (the request is requeued, not retired) but
            # the slot is vacated — without this the slot-recycle oracle
            # below would flag the victim as a leak on the next admit
            slot = int(attrs["slot"])
            if self._slot_owner.get(slot) == rid:
                del self._slot_owner[slot]
        elif event == "admit":
            # slot recycling is the recorder-internal leak oracle: the
            # engine only re-admits into a slot after retiring its previous
            # request, so an open span still owning the slot means that
            # request was retired without a finish event
            slot = int(attrs["slot"])
            prev = self._slot_owner.get(slot)
            if prev is not None and prev != rid and prev in self._open:
                self._leaks.append(
                    f"span leak: rid {prev} still open when slot {slot} "
                    f"was re-admitted to rid {rid}")
            self._slot_owner[slot] = rid

    # --- reading --------------------------------------------------------

    def events(self, rid: Optional[int] = None) -> List[dict]:
        if rid is None:
            return list(self._ring)
        return [ev for ev in self._ring if ev["rid"] == rid]

    def open_rids(self) -> Set[int]:
        """Requests with a submit event and no finish event yet. Exact even
        after ring eviction (tracked out-of-band)."""
        return set(self._open)

    def validate(self) -> List[str]:
        """Schema-check every buffered event, ring timestamp monotonicity,
        per-request ordering (nothing after finish), and accumulated
        slot-recycle span leaks."""
        errs = [e for e in (validate_event(ev) for ev in self._ring)
                if e is not None]
        finished: Set[int] = set()
        prev = None
        for ev in self._ring:
            if prev is not None and ev["ts"] < prev:
                errs.append(f"non-monotonic ring timestamps at {ev!r}")
            prev = ev["ts"]
            if ev["event"] == _OPENING:
                # rids are reusable once delivered: a fresh submit opens a
                # new span for the same id (engine.poll drops the old one)
                finished.discard(ev["rid"])
            elif ev["rid"] in finished:
                errs.append(f"event after finish for rid {ev['rid']}: {ev!r}")
            if ev["event"] in _CLOSING:
                finished.add(ev["rid"])
        return errs + list(self._leaks)

    def check_leaks(self,
                    live_rids: Optional[Iterable[int]] = None) -> List[str]:
        """Open spans not accounted for by a still-live request are leaks
        (the engine retired the request without closing its span).

        With no `live_rids`, the attached owner engine's live request table
        is used; if the engine is already gone, only the accumulated
        slot-recycle leaks (exact, engine-independent) are reported."""
        if live_rids is None:
            owner = self._owner() if self._owner is not None else None
            if owner is None:
                return list(self._leaks)
            live_rids = owner._requests.keys()
        live = set(int(r) for r in live_rids)
        return list(self._leaks) + [
            f"span leak: rid {rid} submitted but never finished "
            "and no longer live" for rid in sorted(self._open - live)]

    # --- export ---------------------------------------------------------

    def export_jsonl(self, path_or_file) -> int:
        """Write the trace as JSONL: one `epoch` header line anchoring the
        monotonic clock to the wall clock, then every buffered event in ring
        order. Returns the number of lines written (events + 1).

        Event timestamps are ``time.perf_counter()`` values, which are only
        meaningful within this process; the header samples both clocks at
        export time so a consumer can convert any event to wall-clock time
        as ``wall_time_s - (header.ts - event.ts)``."""
        lines = [{"ts": time.perf_counter(), "rid": -1, "event": "epoch",
                  "wall_time_s": time.time()}]
        lines.extend(self.events())
        if hasattr(path_or_file, "write"):
            for ev in lines:
                path_or_file.write(json.dumps(ev) + "\n")
        else:
            with open(path_or_file, "w") as f:
                for ev in lines:
                    f.write(json.dumps(ev) + "\n")
        return len(lines)


class NullTraceRecorder:
    """Telemetry-off recorder: every operation is a no-op, so the disabled
    path costs one attribute lookup and a dead call. Never registered in the
    live-recorder set (nothing to validate)."""

    capacity = 0
    dropped = 0
    recorded = 0

    @property
    def enabled(self) -> bool:
        return False

    def attach_owner(self, engine) -> None:
        pass

    def record(self, rid: int, event: str, **attrs) -> None:
        pass

    def events(self, rid: Optional[int] = None) -> List[dict]:
        return []

    def open_rids(self) -> Set[int]:
        return set()

    def validate(self) -> List[str]:
        return []

    def check_leaks(self,
                    live_rids: Optional[Iterable[int]] = None) -> List[str]:
        return []

    def export_jsonl(self, path_or_file) -> int:
        return 0
