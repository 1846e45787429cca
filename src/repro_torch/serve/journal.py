"""Write-ahead request journal for the serving engine (durability layer).

The journal is an append-only JSONL ledger of everything the engine has
*promised* a client: request submissions, every token delivered at drain
time, and retirements. Replaying it reconstructs the exact client-visible
state of a crashed engine — which requests were live, what prefix of each
stream had already been delivered, and which requests had finished — so a
restarted engine can resume every in-flight request bit-exactly (the
engine's preemption fold/recompute mechanism does the heavy lifting; the
journal only has to remember prompts and delivered tokens, never KV state).

Like serve/telemetry.py and serve/trace.py this module is host-side only
(no torch import): a journal append is a dict -> JSON line -> OS write at
points where the engine is already running host code (submit, drain), and
can never add a kernel launch or a device sync.

The record schema is the JAX package's serve/journal.py's, record for
record: a journal is plain JSONL, so a journal one package wrote is
recovered by the other (unlike an engine snapshot, whose checkpoint shard
each package writes in its own format).

Record schema (one JSON object per line; ``kind`` discriminates):

  epoch:   {"kind": "epoch", "seq": int, "wall_time_s": float, "meta": {}}
           — appended once per engine attach (process start, recovery,
           handoff). ``seq`` increments across epochs in the same file, so
           a replay can tell how many times the serving process restarted.
  submit:  {"kind": "submit", "rid", "prompt": [int], "max_new_tokens",
            "sampling": {"temperature", "top_k", "top_p"}, "deadline_ms",
            "wall_time_s"} — deadline_ms counts from wall_time_s, so
           recovery re-admits with the residual budget (downtime included),
           never a restarted deadline.
  token:   {"kind": "token", "rid", "tok"}   — recorded when the token is
           delivered at drain (client-visible), never for tokens still in
           the pending device buffer: a crash loses undelivered ticks, and
           recovery recomputes them — nothing a client saw is ever lost,
           nothing a client never saw is ever marked delivered.
  retire:  {"kind": "retire", "rid", "reason"}

Durability model: every record is pushed to the kernel immediately
(``flush()`` on the underlying file), so an abrupt *process* death loses
nothing already recorded; ``os.fsync`` is batched (``fsync_every`` records,
plus explicit ``sync()``), bounding what an abrupt *host* death can lose.
Replay tolerates a truncated final line (the tail of a record that was
mid-write at the kill) but treats a malformed line anywhere else as
corruption and raises. Replay is idempotent: it is a pure function of the
file contents — replaying twice, or replaying a journal spanning several
crash/recover epochs, yields the same state.

Rid reuse follows the engine's contract: a rid becomes reusable once its
request is delivered, so a ``submit`` for an already-retired rid opens a
fresh request under that id (delivered tokens attach to the most recent
submit). A submit for a still-live rid is corruption and raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Any, Dict, List, Optional, Union

__all__ = ["RequestJournal", "JournalState", "LiveRecord", "replay",
           "JournalCorrupt"]


class JournalCorrupt(ValueError):
    """A malformed record somewhere other than the (truncation-tolerant)
    final line, or a record sequence no engine could have produced."""


@dataclasses.dataclass
class LiveRecord:
    """One submitted-but-not-retired request reconstructed from replay."""
    rid: int
    prompt: List[int]
    max_new_tokens: int          # original budget at submit
    sampling: Dict[str, Any]
    deadline_ms: Optional[float]
    # wall clock at the submit record (time.time); lets recovery charge a
    # deadline for the time already consumed — including downtime — instead
    # of silently restarting the full budget. None on pre-field journals.
    submit_wall_time_s: Optional[float] = None
    delivered: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class JournalState:
    """Replay result: the client-visible state the journal proves."""
    last_seq: int = -1                     # newest epoch header seen
    epochs: int = 0
    records: int = 0                       # parsed records (all kinds)
    truncated_tail: bool = False
    # byte length of the valid prefix: everything up to and including the
    # last fully parsed record. A reopening writer truncates the file here
    # so appended records never merge onto a torn tail.
    valid_bytes: int = 0
    live: Dict[int, LiveRecord] = dataclasses.field(default_factory=dict)
    retired: Dict[int, str] = dataclasses.field(default_factory=dict)


def _parse_lines(raw: bytes):
    """Yield (parsed dict | None, torn, end_offset) per line; the dict is
    None only for a truncated tail. ``end_offset`` is the byte offset just
    past the record (including its newline) — for a torn tail it is the
    offset where the torn bytes START, i.e. the length of the valid prefix.

    A trailing line without a newline, or one that fails to parse, is the
    torn tail of a crashed write and is dropped; the same defect on any
    earlier line means the file was corrupted after the fact and raises.
    """
    lines = raw.split(b"\n")
    # a cleanly-terminated file ends with b"" after the final newline
    complete, tail = lines[:-1], lines[-1]
    offset = 0
    for i, line in enumerate(complete):
        end = offset + len(line) + 1           # +1 for the newline
        if not line.strip():
            offset = end
            continue
        try:
            yield json.loads(line), False, end
        except json.JSONDecodeError as e:
            if i == len(complete) - 1 and not tail.strip():
                # torn final record that still got its newline out
                yield None, True, offset
                return
            raise JournalCorrupt(
                f"malformed journal line {i}: {line[:80]!r}") from e
        offset = end
    if tail.strip():
        try:
            # parseable but newline-less: valid, yet a reopening writer
            # must restore the separator before appending (__init__ does)
            yield json.loads(tail), False, offset + len(tail)
        except json.JSONDecodeError:
            yield None, True, offset


def replay(path: Union[str, pathlib.Path]) -> JournalState:
    """Fold a journal file into the client-visible request state.

    Pure and idempotent: the result is a function of the file bytes only.
    Missing file -> empty state (a journal that never recorded anything)."""
    state = JournalState()
    p = pathlib.Path(path)
    if not p.exists():
        return state
    raw = p.read_bytes()
    for rec, torn, end in _parse_lines(raw):
        if torn:
            state.truncated_tail = True
            state.valid_bytes = end
            break
        kind = rec.get("kind")
        state.records += 1
        state.valid_bytes = end
        if kind == "epoch":
            seq = int(rec["seq"])
            if seq <= state.last_seq:
                raise JournalCorrupt(
                    f"epoch seq {seq} not increasing (last "
                    f"{state.last_seq})")
            state.last_seq = seq
            state.epochs += 1
        elif kind == "submit":
            rid = int(rec["rid"])
            if rid in state.live:
                raise JournalCorrupt(f"submit for live rid {rid}")
            # rid reuse after delivery: the retired entry is superseded
            state.retired.pop(rid, None)
            state.live[rid] = LiveRecord(
                rid=rid, prompt=[int(t) for t in rec["prompt"]],
                max_new_tokens=int(rec["max_new_tokens"]),
                sampling=dict(rec.get("sampling") or {}),
                deadline_ms=rec.get("deadline_ms"),
                submit_wall_time_s=rec.get("wall_time_s"))
        elif kind == "token":
            rid = int(rec["rid"])
            live = state.live.get(rid)
            if live is None:
                raise JournalCorrupt(f"token for unknown rid {rid}")
            live.delivered.append(int(rec["tok"]))
        elif kind == "retire":
            rid = int(rec["rid"])
            live = state.live.pop(rid, None)
            if live is None:
                raise JournalCorrupt(f"retire for unknown rid {rid}")
            state.retired[rid] = str(rec["reason"])
        else:
            raise JournalCorrupt(f"unknown record kind {kind!r}")
    return state


class RequestJournal:
    """Append-mode journal writer with batched fsync.

    One writer per file at a time (the serving process). Construction scans
    any existing contents for the newest epoch seq so recovery epochs keep
    the sequence monotone, and truncates the torn tail of a crashed write
    (replay tolerates the tail, but appending onto it would strand a
    malformed line mid-file and poison every later replay); it does not
    hold the replayed state — call :func:`replay` for that.
    """

    def __init__(self, path: Union[str, pathlib.Path],
                 fsync_every: int = 16):
        if fsync_every < 1:
            raise ValueError(f"fsync_every must be >= 1, got {fsync_every}")
        self.path = pathlib.Path(path)
        self.fsync_every = int(fsync_every)
        self._last_seq = -1
        needs_newline = False
        if self.path.exists() and self.path.stat().st_size > 0:
            state = replay(self.path)
            self._last_seq = state.last_seq
            size = self.path.stat().st_size
            if state.valid_bytes < size:
                # torn tail of a crashed write: cut it BEFORE appending, or
                # the new epoch record would merge onto the partial line and
                # turn a tolerated tail into mid-file corruption — making a
                # second crash unrecoverable. Replay already proved nothing
                # client-visible lives in those bytes.
                with open(self.path, "r+b") as f:
                    f.truncate(state.valid_bytes)
                    os.fsync(f.fileno())
            if state.valid_bytes > 0:
                # a parseable final record that lost only its newline:
                # restore the separator so the next append starts a line
                with open(self.path, "rb") as f:
                    f.seek(state.valid_bytes - 1)
                    needs_newline = f.read(1) != b"\n"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "ab")
        if needs_newline:
            self._f.write(b"\n")
            self._f.flush()
        self._unsynced = 0
        self.records = 0
        self.syncs = 0

    # --- writing ---------------------------------------------------------

    def _append(self, rec: Dict[str, Any]) -> None:
        if self._f is None:
            raise ValueError("journal is closed")
        self._f.write((json.dumps(rec) + "\n").encode())
        # kernel-visible immediately: an abrupt process death loses nothing
        # recorded; only fsync (host durability) is batched
        self._f.flush()
        self.records += 1
        self._unsynced += 1
        if self._unsynced >= self.fsync_every:
            self.sync()

    def begin_epoch(self, meta: Optional[Dict[str, Any]] = None) -> int:
        """Append an epoch header (one per engine attach); returns its seq."""
        seq = self._last_seq + 1
        self._append({"kind": "epoch", "seq": seq,
                      "wall_time_s": time.time(), "meta": meta or {}})
        self._last_seq = seq
        return seq

    def record_submit(self, rid: int, prompt, max_new_tokens: int,
                      sampling: Optional[Dict[str, Any]] = None,
                      deadline_ms: Optional[float] = None) -> None:
        self._append({"kind": "submit", "rid": int(rid),
                      "prompt": [int(t) for t in prompt],
                      "max_new_tokens": int(max_new_tokens),
                      "sampling": sampling or {},
                      "deadline_ms": deadline_ms,
                      "wall_time_s": time.time()})

    def record_token(self, rid: int, tok: int) -> None:
        self._append({"kind": "token", "rid": int(rid), "tok": int(tok)})

    def record_retire(self, rid: int, reason: str) -> None:
        self._append({"kind": "retire", "rid": int(rid),
                      "reason": str(reason)})

    # --- durability ------------------------------------------------------

    def sync(self) -> None:
        """Force the batched fsync now (host-durability barrier)."""
        if self._f is not None and self._unsynced:
            os.fsync(self._f.fileno())
            self._unsynced = 0
            self.syncs += 1

    def close(self) -> None:
        """Sync and close. Idempotent; a closed journal refuses appends."""
        if self._f is None:
            return
        self.sync()
        self._f.close()
        self._f = None

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
