"""Asyncio streaming front door over the port's ServeEngine: per-token
streams, overlapped host/device scheduling, cancellation, and backpressure
(the JAX package's serve/frontdoor.py over this port's engine).

The engine's native surface is a host-driven tick loop (submit / step /
poll) that delivers tokens in drained batches — right for benchmarks, wrong
for serving: a caller wants an ``async submit()`` whose result yields tokens
as they are generated, cancellation when the client disconnects, and an
admission queue that applies backpressure instead of growing without bound.
FrontDoor is that layer. It owns one background tick task and stays
single-threaded: every engine call happens on the event loop, so no engine
state is ever touched concurrently — concurrency here is interleaving, not
parallelism, which is exactly what the engine's host bookkeeping (and one
CUDA stream's in-order launches) wants.

Overlap: each loop iteration runs ``engine.step()`` (enqueues decode tick
N+1, non-blocking) and then ``engine.drain(keep=1)`` — syncing only ticks
the device has already finished while it executes the tick just dispatched;
on CUDA that drain's one device -> host copy is the loop's only sync.
Token delivery therefore proceeds *during* the device step instead of
serializing behind it. Per-token hooks (``token_sink``/``retire_sink``)
route straight into per-request ``asyncio.Queue`` streams at drain time; a
request's stream survives preemption transparently (the engine re-admits
and recomputes bit-exactly; the stream just keeps yielding).

Overload control is backpressure + preemption, never refusal: ``submit()``
awaits while the waiting queue is at ``max_waiting`` (arrival pacing), and
under KV-pool pressure the engine preempts later arrivals rather than
erroring the blocked head (engine._maybe_preempt). No admission path raises
on overload.

Under a serving mesh the door runs on global rank 0 alone. Its submits and
cancels ride the next tick's mesh sync to the other ranks, which apply
them before they schedule (ServeEngine._mesh_sync), so every rank's engine
admits alike. The other ranks run ``follow(engine)``: the same loop of
step, drain(keep=1) and reap, until rank 0 sends the close (stop()) — or a
handoff, which each follower makes to its own next target. An idle door
still ticks every HEARTBEAT_S seconds under a mesh, so a follower waiting
in the sync never reaches the collective timeout.
"""
from __future__ import annotations

import asyncio
import itertools
from typing import AsyncIterator, List, Optional

import numpy as np

from repro_torch.serve.engine import HEALTHY, Request, ServeEngine
from repro_torch.serve.faults import ProcessCrash
from repro_torch.serve.sampling import SamplingParams

__all__ = ["FrontDoor", "TokenStream", "EngineUnhealthy", "follow"]

_FINISH = object()       # in-queue sentinel terminating a TokenStream
HEARTBEAT_S = 1.0        # an idle door's tick under a mesh (< the mesh's
# 60 s collective timeout, which a waiting follower would otherwise reach)


class EngineUnhealthy(RuntimeError):
    """submit() refused because the engine is DEGRADED or DRAINING.

    In-flight streams keep draining (the tick loop still runs); only *new*
    admissions are refused while unhealthy — the same contract /healthz
    gives a load balancer. Retry after recovery (the watchdog auto-recovers
    a watchdog-tripped engine)."""

    def __init__(self, state: str, reason: str):
        super().__init__(f"engine is {state} ({reason or 'no reason'}); "
                         "new submits refused")
        self.state = state
        self.reason = reason


class TokenStream:
    """One request's async token stream.

    Async-iterate to receive tokens as the engine generates them; iteration
    ends when the request retires (EOS, max_tokens, or cancellation) and
    ``finish_reason`` is set from then on. ``tokens`` accumulates everything
    yielded so far (it aliases the engine's live output list, so it is
    up to date even between reads)."""

    def __init__(self, rid: int, door: "FrontDoor", tokens: List[int]):
        self.rid = rid
        self.tokens = tokens          # live alias of Request.out_tokens
        self.finish_reason: Optional[str] = None
        self._door = door
        self._q: asyncio.Queue = asyncio.Queue()

    # engine-side (called from the tick task via the engine sinks)
    def _push(self, tok: int) -> None:
        self._q.put_nowait(tok)

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self._q.put_nowait(_FINISH)

    # client-side
    def __aiter__(self) -> AsyncIterator[int]:
        return self

    async def __anext__(self) -> int:
        item = await self._q.get()
        if item is _FINISH:
            raise StopAsyncIteration
        return item

    async def drain(self) -> List[int]:
        """Consume the stream to completion; returns the full token list."""
        async for _ in self:
            pass
        return self.tokens

    async def cancel(self) -> bool:
        """Cancel this request wherever it is (queued, prefilling,
        decoding); its blocks/pins are released immediately. Returns False
        if it had already finished — the stream then ends with the original
        finish reason and keeps every generated token."""
        return await self._door.cancel(self.rid)


class FrontDoor:
    """Async serving facade owning a ServeEngine and its tick loop.

    Use as an async context manager (or call start()/stop()); while it is
    running, do not drive the engine's submit/step/poll directly — the
    front door owns the engine's token/retire sinks and its tick cadence.

    `max_waiting`: admission backpressure — submit() awaits while this many
    requests are queued (None = unbounded). Pacing arrivals at the door
    keeps the waiting queue (and its memory) bounded without ever refusing
    a request."""

    def __init__(self, engine: ServeEngine,
                 max_waiting: Optional[int] = None):
        if max_waiting is not None and max_waiting < 1:
            raise ValueError(f"max_waiting must be >= 1, got {max_waiting}")
        if engine.rank != 0:
            raise ValueError("under a serving mesh the front door runs on "
                             "global rank 0; the other ranks run "
                             "frontdoor.follow(engine)")
        engine._leader = engine.mesh is not None
        self.engine = engine
        self.max_waiting = max_waiting
        self._streams: dict = {}            # rid -> TokenStream (live)
        self._rids = itertools.count()
        self._task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()        # submit -> tick task
        self._space = asyncio.Event()       # tick task -> blocked submitters
        self._running = False
        engine.token_sink = self._on_token
        engine.retire_sink = self._on_retire

    # --- engine sinks (tick-task context) --------------------------------

    def _on_token(self, rid: int, tok: int) -> None:
        stream = self._streams.get(rid)
        if stream is not None:
            stream._push(tok)

    def _on_retire(self, rid: int, reason: str) -> None:
        stream = self._streams.pop(rid, None)
        if stream is not None:
            stream._finish(reason)

    # --- client API ------------------------------------------------------

    async def submit(self, prompt, max_new_tokens: int = 32,
                     sampling: Optional[SamplingParams] = None,
                     encoder_frames=None,
                     rid: Optional[int] = None) -> TokenStream:
        """Enqueue one request; returns its TokenStream immediately (tokens
        arrive as the engine generates them). Awaits under backpressure
        when the waiting queue is at max_waiting. `rid` defaults to a fresh
        id; passing one that collides with a live request raises (same
        contract as ServeEngine.submit)."""
        if not self._running:
            raise RuntimeError("FrontDoor is not running (use 'async with' "
                               "or call start())")
        self._check_health()
        while (self.max_waiting is not None
               and len(self.engine.scheduler.waiting) >= self.max_waiting):
            self._space.clear()
            await self._space.wait()
        # the engine may have degraded while this submitter waited for
        # queue space — refuse here too, never enqueue into a sick engine
        self._check_health()
        if rid is None:
            rid = next(self._rids)
            while rid in self.engine._requests:
                rid = next(self._rids)
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=int(max_new_tokens),
                      sampling=sampling or SamplingParams(),
                      encoder_frames=encoder_frames)
        self.engine.submit(req)
        stream = TokenStream(rid, self, req.out_tokens)
        self._streams[rid] = stream
        self._wake.set()
        return stream

    def _check_health(self) -> None:
        health = self.engine.health
        if health != HEALTHY:
            raise EngineUnhealthy(health, self.engine.health_reason)

    def attach(self, rid: int, received: int = 0) -> TokenStream:
        """Reconnect a client to a request that survived a crash recovery
        or handoff: returns a fresh TokenStream for live request `rid`,
        primed with exactly the tokens the client has not yet acknowledged
        (``out_tokens[received:]``) — never a duplicate, never a gap. A
        request that already finished (e.g. its retirement was replayed
        from the journal) yields its undelivered suffix and terminates
        with the real finish reason. Raises KeyError for an unknown rid."""
        req = self.engine._requests.get(rid)
        if req is None:
            raise KeyError(f"rid {rid} is not live on this engine")
        stream = TokenStream(rid, self, req.out_tokens)
        for tok in req.out_tokens[received:]:
            stream._push(tok)
        done = next((rs for rs in self.engine._finished_unpolled
                     if rs.rid == rid), None)
        if done is not None:
            stream._finish(done.finish_reason)
        else:
            self._streams[rid] = stream
            self._wake.set()
        return stream

    async def handoff(self, target: ServeEngine) -> dict:
        """Swap the owned engine for `target` with zero downtime: drains
        the old engine, transfers every live request (ServeEngine.handoff),
        rebinds the token/retire sinks, and points the tick loop at the new
        engine — open TokenStreams keep yielding across the swap because
        sinks route by rid and rids carry over. The old engine ends
        DRAINING and stays with the caller (close it when done with its
        metrics/traces); stop()/the context manager close the new one.
        Under a mesh the followers hand off at the same tick (a control
        sync first), each to its own next target (follow())."""
        old = self.engine
        if old.mesh is not None:
            old.send_control("handoff")
        summary = old.handoff(target)
        old._leader = False
        target._leader = target.mesh is not None
        target.token_sink = self._on_token
        target.retire_sink = self._on_retire
        old.token_sink = None
        old.retire_sink = None
        for rid, stream in self._streams.items():
            req = target._requests.get(rid)
            if req is not None:
                # re-alias: readmission built a fresh out_tokens list (the
                # delivered prefix included); the old engine's list is dead
                stream.tokens = req.out_tokens
        self.engine = target
        self._wake.set()
        self._space.set()
        return summary

    async def cancel(self, rid: int) -> bool:
        """Cancel a live request; see ServeEngine.cancel for semantics.
        The request's stream ends with finish_reason "cancelled" (or its
        real reason, if it won the race and finished first). Allowed in any
        health state — cancellation releases resources, which is exactly
        what a degraded engine wants."""
        cancelled = self.engine.cancel(rid)
        self.engine.reap()
        return cancelled

    # --- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("FrontDoor already started")
        self._running = True
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        """Stop the tick task. In-flight requests stay live inside the
        engine (their streams resume if the door is started again);
        call engine.close() — or use the context manager — to also stop
        the owned metrics endpoint. Idempotent and exception-safe: the
        task handle is detached before awaiting, so a tick task that died
        on an exception is awaited (and its error surfaced) exactly once,
        and a second stop() is a no-op."""
        self._running = False
        self._wake.set()
        task, self._task = self._task, None
        if task is not None:
            await task

    async def __aenter__(self) -> "FrontDoor":
        self.start()
        return self

    async def __aexit__(self, *exc) -> bool:
        # exception-safe: even when stop() re-raises a tick-task error, the
        # engine is closed — metrics server stopped, thread joined, port
        # released (engine.close() is itself idempotent + exception-safe)
        try:
            await self.stop()
        finally:
            self.engine.close()
        return False

    # --- tick task -------------------------------------------------------

    def _has_work(self) -> bool:
        eng = self.engine
        return bool(eng.scheduler.waiting or eng._pending
                    or any(r is not None for r in eng.slot_req))

    async def _run(self) -> None:
        while self._running:
            # re-read per iteration: handoff() swaps the owned engine while
            # the loop runs, and the next tick must drive the new one
            eng = self.engine
            if not self._has_work():
                self._wake.clear()
                self._space.set()           # empty queue: admit freely
                if eng.mesh is None:
                    await self._wake.wait()
                    continue
                # under a mesh the followers wait in the tick's sync: tick
                # (with no work) at least every HEARTBEAT_S
                try:
                    await asyncio.wait_for(self._wake.wait(), HEARTBEAT_S)
                except asyncio.TimeoutError:
                    pass
                if not self._running:
                    break
                eng = self.engine
            # dispatch tick N+1, then deliver every tick the device has
            # already retired — the newest enqueued tick keeps executing
            # while the host runs delivery and the streams' consumers
            try:
                eng.step()
                eng.drain(keep=1)
                eng.reap()
            except ProcessCrash:
                # simulated hard process death: a crashed process cannot
                # contain its own crash — the tick task dies with it, and
                # recovery is journal replay in a fresh engine/door
                raise
            except Exception as e:
                # tick-level containment: a step/drain failure the engine
                # could not attribute to one request degrades the engine
                # (submit() starts refusing) but the loop keeps running —
                # in-flight streams drain to completion instead of hanging
                # their consumers on a dead tick task
                eng.mark_degraded(f"tick_error:{type(e).__name__}")
                try:
                    eng.drain()
                    eng.reap()
                except Exception:
                    pass    # the next iteration retries delivery
            if (self.max_waiting is None
                    or len(eng.scheduler.waiting) < self.max_waiting):
                self._space.set()
            # hand the loop to submitters/consumers once per tick
            await asyncio.sleep(0)
        self.engine.drain()                 # deliver any still-pending ticks
        self.engine.reap()
        if self.engine.mesh is not None:
            self.engine.send_control("close")


def follow(engine: ServeEngine, targets=()) -> ServeEngine:
    """A mesh rank other than global rank 0 while rank 0 runs a FrontDoor:
    step, drain(keep=1) and reap, as the door's loop does, each step taking
    rank 0's submits, cancels and deadlines from its sync, until rank 0
    closes the door. At a handoff the engine hands off to the next of
    `targets` (the counterpart of rank 0's FrontDoor.handoff target) and
    follows it. Returns the engine followed last (the caller closes it)."""
    targets = list(targets)
    while True:
        engine.step()
        control, engine._control = engine._control, None
        if control == "close":
            break
        if control == "handoff":
            target = targets.pop(0)
            engine.handoff(target)
            engine = target
            continue
        engine.drain(keep=1)
        engine.reap()
    engine.drain()
    engine.reap()
    return engine
