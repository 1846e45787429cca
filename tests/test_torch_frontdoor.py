"""PyTorch port vs the JAX reference: the asyncio front door
(serve/frontdoor.py) over the port's engine — per-token streams that equal
engine.run's, cancel, backpressure, health-gated admission, tick-loop
containment, reconnect after crash recovery (`attach`), live handoff under
open streams, and ProcessCrash killing the tick task.

Each case runs the same coroutine against the reference's FrontDoor over
its engine (gather path; weights carried across by from_reference) and
against the port's, and what the clients receive — tokens, finish reasons,
refusals — must be the same.
"""
import asyncio
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import faults as jfl  # noqa: E402
from repro.serve import frontdoor as jfd  # noqa: E402
from repro.serve import journal as jjl  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import faults as tfl  # noqa: E402
from repro_torch.serve import frontdoor as tfd  # noqa: E402
from repro_torch.serve import journal as tjl  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_lm():
    jcfg = jget_config("llama3.2-3b", smoke=True)
    tcfg = tget_config("llama3.2-3b", smoke=True)
    jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, tcfg, from_reference(jp, tcfg, device="cpu")


class Pkg:
    """One package's serving surface: engine, journal, faults, door."""

    def __init__(self, which, small_lm):
        jcfg, jp, tcfg, tp = small_lm
        self.which = which
        if which == "ref":
            self.eng, self.jl, self.fl, self.fd = jeng, jjl, jfl, jfd
            self.cfg, self.params, self.dev = jcfg, jp, {}
        else:
            self.eng, self.jl, self.fl, self.fd = teng, tjl, tfl, tfd
            self.cfg, self.params, self.dev = tcfg, tp, {"device": "cpu"}

    def ecfg(self, **kw):
        if self.which == "ref":
            kw.setdefault("paged_impl", "gather")
        return self.eng.EngineConfig(**kw)

    def engine(self, **kw):
        return self.eng.ServeEngine(self.cfg, self.params, self.ecfg(**kw),
                                    **self.dev)

    def recover(self, path, **kw):
        return self.eng.ServeEngine.recover(self.cfg, self.params, path,
                                            ecfg=self.ecfg(**kw), **self.dev)

    def requests(self, n=4, max_new=4, seed=7):
        """tests/test_recovery.py's mix: even rids greedy, odd sampled."""
        rng = np.random.default_rng(seed)
        return [self.eng.Request(
            rid=i, prompt=rng.integers(2, self.cfg.vocab_size,
                                       size=int(rng.integers(3, 9))),
            max_new_tokens=max_new,
            sampling=self.eng.SamplingParams(
                temperature=0.8 if i % 2 else 0.0, top_k=8 if i % 2 else 0))
            for i in range(n)]


def both(small_lm, scenario):
    """scenario(Pkg) on the reference and on the port; equal results."""
    res = {w: scenario(Pkg(w, small_lm)) for w in ("ref", "port")}
    assert res["port"] == res["ref"]
    return res["port"]


def port_free(port):
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", port))
    s.close()


RECOVERY_ECFG = dict(slots=2, max_seq=64, seed=11)


# ---------------------------------------------------------------------------
# tests/test_frontdoor.py: streams, cancel, backpressure
# ---------------------------------------------------------------------------

def test_frontdoor_streams_match_engine_run(small_lm):
    """Async iteration delivers engine.run's exact streams, with finish
    reasons, while drain(keep=1) overlaps delivery with the next tick."""
    def scenario(P):
        rng = np.random.default_rng(0)
        prompts = [rng.integers(2, P.cfg.vocab_size,
                                size=int(rng.integers(3, 12)))
                   for _ in range(5)]
        kw = dict(slots=2, max_seq=64, page_size=8)
        ref_eng = P.engine(**kw)
        refs = [P.eng.Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        ref_eng.run(refs)
        ref_eng.close()
        engine = P.engine(**kw)

        async def serve():
            async with P.fd.FrontDoor(engine) as door:
                streams = [await door.submit(p, max_new_tokens=6)
                           for p in prompts]
                got = []
                for s in streams:
                    toks = [tok async for tok in s]
                    got.append((toks, s.finish_reason))
                return got

        got = asyncio.run(serve())
        for (toks, reason), ref in zip(got, refs):
            assert toks == ref.out_tokens and reason == "max_tokens"
        assert all(r is None for r in engine.slot_req)
        return got
    both(small_lm, scenario)


def test_frontdoor_sampled_streams_match_engine_run(small_lm):
    """The same through the door with the greedy / sampled mix."""
    def scenario(P):
        want = P.engine(**RECOVERY_ECFG)
        want_streams = {r.rid: list(r.out_tokens)
                        for r in want.run(P.requests(max_new=6))}
        want.close()
        engine = P.engine(**RECOVERY_ECFG)

        async def serve():
            async with P.fd.FrontDoor(engine) as door:
                streams = [await door.submit(r.prompt, r.max_new_tokens,
                                             sampling=r.sampling, rid=r.rid)
                           for r in P.requests(max_new=6)]
                return {s.rid: await s.drain() for s in streams}

        got = asyncio.run(serve())
        assert got == want_streams
        return got
    both(small_lm, scenario)


def test_frontdoor_cancel_stops_stream(small_lm):
    def scenario(P):
        engine = P.engine(slots=1, max_seq=128, page_size=8)
        prompt = np.array([5, 6, 7, 8, 9], np.int32)

        async def serve():
            async with P.fd.FrontDoor(engine) as door:
                stream = await door.submit(prompt, max_new_tokens=64)
                got = [await stream.__anext__() for _ in range(3)]
                assert await stream.cancel() is True
                async for tok in stream:
                    got.append(tok)
                return got, stream.finish_reason

        got, reason = asyncio.run(serve())
        assert reason == "cancelled" and 3 <= len(got) < 64
        assert engine.allocator.free_blocks == engine.allocator.num_blocks - 1
        return got, reason
    both(small_lm, scenario)


def test_frontdoor_backpressure_bounds_waiting_queue(small_lm):
    """submit() awaits instead of growing the queue past max_waiting; every
    request still completes."""
    def scenario(P):
        engine = P.engine(slots=1, max_seq=64, page_size=8)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(2, P.cfg.vocab_size, size=5)
                   for _ in range(5)]
        depth = []

        async def serve():
            async with P.fd.FrontDoor(engine, max_waiting=2) as door:
                streams = []
                for p in prompts:
                    streams.append(await door.submit(p, max_new_tokens=4))
                    depth.append(len(engine.scheduler.waiting))
                return [await s.drain() for s in streams]

        outs = asyncio.run(serve())
        assert max(depth) <= 2 and all(len(t) == 4 for t in outs)
        with pytest.raises(ValueError, match="max_waiting"):
            P.fd.FrontDoor(P.engine(slots=1, max_seq=64), max_waiting=0)
        return depth, outs
    both(small_lm, scenario)


def test_frontdoor_submit_requires_running(small_lm):
    for w in ("ref", "port"):
        P = Pkg(w, small_lm)
        engine = P.engine(slots=1, max_seq=64)

        async def bad():
            door = P.fd.FrontDoor(engine)
            with pytest.raises(RuntimeError, match="not running"):
                await door.submit(np.array([5, 6, 7], np.int32))
            door.start()
            with pytest.raises(RuntimeError, match="already started"):
                door.start()
            await door.stop()
            await door.stop()                   # idempotent

        asyncio.run(bad())
        engine.close()


# ---------------------------------------------------------------------------
# tests/test_faults.py: health-gated admission, tick-loop containment
# ---------------------------------------------------------------------------

def test_frontdoor_refuses_submits_when_degraded_and_recovers(small_lm):
    """A slow step trips the watchdog mid-serve: the door raises
    EngineUnhealthy for new submits while the in-flight stream drains;
    in-threshold ticks recover the engine and submits flow again."""
    def scenario(P):
        plan = P.fl.FaultPlan()
        plan.arm("slow_step", delay_s=0.3, nth=18)
        engine = P.engine(slots=2, max_seq=128, page_size=8, faults=plan,
                          watchdog_ticks=2.0, watchdog_floor_s=0.0,
                          watchdog_recovery=4)
        prompt = np.array([5, 6, 7], np.int32)

        async def serve():
            async with P.fd.FrontDoor(engine) as door:
                s1 = await door.submit(prompt, max_new_tokens=96)
                while engine.health == "healthy" and not s1.finish_reason:
                    await asyncio.sleep(0.005)
                assert engine.health == "degraded", "watchdog never tripped"
                with pytest.raises(P.fd.EngineUnhealthy) as e:
                    await door.submit(prompt, max_new_tokens=4)
                assert e.value.state == "degraded"
                assert e.value.reason == "watchdog"
                while engine.health == "degraded" and not s1.finish_reason:
                    await asyncio.sleep(0.005)
                assert engine.health == "healthy", "watchdog never recovered"
                s2 = await door.submit(prompt, max_new_tokens=4)
                out2 = await s2.drain()
                await s1.cancel()
                await s1.drain()
                return out2, s1.finish_reason

        out2, reason1 = asyncio.run(serve())
        assert len(out2) == 4 and reason1 == "cancelled"
        return out2, engine.metrics()["faults_injected"]
    out2, injected = both(small_lm, scenario)
    assert injected == {"slow_step": 1}


def test_frontdoor_tick_error_degrades_but_streams_drain(small_lm):
    """An exception the tick loop cannot pin on one request degrades the
    engine (submits refused) but the loop keeps draining."""
    def scenario(P):
        engine = P.engine(slots=1, max_seq=64, page_size=8)
        real_step = engine.step
        fired = []

        def step_once_broken():
            if not fired:
                fired.append(True)
                raise RuntimeError("transient device error")
            return real_step()

        engine.step = step_once_broken

        async def serve():
            async with P.fd.FrontDoor(engine) as door:
                s1 = await door.submit(np.array([5, 6, 7], np.int32),
                                       max_new_tokens=4)
                while engine.health == "healthy":
                    await asyncio.sleep(0.002)
                reason = engine.health_reason
                with pytest.raises(P.fd.EngineUnhealthy):
                    await door.submit(np.array([5], np.int32),
                                      max_new_tokens=2)
                out = await s1.drain()
                engine.mark_healthy()
                s2 = await door.submit(np.array([5], np.int32),
                                       max_new_tokens=2)
                return reason, out, await s2.drain()

        reason, out, out2 = asyncio.run(serve())
        assert reason == "tick_error:RuntimeError"
        assert len(out) == 4 and len(out2) == 2
        return reason, out, out2
    both(small_lm, scenario)


def test_frontdoor_aexit_closes_engine_after_tick_task_death(small_lm):
    """__aexit__ closes the engine (its metrics port released) even when
    the tick task died outside its containment; stop() re-raises the error
    once and a second stop() is a no-op."""
    P = Pkg("port", small_lm)
    engine = P.engine(slots=1, max_seq=64, page_size=8)
    port = engine.serve_metrics(0).server_address[1]

    async def serve():
        door = P.fd.FrontDoor(engine)
        door.start()

        def boom():
            raise RuntimeError("tick task killed")

        door._has_work = boom
        for _ in range(200):
            await asyncio.sleep(0.005)
            if door._task is not None and door._task.done():
                break
        assert door._task is not None and door._task.done()
        with pytest.raises(RuntimeError, match="tick task killed"):
            await door.__aexit__(None, None, None)
        await door.stop()

    asyncio.run(serve())
    assert engine.health == "draining"
    port_free(port)


# ---------------------------------------------------------------------------
# tests/test_recovery.py: reconnect, live handoff, process crash
# ---------------------------------------------------------------------------

def test_frontdoor_attach_delivers_exact_suffix(small_lm, tmp_path):
    """After a crash at tick 3 and recovery, a client that acknowledged n
    tokens receives exactly out_tokens[n:]; unknown rids raise KeyError."""
    def scenario(P):
        jpath = tmp_path / f"fd_{P.which}.journal"
        plan = P.fl.FaultPlan()
        plan.arm("process_crash", tick=3)
        eng = P.engine(journal=P.jl.RequestJournal(jpath), faults=plan,
                       **RECOVERY_ECFG)
        eng._owns_journal = True
        for r in P.requests():
            eng.submit(r)
        with pytest.raises(P.fl.ProcessCrash):
            for _ in range(100):
                eng.step()
                eng.poll()
        del eng
        state = P.jl.replay(jpath)
        assert state.live
        eng2 = P.recover(jpath, **RECOVERY_ECFG)

        async def reconnect():
            outs = {}
            async with P.fd.FrontDoor(eng2) as door:
                with pytest.raises(KeyError):
                    door.attach(10_000)
                streams = {rid: door.attach(rid, received=len(lr.delivered))
                           for rid, lr in state.live.items()}
                for rid, s in streams.items():
                    suffix = [t async for t in s]
                    outs[rid] = state.live[rid].delivered + suffix
                    assert outs[rid] == list(s.tokens)
            return outs

        return asyncio.run(reconnect())
    got = both(small_lm, scenario)
    ref = Pkg("ref", small_lm)
    want = ref.engine(**RECOVERY_ECFG)
    full = {r.rid: list(r.out_tokens) for r in want.run(ref.requests())}
    want.close()
    assert got and all(toks == full[rid] for rid, toks in got.items())


def test_frontdoor_attach_to_a_replayed_retirement(small_lm, tmp_path):
    """A request whose budget was spent before the kill (its retire torn
    off the journal) yields its undelivered suffix and ends with its real
    finish reason."""
    def scenario(P):
        jpath = tmp_path / f"torn_{P.which}.journal"
        with P.jl.RequestJournal(jpath) as j:
            j.begin_epoch()
            j.record_submit(0, [5, 6, 7], 2)
            j.record_token(0, 30)
            j.record_token(0, 31)
        eng = P.recover(jpath, **RECOVERY_ECFG)

        async def reconnect():
            async with P.fd.FrontDoor(eng) as door:
                s = door.attach(0, received=1)
                return [t async for t in s], s.finish_reason

        return asyncio.run(reconnect())
    assert both(small_lm, scenario) == ([31], "max_tokens")


@pytest.mark.parametrize("target", [{}, {"kv_bits": 4, "slots": 4}],
                         ids=["same_config", "kv4_slots4"])
def test_frontdoor_live_handoff_streams_survive(small_lm, target):
    """Open TokenStreams keep yielding across FrontDoor.handoff (the sinks
    route by rid, rids carry over); the old engine ends DRAINING. At the
    same config the streams equal an uninterrupted run's."""
    def scenario(P):
        src = P.engine(**RECOVERY_ECFG)
        tgt = P.engine(**{**RECOVERY_ECFG, **target})

        async def serve():
            async with P.fd.FrontDoor(src) as door:
                streams = [await door.submit(r.prompt, r.max_new_tokens,
                                             sampling=r.sampling, rid=r.rid)
                           for r in P.requests()]
                guard = 0
                while sum(len(s.tokens) for s in streams) < 3:
                    await asyncio.sleep(0)
                    guard += 1
                    assert guard < 100000
                summary = await door.handoff(tgt)
                assert door.engine is tgt
                assert src.token_sink is None and src.retire_sink is None
                outs = {s.rid: await s.drain() for s in streams}
                return summary, outs, [s.finish_reason for s in streams]

        summary, outs, reasons = asyncio.run(serve())
        assert summary["transferred"] >= 1 and src.health == "draining"
        assert all(r == "max_tokens" for r in reasons)
        src.close()
        return summary["transferred"], outs
    _, got = both(small_lm, scenario)
    if not target:
        ref = Pkg("ref", small_lm)
        want = ref.engine(**RECOVERY_ECFG)
        full = {r.rid: list(r.out_tokens) for r in want.run(ref.requests())}
        want.close()
        assert got == full


def test_frontdoor_process_crash_kills_tick_task(small_lm):
    """The tick loop's containment does not swallow a process crash: the
    task dies and stop() raises ProcessCrash; the engine is not degraded."""
    def scenario(P):
        plan = P.fl.FaultPlan()
        plan.arm("process_crash", tick=2)
        eng = P.engine(faults=plan, **RECOVERY_ECFG)

        async def serve():
            door = P.fd.FrontDoor(eng)
            door.start()
            stream = await door.submit(np.array([5, 6, 7]), 4)
            guard = 0
            while not door._task.done():
                await asyncio.sleep(0)
                guard += 1
                assert guard < 100000
            with pytest.raises(P.fl.ProcessCrash) as e:
                await door.stop()
            return e.value.tick, list(stream.tokens)

        tick, toks = asyncio.run(serve())
        health = eng.health
        eng.cancel(0)
        eng.poll()
        eng.close()
        return tick, toks, health
    tick, _, health = both(small_lm, scenario)
    assert tick == 2 and health == "healthy"
