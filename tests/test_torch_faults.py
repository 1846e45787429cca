"""PyTorch port vs the JAX reference: fault containment in the serving
engine — the injection harness (serve/faults.py), deadlines, the numeric
quarantine and its scrub, the tick watchdog, the ownership audit,
chunk/step containment and the health states.

Where a case's outcome is a decision — finish reasons, streams, free
blocks, audit counts, health transitions — the reference engine (gather
path) runs the same FaultPlan on the same model (weights carried across by
from_reference) and the two must agree exactly. Wall-clock cases
(deadlines mid-decode) compare what the clock cannot move: the reason,
the freed pool and the delivered prefix of the stream.
"""
import itertools
import json
import socket
import time
import urllib.error
import urllib.request

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
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import faults as fl  # noqa: E402
from repro_torch.serve import kv_cache as tkvc  # noqa: E402

PKG = {"ref": (jeng, jfl), "port": (teng, fl)}


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


def _engine(small_lm, which, arm=(), **kw):
    """One engine of package `which` with its own FaultPlan armed with
    `arm` [(site, kwargs)] (None when `arm` is empty)."""
    jcfg, jp, tcfg, tp = small_lm
    fl_mod = PKG[which][1]
    plan = None
    if arm:
        plan = fl_mod.FaultPlan()
        for site, skw in arm:
            plan.arm(site, **skw)
    if which == "ref":
        return jeng.ServeEngine(jcfg, jp, jeng.EngineConfig(
            faults=plan, paged_impl="gather", **kw))
    return teng.ServeEngine(tcfg, tp, teng.EngineConfig(faults=plan, **kw),
                            device="cpu")


def make_requests(mod, n, max_new=4, seed=0, sampled=False, **kw):
    rng = np.random.default_rng(seed)
    mix = [(0.0, 0, 1.0), (0.8, 40, 0.9), (1.0, 0, 0.95)]
    return [mod.Request(rid=i,
                        prompt=rng.integers(2, 512,
                                            size=int(rng.integers(3, 12))),
                        max_new_tokens=max_new,
                        sampling=(mod.SamplingParams(*mix[i % 3])
                                  if sampled else mod.SamplingParams()),
                        **kw)
            for i in range(n)]


def finish_reasons(engine):
    return {rs.rid: rs.finish_reason for rs in engine.scheduler.finished}


def streams(engine):
    return {rs.rid: tuple(rs.out_tokens) for rs in engine.scheduler.finished}


def outcome(engine):
    """The decisions a run leaves: reasons, streams, free blocks, health."""
    return (finish_reasons(engine), streams(engine),
            engine.allocator.free_blocks, engine.health)


def both(small_lm, scenario, **kw):
    """Run scenario(mod, engine) on the reference and the port engine
    (built by _engine with **kw); assert equal results; return the port's
    result and engine."""
    res = {}
    for which in ("ref", "port"):
        eng = _engine(small_lm, which, **kw)
        res[which] = (scenario(PKG[which][0], eng), eng)
    assert res["port"][0] == res["ref"][0]
    return res["port"]


# ---------------------------------------------------------------------------
# FaultPlan: the reference's triggering, host-side
# ---------------------------------------------------------------------------

def _plan_ops(mod):
    out = []
    plan = mod.FaultPlan()
    plan.arm("chunk_error", rid=3)
    out += [plan.fire("chunk_error", rid=1, tick=0) is None,
            plan.fire("nan_logits", rid=3, tick=0) is None,
            plan.fire("chunk_error", rid=3, tick=0).fired,
            plan.fire("chunk_error", rid=3, tick=1) is None,
            dict(plan.injected), list(plan.log)]
    plan = mod.FaultPlan()
    plan.arm("nan_logits", nth=2)
    out += [plan.fire("nan_logits", rid=0, tick=t) is None for t in range(3)]
    plan = mod.FaultPlan()
    plan.arm("slow_step", tick=5, once=False, delay_s=0.1)
    out += [plan.fire("slow_step", tick=4) is None,
            plan.fire("slow_step", tick=5).delay_s,
            plan.fire("slow_step", tick=5) is not None,
            plan.injected["slow_step"]]
    plan = mod.FaultPlan()
    spec = plan.arm("step_error", rid=7)
    out.append(plan.fire("step_error", rid=None, tick=0) is spec)
    with pytest.raises(ValueError, match="unknown fault site"):
        mod.FaultPlan().arm("power_loss")
    with pytest.raises(ValueError, match="unknown fault site"):
        mod.FaultPlan().fire("power_loss")
    for seed in (42, 43):
        out.append([(s.site, s.rid) for s in
                    mod.FaultPlan.seeded(seed, rids=(0, 1, 2)).pending()])
    out.append([(site, reason, [(s.site, s.rid) for s in plan.pending()])
                for site, plan, reason in mod.fault_matrix(4)])
    out.append(mod.SITES)
    return out


def test_fault_plan_matches_reference():
    """Selectors and consumption, nth, tick + repeat, the None-context
    wildcard, unknown sites, seeded plans and the canonical matrix: the
    same answers as the reference's harness."""
    got, want = _plan_ops(fl), _plan_ops(jfl)
    assert got == want
    assert len(fl.SITES) == 9
    assert got[-3] != got[-4]                 # seeds 42 and 43 differ
    assert issubclass(fl.InjectedFault, RuntimeError)
    assert not issubclass(fl.ProcessCrash, fl.InjectedFault)


def test_process_crash_escapes_containment(small_lm):
    """process_crash raises out of step() (recovery is a later slice)."""
    eng = _engine(small_lm, "port", arm=[("process_crash", {})],
                  slots=1, max_seq=64, page_size=8)
    eng.submit(make_requests(teng, 1)[0])
    with pytest.raises(fl.ProcessCrash):
        eng.step()
    eng.cancel(0)
    eng.poll()


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------

def test_deadline_expires_while_waiting(small_lm):
    def scenario(mod, eng):
        eng.submit(mod.Request(rid=0, prompt=np.array([5, 6, 7], np.int32),
                               max_new_tokens=8))
        doomed = mod.Request(rid=1, prompt=np.array([8, 9, 10], np.int32),
                             max_new_tokens=8, deadline_ms=0.001)
        eng.submit(doomed)                 # queued behind the only slot
        done = eng.run([], max_ticks=100)
        return (outcome(eng), doomed.out_tokens,
                sorted(r.rid for r in done))
    (out, doomed, rids), _ = both(small_lm, scenario, slots=1, max_seq=64,
                                  page_size=8)
    assert out[0] == {0: "max_tokens", 1: "deadline"}
    assert doomed == [] and rids == [0, 1]


def test_deadline_expires_mid_decode(small_lm):
    """A decoding request past its budget retires at the next tick
    boundary, keeping its tokens (a prefix of the reference's stream — the
    clock decides where each engine cuts) and freeing its blocks. A token
    sink that takes 10 ms a token paces both engines past the 150 ms
    budget."""
    got = {}
    for which in ("ref", "port"):
        eng = _engine(small_lm, which, slots=1, max_seq=128, page_size=8,
                      max_pending_ticks=1)
        if which == "ref":
            eng.warmup()
        eng.token_sink = lambda rid, tok: time.sleep(0.01)
        mod = PKG[which][0]
        req = mod.Request(rid=0, prompt=np.array([5, 6, 7], np.int32),
                          max_new_tokens=96, deadline_ms=150.0)
        eng.submit(req)
        t0 = time.perf_counter()
        while not finish_reasons(eng) and time.perf_counter() - t0 < 30:
            eng.step()
            eng.poll()
        assert finish_reasons(eng) == {0: "deadline"}
        assert 0 < len(req.out_tokens) < 96
        assert eng.allocator.free_blocks == eng.allocator.num_blocks - 1
        got[which] = list(req.out_tokens)
    n = min(map(len, got.values()))
    assert got["port"][:n] == got["ref"][:n]


def test_deadline_must_be_positive(small_lm):
    eng = _engine(small_lm, "port", slots=1, max_seq=64)
    with pytest.raises(ValueError, match="deadline_ms"):
        eng.submit(teng.Request(rid=0, prompt=np.array([5], np.int32),
                                max_new_tokens=2, deadline_ms=0.0))


def test_cancel_and_deadline_same_tick_single_retire(small_lm):
    eng = _engine(small_lm, "port", slots=1, max_seq=64, page_size=8)
    eng.submit(teng.Request(rid=0, prompt=np.array([5, 6, 7], np.int32),
                            max_new_tokens=8, deadline_ms=0.001))
    time.sleep(0.005)
    eng.cancel(0)
    eng.step()                             # the deadline sweep runs here
    eng.poll()
    assert finish_reasons(eng)[0] in ("cancelled", "deadline")
    assert sum(1 for rs in eng.scheduler.finished if rs.rid == 0) == 1
    assert eng.allocator.free_blocks == eng.allocator.num_blocks - 1


# ---------------------------------------------------------------------------
# Numeric quarantine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampled", [False, True])
def test_injected_nan_quarantines_only_target(small_lm, sampled):
    """nan_logits retires exactly its target ("numeric_error"); every
    co-batched stream equals the fault-free run's and the reference's."""
    def scenario(mod, eng):
        eng.run(make_requests(mod, 4, max_new=6, sampled=sampled))
        return outcome(eng)
    kw = dict(slots=2, max_seq=64, page_size=8, seed=1)
    clean, _ = both(small_lm, scenario, **kw)
    fault, _ = both(small_lm, scenario, arm=[("nan_logits", {"rid": 1})],
                    **kw)
    assert fault[0][1] == "numeric_error"
    for rid in (0, 2, 3):
        assert fault[0][rid] == clean[0][rid]
        assert fault[1][rid] == clean[1][rid]
    assert fault[2] == clean[2]            # every block back


def _poison(which, eng, blk):
    if which == "port":
        for group in eng.caches:
            for pool in group:
                pool.k[:, blk] = float("nan")
                pool.v[:, blk] = float("nan")
    else:
        eng.caches = jax.tree.map(
            lambda b: (b.at[:, blk].set(jnp.nan)
                       if jnp.issubdtype(b.dtype, jnp.floating) else b),
            eng.caches)


def test_real_nan_in_pool_quarantines_slot(small_lm):
    """Real NaN written into a decoding slot's first block trips the
    on-device finite flag: that slot retires "numeric_error", the
    co-batched slot's stream equals an unpoisoned run's, its blocks are
    scrubbed and freed, and the audit finds nothing leaked — as in the
    reference engine."""
    kw = dict(slots=2, max_seq=64, page_size=8)

    def clean(mod, eng):
        eng.run(make_requests(mod, 2, max_new=8, seed=5))
        return streams(eng)
    ref_toks, _ = both(small_lm, clean, **kw)
    got = {}
    for which in ("ref", "port"):
        mod = PKG[which][0]
        eng = _engine(small_lm, which, **kw)
        for r in make_requests(mod, 2, max_new=8, seed=5):
            eng.submit(r)
        for _ in range(3):
            eng.step()
        eng.drain()
        victim = eng.slot_req[0]
        assert victim is not None and victim.blocks
        blk = victim.blocks[0]
        _poison(which, eng, blk)
        done = eng.run([], max_ticks=200)
        other = ({0, 1} - {victim.rid}).pop()
        got[which] = (victim.rid, outcome(eng), len(done),
                      eng.audit()["leaked_after"])
        assert got[which][1][0][victim.rid] == "numeric_error"
        assert got[which][1][1][other] == ref_toks[other]
        if which == "port":
            for group in eng.caches:
                for pool in group:
                    assert not pool.k[:, blk].any()
                    assert not pool.v[:, blk].any()
    assert got["port"] == got["ref"]
    assert got["port"][3] == 0


def test_quarantine_scrubs_poisoned_blocks_before_reuse(small_lm):
    """Blocks a quarantined request wrote are zeroed before they return to
    the allocator; a later request reusing them decodes what the
    reference's does."""
    def scenario(mod, eng):
        eng.run(make_requests(mod, 1, max_new=4))
        nxt = make_requests(mod, 1, max_new=4, seed=9)[0]
        nxt.rid = 5
        eng.run([nxt])
        return outcome(eng)
    out, eng = both(small_lm, scenario, arm=[("nan_logits", {"rid": 0})],
                    slots=1, max_seq=64, page_size=8)
    assert out[0][0] == "numeric_error"
    assert out[0][5] in ("eos", "max_tokens")
    for group in eng.caches:
        for pool in group:
            assert torch.isfinite(pool.k).all() and torch.isfinite(pool.v).all()


@pytest.mark.parametrize("bits", [16, 4])
def test_scrub_pool_block_matches_reference(bits):
    """scrub_pool_block: float pools to 0, packed pools to a zero payload
    with EXP_EMPTY exponents, in place, other blocks untouched."""
    from repro.quant.policy import kv_policy
    from repro.serve import kv_cache as jkvc
    from repro_torch.models.convert import pools_from_reference
    cfg = jget_config("llama3.2-3b", smoke=True)
    pol = kv_policy(bits) if bits < 16 else None
    pools = jkvc.init_paged_caches(cfg, 5, 8, dtype=jnp.float32, policy=pol)
    rng = np.random.default_rng(0)
    pools = jax.tree.map(
        lambda b: jnp.asarray(rng.integers(-3, 4, size=b.shape)
                              .astype(b.dtype)), pools)
    want = jkvc.scrub_pool_block(pools, jnp.int32(2))
    got = tkvc.scrub_pool_block(pools_from_reference(pools, device="cpu"), 2)
    for w, g in zip(jax.tree.leaves(want),
                    [t for grp in got for c in grp for t in c
                     if torch.is_tensor(t)]):
        assert np.array_equal(np.asarray(w), g.numpy())


# ---------------------------------------------------------------------------
# Tick watchdog (driven with synthetic step times, as the reference's tests)
# ---------------------------------------------------------------------------

WATCHDOG_SEQS = {
    "degrade_recover": [0.01] * 16 + [10.0, 0.01, 0.01, 0.01, 10.0],
    "breach_resets_streak": [0.01] * 16 + [10.0, 0.01, 0.01, 10.0, 0.01,
                                           0.01, 0.01],
    "floor_holds": [0.001] * 20 + [0.2, 0.24, 0.001],
}


@pytest.mark.parametrize("seq", list(WATCHDOG_SEQS))
@pytest.mark.parametrize("ticks", [4.0, None])
def test_watchdog_matches_reference(small_lm, seq, ticks):
    """The same step times through both engines' _watchdog: the same health
    after every sample, the same window (breaches stay out of it)."""
    floor = 0.25 if seq == "floor_holds" else 0.0
    trail = {}
    for which in ("ref", "port"):
        eng = _engine(small_lm, which, slots=1, max_seq=64,
                      watchdog_ticks=ticks, watchdog_floor_s=floor,
                      watchdog_recovery=3)
        hist = []
        for s in WATCHDOG_SEQS[seq]:
            eng._watchdog(s)
            hist.append((eng.health, eng.health_reason))
        trail[which] = (hist, list(eng._tick_window))
    assert trail["port"] == trail["ref"]
    states = [h for h, _ in trail["port"][0]]
    if ticks is None:
        assert set(states) == {"healthy"} and trail["port"][1] == []
        return
    # breaching samples stay out of the window
    assert max(trail["port"][1]) <= 0.24
    if seq == "floor_holds":
        assert set(states) == {"healthy"}
    elif seq == "degrade_recover":
        assert states[16:] == ["degraded"] * 3 + ["healthy", "degraded"]
    else:
        assert states[16:] == ["degraded"] * 6 + ["healthy"]


def test_slow_step_trips_the_watchdog_and_it_recovers(small_lm):
    """An injected slow_step sleeps inside the drained tick's bracket: the
    armed watchdog degrades, then recovers after watchdog_recovery
    in-threshold ticks; the streams are untouched."""
    kw = dict(slots=2, max_seq=96, page_size=8, max_pending_ticks=1,
              watchdog_floor_s=0.05, watchdog_recovery=3)
    clean = _engine(small_lm, "port", **kw)
    clean.run(make_requests(teng, 2, max_new=40))
    eng = _engine(small_lm, "port",
                  arm=[("slow_step", {"tick": 25, "delay_s": 0.3})], **kw)
    eng.run(make_requests(teng, 2, max_new=40))
    states = [(e["state"], e["reason"]) for e in eng.trace.events()
              if e["event"] == "health"]
    assert states == [("degraded", "watchdog"),
                      ("healthy", "watchdog_recovered")]
    assert streams(eng) == streams(clean)
    assert eng.metrics()["faults_injected"] == {"slow_step": 1}


# ---------------------------------------------------------------------------
# audit()
# ---------------------------------------------------------------------------

def _shared_prefix(mod, eng):
    shared = np.arange(2, 26, dtype=np.int32)
    eng.run([mod.Request(rid=0, prompt=shared, max_new_tokens=4)])
    eng.run([mod.Request(rid=1, prompt=shared.copy(), max_new_tokens=4)])


AUDIT_KW = dict(slots=2, max_seq=64, page_size=8, prefill_chunk=8,
                prefix_cache=True)


@pytest.mark.parametrize("site", ["radix_pin_leak", "block_leak", None])
def test_audit_reclaims_leaks_like_reference(small_lm, site):
    """A leaky retire (pins and cached-block refs, or private blocks) is
    found and reclaimed by audit() with the reference's counts; a second
    audit reclaims nothing; the cache still serves."""
    def scenario(mod, eng):
        _shared_prefix(mod, eng)
        pins = sum(n.pins for n in eng.radix.nodes())
        free = eng.allocator.free_blocks
        rep = eng.audit()
        rep2 = eng.audit()
        eng.run([mod.Request(rid=2, prompt=np.arange(2, 26, dtype=np.int32),
                             max_new_tokens=4)])
        drop = ("mismatches",)
        return (pins, free, {k: v for k, v in rep.items() if k not in drop},
                len(rep["mismatches"]),
                {k: v for k, v in rep2.items() if k not in drop},
                eng.allocator.free_blocks, outcome(eng),
                eng.metrics()["faults_injected"])
    arm = [(site, {"rid": 1})] if site else []
    out, eng = both(small_lm, scenario, arm=arm, **AUDIT_KW)
    pins, _, rep, nmis, rep2 = out[:5]
    assert rep["leaked_after"] == 0 and rep2["reclaimed_refs"] == 0
    assert rep2["reclaimed_pins"] == 0
    if site == "radix_pin_leak":
        assert pins > 0 and rep["reclaimed_pins"] == pins
        assert rep["reclaimed_refs"] > 0
    elif site == "block_leak":
        assert rep["reclaimed_refs"] > 0
    else:
        assert rep["reclaimed_refs"] == rep["reclaimed_pins"] == nmis == 0
    assert out[-1] == ({site: 1} if site else {})
    snap = eng.registry.snapshot()
    assert snap["serve_audit_runs_total"] == 2.0


def test_audit_mid_flight_is_safe(small_lm):
    def scenario(mod, eng):
        reqs = make_requests(mod, 2, max_new=16)
        for r in reqs:
            eng.submit(r)
        for _ in range(4):
            eng.step()
        rep = eng.audit()
        done = eng.run([], max_ticks=200)
        return rep, len(done), outcome(eng)
    (rep, n, _), _ = both(small_lm, scenario, slots=2, max_seq=64,
                          page_size=8, prefix_cache=True)
    assert rep["reclaimed_refs"] == rep["reclaimed_pins"] == 0
    assert rep["mismatches"] == [] and n == 2


def test_audit_interval_runs_automatically(small_lm):
    eng = _engine(small_lm, "port", slots=2, max_seq=64, page_size=8,
                  audit_interval=3)
    eng.run(make_requests(teng, 3, max_new=6))
    runs = eng.registry.snapshot()["serve_audit_runs_total"]
    assert runs == eng.stats["ticks"] // 3
    with pytest.raises(ValueError, match="audit_interval"):
        _engine(small_lm, "port", slots=1, max_seq=64, audit_interval=0)


# ---------------------------------------------------------------------------
# Containment: chunk, step and sink faults cost one request
# ---------------------------------------------------------------------------

CONTAIN = {
    "chunk_error": ([("chunk_error", {"rid": 1})], 4, "internal_error"),
    "step_error": ([("step_error", {"rid": 1})], 3, "internal_error"),
    "alloc_exhausted": ([("alloc_exhausted", {"rid": 2})], 4,
                        "resource_exhausted"),
}


@pytest.mark.parametrize("case", list(CONTAIN))
@pytest.mark.parametrize("sampled", [False, True])
def test_targeted_fault_contained_like_reference(small_lm, case, sampled):
    arm, n, reason = CONTAIN[case]

    def scenario(mod, eng):
        done = eng.run(make_requests(mod, n, max_new=4, sampled=sampled))
        return outcome(eng), len(done)
    (out, ndone), eng = both(small_lm, scenario, arm=arm, slots=2,
                             max_seq=64, page_size=8, seed=2)
    target = arm[0][1]["rid"]
    assert out[0][target] == reason and ndone == n
    assert all(out[0][r] in ("eos", "max_tokens")
               for r in range(n) if r != target)
    assert out[2] == eng.allocator.num_blocks - 1
    assert out[3] == "healthy"              # targeted: no degrade


def test_untargeted_step_error_degrades(small_lm):
    def scenario(mod, eng):
        eng.submit(make_requests(mod, 1, max_new=2)[0])
        eng.step()
        first = (eng.health, eng.health_reason)
        eng.mark_healthy()
        done = eng.run([], max_ticks=100)
        return first, eng.health, len(done)
    out, _ = both(small_lm, scenario, arm=[("step_error", {})], slots=1,
                  max_seq=64, page_size=8)
    assert out == (("degraded", "injected:step_error"), "healthy", 1)


def test_sink_error_contained(small_lm):
    """A token sink that raises costs its own request ("sink_error"); the
    others stream on, as the reference's engine decides."""
    def scenario(mod, eng):
        seen = []
        eng.token_sink = lambda rid, tok: seen.append((rid, tok))
        eng.run(make_requests(mod, 3, max_new=4))
        return outcome(eng), sorted(seen)
    (out, seen), _ = both(small_lm, scenario,
                          arm=[("sink_error", {"rid": 1})], slots=2,
                          max_seq=64, page_size=8)
    assert out[0][1] == "sink_error"
    assert all(rid != 1 for rid, _ in seen)


# ---------------------------------------------------------------------------
# Health states, /healthz, close()
# ---------------------------------------------------------------------------

def test_health_transitions_and_trace_events(small_lm):
    def scenario(mod, eng):
        out = [eng.health]
        eng.mark_degraded("test_reason")
        eng.mark_degraded("second")         # no-op: already degraded
        out += [eng.health, eng.health_reason]
        eng.mark_healthy()
        out.append(eng.health)
        eng.close()
        eng.mark_healthy()                  # DRAINING is terminal
        out.append(eng.health)
        out.append([(e["state"], e["reason"], e["rid"])
                    for e in eng.trace.events() if e["event"] == "health"])
        return out
    out, _ = both(small_lm, scenario, slots=1, max_seq=64)
    assert out[:5] == ["healthy", "degraded", "test_reason", "healthy",
                       "draining"]
    assert [s for s, _, _ in out[5]] == ["degraded", "healthy", "draining"]


def test_begin_draining_stops_admission(small_lm):
    eng = _engine(small_lm, "port", slots=1, max_seq=64, page_size=8)
    reqs = make_requests(teng, 2, max_new=3)
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.begin_draining()
    for _ in range(10):
        eng.step()
        eng.poll()
    assert len(reqs[0].out_tokens) == 3 and reqs[1].out_tokens == []
    assert len(eng.scheduler.waiting) == 1
    eng.cancel(1)
    eng.poll()


def test_healthz_endpoint_tracks_health(small_lm):
    eng = _engine(small_lm, "port", slots=1, max_seq=64)
    port = eng.serve_metrics(0).server_address[1]
    url = f"http://127.0.0.1:{port}/healthz"
    with urllib.request.urlopen(url) as resp:
        assert resp.status == 200
        assert json.load(resp) == {"status": "healthy"}
    eng.mark_degraded("unit_test")
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(url)
    assert exc_info.value.code == 503
    assert json.load(exc_info.value) == {"status": "degraded"}
    text = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics").read().decode()
    assert "serve_health 1.0" in text
    eng.close()


def test_close_twice_and_after_failed_step(small_lm):
    eng = _engine(small_lm, "port", arm=[("step_error", {})], slots=1,
                  max_seq=64)
    eng.submit(make_requests(teng, 1, max_new=2)[0])
    eng.step()
    assert eng.health == "degraded"
    with eng:
        pass
    assert eng.health == "draining"
    eng.close()
    assert eng.health == "draining"
    eng.cancel(0)
    eng.poll()


def test_close_stops_metrics_server_even_when_drain_raises(small_lm,
                                                           monkeypatch):
    eng = _engine(small_lm, "port", slots=1, max_seq=64)
    port = eng.serve_metrics(0).server_address[1]

    def boom(keep=0):
        raise RuntimeError("drain exploded")

    monkeypatch.setattr(eng, "_drain", boom)
    with pytest.raises(RuntimeError, match="drain exploded"):
        eng.close()
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", port))
    s.close()
    monkeypatch.undo()
    eng.close()


# ---------------------------------------------------------------------------
# cancel x preempt x drain in one tick
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order",
                         list(itertools.permutations(
                             ("cancel", "step", "drain"))),
                         ids=lambda o: "-".join(o))
def test_cancel_preempt_drain_interleavings(small_lm, order):
    """Every ordering of {cancel a decoding request, step (which preempts
    under pool pressure), drain} in one tick leaves block, pin and span
    accounting exact, with the reference engine's decisions."""
    def scenario(mod, eng):
        rng = np.random.default_rng(7)
        reqs = [mod.Request(rid=0, prompt=rng.integers(2, 512, size=8),
                            max_new_tokens=8),
                mod.Request(rid=1, prompt=rng.integers(2, 512, size=8),
                            max_new_tokens=8),
                mod.Request(rid=2, prompt=rng.integers(2, 512, size=33),
                            max_new_tokens=4)]
        for r in reqs:
            eng.submit(r)
        for _ in range(2):
            eng.step()
        eng.drain()
        ops = {"cancel": lambda: eng.cancel(0), "step": eng.step,
               "drain": eng.drain}
        for name in order:
            ops[name]()
        rep1 = eng.audit()
        eng.run([], max_ticks=400)
        rep2 = eng.audit()
        resident = len(eng.radix.block_ids())
        return (rep1, rep2, outcome(eng), resident,
                sum(n.pins for n in eng.radix.nodes()),
                eng.metrics()["preempted"])
    out, eng = both(small_lm, scenario, slots=3, max_seq=64, page_size=16,
                    num_blocks=4, preempt_after_ticks=1, prefix_cache=True)
    rep1, rep2, (fin, _, free, _), resident, pins, _ = out
    assert rep1["mismatches"] == [] and rep1["reclaimed_refs"] == 0
    assert rep2["leaked_after"] == 0 and pins == 0
    assert set(fin) == {0, 1, 2}
    assert fin[1] in ("eos", "max_tokens") and fin[2] in ("eos",
                                                          "max_tokens")
    assert free + resident == eng.allocator.num_blocks - 1
