"""PyTorch port vs the JAX reference: head-of-line admission, preemption and
cancellation in the serving engine.

The scheduler's pick/preempt bookkeeping must make the reference's
decisions on the same operations; under a pool too small for everyone the
port's engine must preempt exactly where the reference's does, and every
stream — the preempted requests' too, which fold their generated tokens
into the prompt and recompute them through chunked prefill — must equal
the reference engine's and the port's own run on a roomy pool. Cancel
releases every block and pin wherever the request is.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402

ARCH = "llama3.2-3b"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_lm():
    jcfg, tcfg = jget_config(ARCH, smoke=True), tget_config(ARCH, smoke=True)
    jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, tcfg, from_reference(jp, tcfg, device="cpu")


def _engines(small_lm, **kw):
    jcfg, jp, tcfg, tp = small_lm
    je = jeng.ServeEngine(jcfg, jp, jeng.EngineConfig(
        paged_impl="gather", telemetry=False, **kw))
    te = teng.ServeEngine(tcfg, tp, teng.EngineConfig(**kw), device="cpu")
    return je, te


def total_pins(radix) -> int:
    stack, total = [radix.root], 0
    while stack:
        n = stack.pop()
        total += n.pins
        stack.extend(n.children.values())
    return total


def _streams(reqs):
    return {r.rid: list(r.out_tokens) for r in reqs}


# ---------------------------------------------------------------------------
# Scheduler: the same picks, skips and preemptions as the reference's
# ---------------------------------------------------------------------------

def _sched_lookahead(mod):
    s = mod.Scheduler(policy="prefill", lookahead=8)
    for i, need in enumerate((100, 1, 1)):
        s.submit(_rs(mod, i, need), tick=0, now=0.0)
    got = [r.rid for r in s.pick(2, 1, lambda rs: rs.need <= 2)]
    return [got, [r.rid for r in s.waiting], s.hol_skips]


def _sched_bounded(mod):
    s = mod.Scheduler(policy="prefill", lookahead=2)
    for i in range(3):
        s.submit(_rs(mod, i, 100), tick=0, now=0.0)
    s.submit(_rs(mod, 3, 1), tick=0, now=0.0)
    got = s.pick(4, 1, lambda rs: rs.need <= 2)
    return [got, [r.rid for r in s.waiting], s.hol_skips]


def _sched_age_cap(mod):
    s = mod.Scheduler(policy="prefill", lookahead=8, head_age_cap=10)
    s.submit(_rs(mod, 0, 100), tick=0, now=0.0)
    s.submit(_rs(mod, 1, 1), tick=0, now=0.0)
    can = lambda rs: rs.need <= 2                      # noqa: E731
    out = [[r.rid for r in s.pick(2, 9, can)]]
    s.submit(_rs(mod, 2, 1), tick=9, now=0.0)
    out += [[r.rid for r in s.pick(2, 10, can)], [r.rid for r in s.waiting],
            [r.rid for r in s.pick(2, 11, lambda rs: True)]]
    return out


def _sched_preempt(mod):
    s = mod.Scheduler(policy="prefill")
    a, b = _rs(mod, 0, 1), _rs(mod, 1, 1)
    s.submit(a, tick=0, now=0.0)
    s.submit(b, tick=0, now=0.0)
    out = [len(s.pick(2, 0, lambda rs: True))]
    s.preempt(a, tick=7)
    out += [s.waiting[0].rid, a.preempt_count, a.admit_tick, a.wait_age(9),
            s.preempted, s.admitted]
    s.requeue_front(b)
    m = s.metrics()
    return out + [[r.rid for r in s.waiting], s.admitted,
                  {k: m[k] for k in ("preempted", "hol_skips", "admitted",
                                     "mean_queue_ticks")}]


def _sched_fcfs_max_prefills(mod):
    out = []
    for mp in (None, 2):
        s = mod.Scheduler(policy="fcfs", max_prefills_per_tick=mp)
        for i in range(4):
            s.submit(_rs(mod, i, 1), tick=0, now=0.0)
        out.append([r.rid for r in s.pick(3, 0, lambda rs: True)])
    return out


def _rs(mod, rid, need):
    rs = mod.RequestState(rid=rid, prompt=np.zeros(4, np.int32),
                          max_new_tokens=4)
    rs.need = need
    return rs


@pytest.mark.parametrize("scenario", [
    _sched_lookahead, _sched_bounded, _sched_age_cap, _sched_preempt,
    _sched_fcfs_max_prefills], ids=lambda f: f.__name__.lstrip("_"))
def test_scheduler_decisions_match_reference(scenario):
    assert scenario(tsched) == scenario(jsched)


def test_scheduler_rejects_bad_arguments_like_reference():
    for kw in (dict(lookahead=-1), dict(head_age_cap=0), dict(policy="x")):
        msgs = []
        for mod in (tsched, jsched):
            with pytest.raises(ValueError) as e:
                mod.Scheduler(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# Preemption: the reference's decisions and streams
# ---------------------------------------------------------------------------

def _hol_prompts():
    rng = np.random.default_rng(1)
    return {0: rng.integers(2, 512, size=4), 1: rng.integers(2, 512, size=33),
            2: rng.integers(2, 512, size=4), 3: rng.integers(2, 512, size=4)}


def _hol_requests(mod, prompts):
    """A big arrival (rid 1, 3 blocks at page 16) behind a short-lived
    small, then two long-lived smalls that backfill through lookahead and
    fill the pool: rid 1 admits only by preempting them."""
    mk = lambda rid, new: mod.Request(                 # noqa: E731
        rid=rid, prompt=prompts[rid].copy(), max_new_tokens=new)
    return [mk(0, 4), mk(1, 10), mk(2, 12), mk(3, 12)]


def _overload_requests(mod):
    """chip_smoke.py's overload trace at an eighth of its scale (page 8,
    chunk 16, 8 new tokens, 64 usable blocks): two long prompts and two
    short ones, then the longest as the head, blocked, then shorter later
    arrivals that the lookahead admits past it — until a short one retires
    and the head preempts them."""
    rng = np.random.default_rng(5)
    lens = [124, 121, 64, 67, 128, 72, 74, 76, 80, 84, 90, 100]
    return [mod.Request(rid=i, prompt=rng.integers(2, 512, size=n),
                        max_new_tokens=8) for i, n in enumerate(lens)]


def _sampled(reqs_fn):
    """reqs_fn's requests with sampling (greedy, top-k + top-p, top-k,
    top-p, taken in turn)."""
    mix = [(0.0, 0, 1.0), (0.8, 40, 0.9), (1.0, 50, 1.0), (0.7, 0, 0.95)]

    def fn(mod):
        reqs = reqs_fn(mod)
        for i, r in enumerate(reqs):
            r.sampling = mod.SamplingParams(*mix[i % len(mix)])
        return reqs
    return fn


PREEMPT_CASES = {
    "hol": (lambda mod: _hol_requests(mod, _hol_prompts()),
            dict(slots=3, max_seq=64, page_size=16, num_blocks=4,
                 preempt_after_ticks=2)),
    "hol_prefix_cache": (lambda mod: _hol_requests(mod, _hol_prompts()),
                         dict(slots=3, max_seq=64, page_size=16, num_blocks=4,
                              preempt_after_ticks=2, prefix_cache=True)),
    "overload": (_overload_requests,
                 dict(slots=8, max_seq=160, page_size=8, prefill_chunk=16,
                      num_blocks=65, prefix_cache=True)),
    "overload_kv4": (_overload_requests,
                     dict(slots=8, max_seq=160, page_size=8, prefill_chunk=16,
                          num_blocks=65, kv_bits=4)),
    # sampled streams resume on the keys they would have drawn: the
    # preempted requests' sample_step is re-armed at len(out_tokens)
    "hol_sampled": (_sampled(lambda mod: _hol_requests(mod, _hol_prompts())),
                    dict(slots=3, max_seq=64, page_size=16, num_blocks=4,
                         preempt_after_ticks=2, seed=6)),
    "overload_sampled": (_sampled(_overload_requests),
                         dict(slots=8, max_seq=160, page_size=8,
                              prefill_chunk=16, num_blocks=65,
                              prefix_cache=True, seed=6)),
}


@pytest.mark.parametrize("case", list(PREEMPT_CASES))
def test_preemption_matches_reference_and_is_stream_invisible(small_lm,
                                                              case):
    """Under a pool too tight for everyone the port preempts where the
    reference does (the same preemption and skip counts, admissions and
    finishes), every stream equals the reference engine's and the port's
    own unpreempted run on a roomy pool, and every block and pin comes
    back."""
    reqs_fn, kw = PREEMPT_CASES[case]
    je, te = _engines(small_lm, **kw)
    jr, tr = reqs_fn(jeng), reqs_fn(teng)
    je.run(jr, max_ticks=400)
    assert len(te.run(tr, max_ticks=400)) == len(tr)
    assert _streams(tr) == _streams(jr)
    jm, tm = je.metrics(), te.metrics()
    keys = ("preempted", "hol_skips", "admitted", "prefill_tokens",
            "cached_prefix_tokens", "decode_tokens", "evictions")
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    assert tm["preempted"] > 0

    def recs(eng):
        return sorted((rs.rid, rs.admit_tick, rs.finish_tick,
                       rs.finish_reason, rs.preempt_count, rs.folded_tokens)
                      for rs in eng.scheduler.finished)
    assert recs(te) == recs(je)
    roomy = dict(kw, num_blocks=None)
    _, _, tcfg, tp = small_lm
    ref = teng.ServeEngine(tcfg, tp, teng.EngineConfig(**roomy),
                           device="cpu")
    rr = reqs_fn(teng)
    ref.run(rr)
    assert ref.metrics()["preempted"] == 0
    assert _streams(tr) == _streams(rr)
    if te.radix is not None:
        assert total_pins(te.radix) == 0
        te.radix.evict(te.allocator.num_blocks)
    assert te.allocator.free_blocks == te.allocator.num_blocks - 1


def test_preemption_off_and_on_identical_when_pool_suffices(small_lm):
    """preemption=False with a pool that fits: the same streams as with
    preemption on, which never fires."""
    _, _, tcfg, tp = small_lm
    out = {}
    for flag in (True, False):
        eng = teng.ServeEngine(tcfg, tp, teng.EngineConfig(
            slots=3, max_seq=64, page_size=16, preemption=flag,
            preempt_after_ticks=2), device="cpu")
        reqs = _hol_requests(teng, _hol_prompts())
        eng.run(reqs, max_ticks=400)
        assert eng.metrics()["preempted"] == 0
        out[flag] = _streams(reqs)
    assert out[True] == out[False]


def test_preemption_off_stalls_where_reference_stalls(small_lm):
    """preemption=False on the tight pool: the head waits for natural
    retirements, with the reference's admissions and streams."""
    kw = dict(slots=3, max_seq=64, page_size=16, num_blocks=4,
              preemption=False)
    je, te = _engines(small_lm, **kw)
    jr, tr = (_hol_requests(jeng, _hol_prompts()),
              _hol_requests(teng, _hol_prompts()))
    je.run(jr, max_ticks=400)
    te.run(tr, max_ticks=400)
    assert _streams(tr) == _streams(jr)
    assert te.metrics()["preempted"] == 0
    assert (sorted((rs.rid, rs.admit_tick) for rs in te.scheduler.finished)
            == sorted((rs.rid, rs.admit_tick)
                      for rs in je.scheduler.finished))


def test_preemption_never_targets_earlier_arrivals(small_lm):
    """Two requests that cannot share the pool serialize (a later head never
    evicts an earlier arrival), with the reference's streams."""
    kw = dict(slots=2, max_seq=64, page_size=16, num_blocks=4,
              preempt_after_ticks=2)
    je, te = _engines(small_lm, **kw)
    out = []
    for mod, eng in ((jeng, je), (teng, te)):
        rng = np.random.default_rng(3)
        reqs = [mod.Request(rid=i, prompt=rng.integers(2, 512, size=33),
                            max_new_tokens=6) for i in range(2)]
        assert len(eng.run(reqs, max_ticks=400)) == 2
        assert all(len(r.out_tokens) == 6 for r in reqs)
        assert eng.metrics()["preempted"] == 0
        out.append(_streams(reqs))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# Cancellation: queued, mid-chunked-prefill, mid-decode
# ---------------------------------------------------------------------------

def _cancel_queued(mod, eng):
    rng = np.random.default_rng(0)
    reqs = [mod.Request(rid=i, prompt=rng.integers(2, 512, size=5),
                        max_new_tokens=8) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.step()                          # rid 0 admitted, rid 1 queued
    assert eng.cancel(1) is True
    done = eng.run([], max_ticks=100)
    assert {r.rid for r in done} == {0, 1}
    return reqs


def _cancel_mid_prefill(mod, eng):
    rng = np.random.default_rng(0)
    req = mod.Request(rid=0, prompt=rng.integers(2, 512, size=60),
                      max_new_tokens=4)
    eng.submit(req)
    eng.step()                          # admits + runs exactly one chunk
    assert eng._prefilling
    assert eng.cancel(0) is True
    assert not eng._prefilling
    # blocks the chunk published stay cached but unpinned: every block
    # that is not free is evictable
    assert (eng.allocator.free_blocks + eng.radix.evictable_blocks()
            == eng.allocator.num_blocks - 1)
    assert total_pins(eng.radix) == 0
    assert eng.poll()[0].rid == 0
    req2 = mod.Request(rid=1, prompt=rng.integers(2, 512, size=7),
                       max_new_tokens=3)
    eng.run([req2])
    assert len(req2.out_tokens) == 3
    return [req, req2]


def _cancel_mid_decode(mod, eng):
    rng = np.random.default_rng(0)
    prompt = rng.integers(2, 512, size=6)
    req = mod.Request(rid=0, prompt=prompt.copy(), max_new_tokens=32)
    eng.submit(req)
    while not req.out_tokens:
        eng.step()
        eng.poll()
    assert eng.cancel(0) is True
    assert req.out_tokens, "cancel keeps the delivered tokens"
    # the ghost-active slot re-arms for the next request
    req2 = mod.Request(rid=1, prompt=prompt.copy(), max_new_tokens=4)
    eng.run([req2])
    n = min(len(req.out_tokens), len(req2.out_tokens))
    assert req2.out_tokens[:n] == req.out_tokens[:n]
    return [req, req2]


def _cancel_unknown_and_finished(mod, eng):
    assert eng.cancel(99) is False
    req = mod.Request(rid=0, prompt=np.array([5, 6, 7], np.int32),
                      max_new_tokens=2)
    eng.run([req])
    assert eng.cancel(0) is False       # finished: keeps its tokens
    assert len(req.out_tokens) == 2
    return [req]


CANCEL_CASES = {
    "queued": (_cancel_queued, dict(slots=1, max_seq=64, page_size=8)),
    "mid_prefill": (_cancel_mid_prefill, dict(
        slots=2, max_seq=128, page_size=16, prefix_cache=True,
        prefill_chunk=16, prefill_token_budget=16)),
    "mid_decode": (_cancel_mid_decode, dict(slots=1, max_seq=64,
                                            page_size=8)),
    "unknown_and_finished": (_cancel_unknown_and_finished,
                             dict(slots=1, max_seq=64)),
}


@pytest.mark.parametrize("case", list(CANCEL_CASES))
def test_cancel_matches_reference(small_lm, case):
    """Cancel on both engines: the same return values, finish reasons and
    streams, and the pool wholly returned."""
    fn, kw = CANCEL_CASES[case]
    je, te = _engines(small_lm, **kw)
    jr, tr = fn(jeng, je), fn(teng, te)
    assert _streams(tr) == _streams(jr)
    reasons = [sorted((rs.rid, rs.finish_reason, len(rs.out_tokens))
                      for rs in e.scheduler.finished) for e in (te, je)]
    assert reasons[0] == reasons[1]
    assert te.allocator.free_blocks + (
        te.radix.evictable_blocks() if te.radix else 0) \
        == te.allocator.num_blocks - 1
    if case in ("queued", "mid_decode"):
        assert any(r == "cancelled" for _, r, _ in reasons[0])


def test_cancelled_slot_decodes_like_a_fresh_engine(small_lm):
    """After a mid-decode cancel, the re-armed slot serves the same prompt
    exactly as a fresh engine does."""
    _, _, tcfg, tp = small_lm
    kw = dict(slots=1, max_seq=64, page_size=8)
    eng = teng.ServeEngine(tcfg, tp, teng.EngineConfig(**kw), device="cpu")
    req, req2 = _cancel_mid_decode(teng, eng)
    fresh = teng.ServeEngine(tcfg, tp, teng.EngineConfig(**kw), device="cpu")
    ref = teng.Request(rid=1, prompt=req2.prompt.copy(), max_new_tokens=4)
    fresh.run([ref])
    assert req2.out_tokens == ref.out_tokens
