"""PyTorch port vs the JAX reference: durable serving — the write-ahead
request journal (serve/journal.py), engine snapshot / restore, crash
recovery with bit-exact resume, and live handoff.

The journal is the one artifact the two packages exchange: its records are
the reference's byte for byte once `wall_time_s` is masked, and each
package's engine recovers a journal the other wrote, killed by
`process_crash` at every tick index, greedy and sampled. Every case that
leaves decisions — streams, finish reasons, replayed ledgers, health paths,
snapshot payloads — runs on the reference engine (gather path; weights
carried across by from_reference) and on the port, and the two must agree
exactly; streams must also equal an uninterrupted reference run. Snapshot
shards differ by design (the reference writes msgpack, the port torch.save),
so snapshots are compared as decoded payloads.
"""
import dataclasses
import json
import re
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
from repro.serve import journal as jjl  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.nn.common import build_lm_grau  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import faults as tfl  # noqa: E402
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
    """One package's durable-serving surface over the shared smoke model:
    the reference engine on its gather path, the port's on the CPU."""

    def __init__(self, which, small_lm):
        jcfg, jp, tcfg, tp = small_lm
        self.which = which
        if which == "ref":
            self.eng, self.jl, self.fl = jeng, jjl, jfl
            self.cfg, self.params, self.dev = jcfg, jp, {}
        else:
            self.eng, self.jl, self.fl = teng, tjl, tfl
            self.cfg, self.params, self.dev = tcfg, tp, {"device": "cpu"}

    def ecfg(self, **kw):
        kw.setdefault("slots", 2)
        kw.setdefault("max_seq", 64)
        kw.setdefault("seed", 11)
        if self.which == "ref":
            kw.setdefault("paged_impl", "gather")
        return self.eng.EngineConfig(**kw)

    def engine(self, **kw):
        return self.eng.ServeEngine(self.cfg, self.params, self.ecfg(**kw),
                                    **self.dev)

    def journaled(self, path, **kw):
        """An engine that owns a fresh writer on `path`."""
        eng = self.engine(journal=self.jl.RequestJournal(path), **kw)
        eng._owns_journal = True
        return eng

    def recover(self, path, **kw):
        if "snapshot_dir" not in kw:
            kw.setdefault("ecfg", self.ecfg())
        return self.eng.ServeEngine.recover(self.cfg, self.params, path,
                                            **kw, **self.dev)

    def restore(self, snapdir, **kw):
        return self.eng.ServeEngine.restore(self.cfg, self.params, snapdir,
                                            **kw, **self.dev)

    def requests(self, n=4, max_new=4, seed=7, **kw):
        """The reference tests' mix: even rids greedy, odd rids sampled."""
        rng = np.random.default_rng(seed)
        return [self.eng.Request(
            rid=i, prompt=rng.integers(2, self.cfg.vocab_size,
                                       size=int(rng.integers(3, 9))),
            max_new_tokens=max_new,
            sampling=self.eng.SamplingParams(
                temperature=0.8 if i % 2 else 0.0, top_k=8 if i % 2 else 0),
            **kw)
            for i in range(n)]


def both(small_lm, scenario):
    """scenario(Pkg) on the reference and on the port; the results must be
    equal. Returns the port's."""
    res = {w: scenario(Pkg(w, small_lm)) for w in ("ref", "port")}
    assert res["port"] == res["ref"]
    return res["port"]


@pytest.fixture(scope="module")
def ref_run(small_lm):
    """The uninterrupted reference run: the ground-truth streams and its
    tick count."""
    P = Pkg("ref", small_lm)
    eng = P.engine()
    done = eng.run(P.requests())
    out = {r.rid: list(r.out_tokens) for r in done}, eng.stats["ticks"]
    eng.close()
    return out


def drive_until_crash(P, eng, reqs):
    """Submit and tick until completion or an injected process crash.
    Returns the crash tick, or None if the engine finished."""
    for r in reqs:
        eng.submit(r)
    guard = 0
    try:
        while (eng.scheduler.waiting
               or any(s is not None for s in eng.slot_req)):
            eng.step()
            eng.poll()
            guard += 1
            assert guard < 500, "serve loop did not terminate"
    except P.fl.ProcessCrash as e:
        return e.tick
    eng.poll()
    return None


def finish_reasons(eng):
    return {rs.rid: rs.finish_reason for rs in eng.scheduler.finished}


def streams(done):
    return {r.rid: list(r.out_tokens) for r in done}


def state_dict(state):
    """A JournalState as plain data (comparable across the packages)."""
    return dataclasses.asdict(state)


def journal_ledger(path, jl):
    """What a journal proves, order of delivery aside: each rid's delivered
    tokens, the retirements and the epochs. (A readmitted request replays
    its delivered tokens through decode ticks where the reference folds
    them into a prefill, so after a handoff or a recovery the two packages
    deliver the same tokens on other ticks.)"""
    toks = {}
    for line in path.read_bytes().splitlines():
        rec = json.loads(line)
        if rec["kind"] == "submit":
            toks.setdefault(rec["rid"], [])
        elif rec["kind"] == "token":
            toks[rec["rid"]].append(rec["tok"])
    st = jl.replay(path)
    return toks, st.retired, st.epochs, sorted(st.live)


def masked_lines(path):
    """The journal's raw lines with every wall_time_s value masked."""
    return [re.sub(rb'"wall_time_s": [-+0-9.eE]+', b'"wall_time_s": 0', ln)
            for ln in path.read_bytes().splitlines()]


# ---------------------------------------------------------------------------
# Journal: the reference's cases, host-side, on both writers
# ---------------------------------------------------------------------------

def _roundtrip(jl, p):
    with jl.RequestJournal(p) as j:
        assert j.begin_epoch({"reason": "attach"}) == 0
        j.record_submit(0, [5, 6, 7], 4,
                        sampling={"temperature": 0.5, "top_k": 4,
                                  "top_p": 1.0}, deadline_ms=250.0)
        j.record_submit(1, [9], 2)
        j.record_token(0, 42)
        j.record_token(1, 43)
        j.record_token(0, 44)
        j.record_retire(1, "eos")
    st = jl.replay(p)
    assert (st.epochs, st.last_seq, st.truncated_tail) == (1, 0, False)
    assert set(st.live) == {0} and st.retired == {1: "eos"}
    lr = st.live[0]
    assert lr.prompt == [5, 6, 7] and lr.delivered == [42, 44]
    assert lr.max_new_tokens == 4 and lr.deadline_ms == 250.0
    assert lr.sampling["temperature"] == 0.5
    return masked_lines(p)


def _idempotent_and_missing(jl, p):
    empty = jl.replay(p)
    assert empty.live == {} and empty.records == 0
    with jl.RequestJournal(p) as j:
        j.begin_epoch()
        j.record_submit(3, [1, 2], 5)
        j.record_token(3, 8)
    a, b = jl.replay(p), jl.replay(p)
    assert a == b and a.live[3].delivered == [8]
    return state_dict(a)["live"][3]["delivered"]


def _torn_tail(jl, p):
    with jl.RequestJournal(p) as j:
        j.begin_epoch()
        j.record_submit(0, [1], 4)
        j.record_token(0, 7)
    with open(p, "ab") as f:
        f.write(b'{"kind": "token", "rid": 0, "to')
    st = jl.replay(p)
    assert st.truncated_tail and st.live[0].delivered == [7]
    # the valid prefix ends where the torn record starts
    assert p.read_bytes()[st.valid_bytes:].startswith(b'{"kind": "token"')
    return st.records, masked_lines(p)


def _reopen_after_torn_tail(jl, p):
    with jl.RequestJournal(p) as j:
        j.begin_epoch()
        j.record_submit(0, [1], 4)
        j.record_token(0, 7)
    with open(p, "ab") as f:
        f.write(b'{"kind": "token", "rid": 0, "to')
    j2 = jl.RequestJournal(p)
    j2.begin_epoch({"reason": "recover"})
    j2.record_token(0, 8)
    j2.close()
    st = jl.replay(p)
    assert not st.truncated_tail and st.epochs == 2
    assert st.live[0].delivered == [7, 8]
    with open(p, "ab") as f:
        f.write(b'{"kind": "ret')
    j3 = jl.RequestJournal(p)
    assert j3.begin_epoch({"reason": "recover"}) == 2
    j3.record_retire(0, "max_tokens")
    j3.close()
    final = jl.replay(p)
    assert final == jl.replay(p)
    assert final.retired == {0: "max_tokens"} and not final.live
    return masked_lines(p)


def _repairs_missing_final_newline(jl, p):
    with jl.RequestJournal(p) as j:
        j.begin_epoch()
        j.record_submit(0, [1], 4)
    raw = p.read_bytes()
    assert raw.endswith(b"\n")
    p.write_bytes(raw[:-1])
    j2 = jl.RequestJournal(p)
    j2.record_token(0, 5)
    j2.close()
    st = jl.replay(p)
    assert not st.truncated_tail and st.live[0].delivered == [5]
    return masked_lines(p)


def _mid_file_corruption_raises(jl, p):
    with jl.RequestJournal(p) as j:
        j.begin_epoch()
        j.record_submit(0, [1], 4)
    raw = p.read_bytes().split(b"\n")
    raw[0] = b'{"kind": "epo'
    p.write_bytes(b"\n".join(raw))
    with pytest.raises(jl.JournalCorrupt, match="malformed journal line 0"):
        jl.replay(p)
    return True


def _impossible_sequences_raise(jl, p):
    msgs = []
    for i, write in enumerate([lambda j: j.record_token(9, 1),
                               lambda j: j.record_retire(9, "eos")]):
        q = p.with_name(f"{p.name}_{i}")
        with jl.RequestJournal(q) as j:
            j.begin_epoch()
            write(j)
        with pytest.raises(jl.JournalCorrupt) as e:
            jl.replay(q)
        msgs.append(str(e.value))
    return msgs


def _submit_for_live_rid(jl, p):
    with jl.RequestJournal(p) as j:
        j.begin_epoch()
        j.record_submit(0, [1], 4)
        j.record_submit(0, [2], 4)
    with pytest.raises(jl.JournalCorrupt, match="live rid 0"):
        jl.replay(p)
    return True


def _rid_reuse_after_retire(jl, p):
    with jl.RequestJournal(p) as j:
        j.begin_epoch()
        j.record_submit(0, [1], 4)
        j.record_token(0, 5)
        j.record_retire(0, "max_tokens")
        j.record_submit(0, [2, 3], 6)
        j.record_token(0, 9)
    st = jl.replay(p)
    assert st.live[0].prompt == [2, 3] and st.live[0].delivered == [9]
    assert 0 not in st.retired
    # valid_bytes is left out: it counts the digits of each wall time
    return ({k: v for k, v in state_dict(st).items()
             if k not in ("live", "valid_bytes")},
            state_dict(st)["live"][0]["delivered"])


def _epoch_seq_monotone(jl, p):
    for i in range(3):
        j = jl.RequestJournal(p)
        assert j.begin_epoch({"attach": i}) == i
        j.close()
    st = jl.replay(p)
    assert st.epochs == 3 and st.last_seq == 2
    with open(p, "ab") as f:
        f.write(b'{"kind": "epoch", "seq": 0, "wall_time_s": 0, '
                b'"meta": {}}\n')
    with pytest.raises(jl.JournalCorrupt, match="not increasing"):
        jl.replay(p)
    return masked_lines(p)


def _fsync_batching_and_close(jl, p):
    j = jl.RequestJournal(p, fsync_every=4)
    j.begin_epoch()
    for i in range(6):
        j.record_submit(i, [1], 1)
    syncs = [j.syncs]
    j.sync()
    syncs.append(j.syncs)
    j.sync()
    syncs.append(j.syncs)
    assert syncs == [1, 2, 2] and j.records == 7
    j.close()
    j.close()
    with pytest.raises(ValueError, match="closed"):
        j.record_retire(0, "eos")
    with pytest.raises(ValueError, match="fsync_every"):
        jl.RequestJournal(p, fsync_every=0)
    return syncs


JOURNAL_CASES = [_roundtrip, _idempotent_and_missing, _torn_tail,
                 _reopen_after_torn_tail, _repairs_missing_final_newline,
                 _mid_file_corruption_raises, _impossible_sequences_raise,
                 _submit_for_live_rid, _rid_reuse_after_retire,
                 _epoch_seq_monotone, _fsync_batching_and_close]


@pytest.mark.parametrize("case", JOURNAL_CASES,
                         ids=lambda c: c.__name__.strip("_"))
def test_journal_case_matches_reference(case, tmp_path):
    """The reference's journal cases (tests/test_recovery.py), each run on
    the port's writer and the reference's: the port's holds every
    assertion, and what the case leaves (file bytes with wall_time_s
    masked, replayed state, errors) is the reference's."""
    got = case(tjl, tmp_path / "port.journal")
    want = case(jjl, tmp_path / "ref.journal")
    assert got == want


def test_journal_reads_the_other_packages_files(tmp_path):
    """Each package's replay of the other's file gives the same state."""
    for w, r in ((jjl, tjl), (tjl, jjl)):
        p = tmp_path / f"{w.__name__}.journal"
        with w.RequestJournal(p) as j:
            j.begin_epoch({"reason": "attach"})
            j.record_submit(4, [7, 8, 9], 3, deadline_ms=1e4,
                            sampling={"temperature": 0.8, "top_k": 8,
                                      "top_p": 1.0})
            j.record_token(4, 11)
            j.record_submit(5, [3], 2)
            j.record_retire(5, "cancelled")
        assert state_dict(r.replay(p)) == state_dict(w.replay(p))


# ---------------------------------------------------------------------------
# The engine's records: one uninterrupted journaled run in each package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", ["mix", "deadline_prefix_cache"])
def test_uninterrupted_journal_records_match_reference(small_lm, tmp_path,
                                                       workload):
    """Epoch, submits (prompt, budget, sampling, deadline), one token record
    per delivered token in drain order and the retirements: the port's file
    is the reference's byte for byte once wall_time_s is masked."""
    lines = {}
    for w in ("ref", "port"):
        P = Pkg(w, small_lm)
        p = tmp_path / f"{w}.journal"
        kw = ({"prefix_cache": True, "page_size": 8}
              if workload != "mix" else {})
        eng = P.journaled(p, **kw)
        reqs = P.requests(n=5, max_new=6)
        if workload != "mix":
            for r in reqs:
                r.deadline_ms = 1e7
            reqs[3].prompt = reqs[1].prompt.copy()   # a shared prefix
        eng.run(reqs)
        eng.close()
        lines[w] = masked_lines(p)
        st = P.jl.replay(p)
        assert not st.live and len(st.retired) == 5
    assert lines["port"] == lines["ref"]
    assert sum(b'"kind": "token"' in ln for ln in lines["port"]) == 5 * 6


# ---------------------------------------------------------------------------
# Crash recovery: the chaos sweep, within and across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"),
                                           ("port", "port")],
                         ids=["ref_writes_port_recovers",
                              "port_writes_ref_recovers",
                              "port_writes_port_recovers"])
def test_chaos_crash_at_every_tick(small_lm, ref_run, tmp_path, writer,
                                   reader):
    """Kill the writer's engine at every tick index (process_crash, no
    close()), recover the journal in a fresh engine of the reader's package
    and finish: the concatenated streams equal the uninterrupted reference
    run, greedy and sampled; each pre-kill delivered prefix is kept; the
    repaired journal replays idempotently with one epoch more and nothing
    live; the recovered engine returns every block. Within the port the
    config comes from an explicit ecfg and, at odd ticks, from a snapshot
    written at step 0 (snapshots do not cross packages)."""
    W, R = Pkg(writer, small_lm), Pkg(reader, small_lm)
    ref, ref_ticks = ref_run
    assert ref_ticks >= 4
    kills = 0
    for k in range(ref_ticks + 1):
        jpath = tmp_path / f"crash_{k}.journal"
        snapdir = tmp_path / f"snap_{k}"
        plan = W.fl.FaultPlan()
        plan.arm("process_crash", tick=k)
        eng = W.journaled(jpath, faults=plan)
        from_snapshot = writer == reader and k % 2 == 1
        if from_snapshot:
            eng.snapshot(snapdir, step=0)
        reqs = W.requests()
        crash_tick = drive_until_crash(W, eng, reqs)
        delivered_pre = streams(reqs)
        if crash_tick is None:
            assert delivered_pre == ref
            eng.close()
            continue
        kills += 1
        del eng                               # simulated death: no close()

        state = R.jl.replay(jpath)
        eng2 = (R.recover(jpath, snapshot_dir=snapdir) if from_snapshot
                else R.recover(jpath))
        assert eng2.ecfg.seed == 11
        done = eng2.run([])
        resumed = streams(done)
        assert eng2.allocator.free_blocks == eng2.allocator.num_blocks - 1
        eng2.close()

        final = R.jl.replay(jpath)
        assert final == R.jl.replay(jpath)
        assert final.epochs == state.epochs + 1
        assert not final.live
        assert state_dict(W.jl.replay(jpath)) == state_dict(final)
        for rid, want in ref.items():
            if rid in resumed:
                got = resumed[rid]
                pre = state.live[rid].delivered
                assert got[:len(pre)] == pre
            else:
                got = delivered_pre[rid]
            assert got == want, (
                f"kill at tick {k}: rid {rid} diverged\n  got  {got}\n"
                f"  want {want}")
    assert kills == ref_ticks


def test_recovery_synthesizes_torn_retire(small_lm, tmp_path):
    """A budget spent or an EOS delivered whose retire record was torn off:
    recovery retires it at once and repairs the ledger."""
    def scenario(P):
        jpath = tmp_path / f"torn_{P.which}.journal"
        eos = int(P.ecfg().eos_id)
        with P.jl.RequestJournal(jpath) as j:
            j.begin_epoch()
            j.record_submit(0, [5, 6, 7], 2)
            j.record_token(0, 30)
            j.record_token(0, 31)
            j.record_submit(1, [5, 6], 4)
            j.record_token(1, eos)
        eng = P.recover(jpath)
        assert all(s is None for s in eng.slot_req)
        assert not eng.scheduler.waiting
        polled = sorted(r.rid for r in eng.poll())
        reasons = finish_reasons(eng)
        eng.close()
        st = P.jl.replay(jpath)
        assert not st.live
        return polled, reasons, st.retired, masked_lines(jpath)
    polled, reasons, retired, _ = both(small_lm, scenario)
    assert polled == [0, 1]
    assert reasons == retired == {0: "max_tokens", 1: "eos"}


def test_recover_charges_deadline_for_downtime(small_lm, tmp_path):
    """The journaled submit's wall time dates the deadline: a request past
    its budget after ~10 s down retires with "deadline"; one with room
    resumes with the residual, never a fresh budget."""
    def scenario(P):
        jpath = tmp_path / f"deadline_{P.which}.journal"
        with P.jl.RequestJournal(jpath) as j:
            j.begin_epoch()
            j.record_submit(0, [5, 6, 7], 4, deadline_ms=250.0)
            j.record_submit(1, [5, 6], 4, deadline_ms=1e7)
        recs = [json.loads(ln) for ln in jpath.read_text().splitlines()]
        for rec in recs:
            if rec["kind"] == "submit":
                rec["wall_time_s"] -= 10.0
        jpath.write_text("".join(json.dumps(r) + "\n" for r in recs))
        eng = P.recover(jpath)
        polled = [r.rid for r in eng.poll()]
        reasons = dict(finish_reasons(eng))
        (rs,) = eng.scheduler.waiting
        assert rs.rid == 1 and 0 < rs.deadline_ms < 1e7 - 9000
        done = eng.run([])
        eng.close()
        st = P.jl.replay(jpath)
        return polled, reasons, streams(done), st.retired
    polled, reasons, got, retired = both(small_lm, scenario)
    assert polled == [0] and reasons == {0: "deadline"}
    assert retired == {0: "deadline", 1: "max_tokens"} and len(got[1]) == 4


# ---------------------------------------------------------------------------
# Snapshot / restore
# ---------------------------------------------------------------------------

def test_snapshot_restore_bit_identical(small_lm, ref_run, tmp_path):
    """Snapshot mid-flight and close; the restored engine finishes every
    stream as the uninterrupted run, greedy and sampled (the pool is never
    written: restore recomputes it by replay)."""
    ref, _ = ref_run

    def scenario(P):
        snap = tmp_path / f"snap_{P.which}"
        eng = P.engine()
        for r in P.requests():
            eng.submit(r)
        for _ in range(4):
            eng.step()
        first = streams(eng.poll())
        path = eng.snapshot(snap)
        manifest = json.loads((path / "MANIFEST.json").read_text())
        assert manifest["extra"]["kind"] == "serve_snapshot"
        assert eng._tel.snapshots.value == 1
        eng.close()
        eng2 = P.restore(snap)
        assert eng2.ecfg.seed == 11
        restored = eng2._tel.restored_requests.value
        got = {**first, **streams(eng2.run([]))}
        assert eng2.allocator.free_blocks == eng2.allocator.num_blocks - 1
        eng2.close()
        return got, restored, manifest["extra"]
    got, restored, _ = both(small_lm, scenario)
    assert got == ref and restored > 0


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["cache_off", "cache_on"])
def test_snapshot_payload_matches_reference(small_lm, tmp_path,
                                            prefix_cache):
    """The decoded payload at the same tick: `format`, `tick`,
    `non_serializable`, the `requests` (deadline_elapsed_ms, a clock
    reading, masked) and the radix pin summary are the reference's; the
    records undo the fold; the port's engine_config is its own dict."""
    def scenario(P):
        plan = P.fl.FaultPlan()
        eng = P.engine(faults=plan, prefix_cache=prefix_cache, page_size=8)
        reqs = P.requests(n=4, max_new=6)
        reqs[2].prompt = np.concatenate([reqs[0].prompt, reqs[2].prompt])
        reqs[1].deadline_ms = 1e7
        for r in reqs:
            eng.submit(r)
        for _ in range(5):
            eng.step()
        eng.poll()
        eng.snapshot(tmp_path / f"snap_{P.which}", step=123)
        payload = P.eng.ServeEngine._load_snapshot(
            tmp_path / f"snap_{P.which}", 123)
        eng.close()
        for rec in payload["requests"]:
            assert rec["max_new_tokens"] == 6
            if rec["rid"] == 1:
                assert rec.pop("deadline_elapsed_ms") > 0
            else:
                assert rec.pop("deadline_elapsed_ms") is None
        assert payload["engine_config"]["seed"] == 11
        cfg = payload.pop("engine_config")
        restored = P.restore(tmp_path / f"snap_{P.which}", step=123,
                             overrides={"slots": 4})
        assert restored.ecfg.slots == 4 and restored.ecfg.faults is None
        done = streams(restored.run([]))
        restored.close()
        return payload, done, sorted(cfg)
    pay = {w: scenario(Pkg(w, small_lm)) for w in ("ref", "port")}
    assert pay["port"][0] == pay["ref"][0]
    assert pay["port"][1] == pay["ref"][1]
    payload = pay["port"][0]
    assert payload["format"] == 1 and payload["non_serializable"] == [
        "faults"]
    assert [r["rid"] for r in payload["requests"]] == sorted(
        r["rid"] for r in payload["requests"])
    assert (payload["radix"] is not None) == prefix_cache
    # the port's own dict, which carries the dense backend's fields too
    assert "paged_impl" in pay["port"][2]
    assert {"paged", "prefill_buckets"} <= set(pay["port"][2]) & set(
        pay["ref"][2])


def test_snapshot_roundtrips_the_ports_config(small_lm, tmp_path):
    """kv_bits / weight_bits shorthands round-trip; attn_grau is listed as
    non-serializable and comes back through `overrides`; the restored
    GRAU-epilogue int4 engine finishes as an uninterrupted one."""
    P = Pkg("port", small_lm)
    attn = build_lm_grau("identity")
    kw = dict(attn_grau=attn, kv_bits=4, weight_bits=4, page_size=8)
    base = P.engine(**kw)
    want = streams(base.run(P.requests(max_new=6)))
    base.close()
    eng = P.engine(**kw)
    for r in P.requests(max_new=6):
        eng.submit(r)
    for _ in range(5):
        eng.step()
    first = streams(eng.poll())
    eng.snapshot(tmp_path / "snap")
    eng.close()
    payload = teng.ServeEngine._load_snapshot(tmp_path / "snap", None)
    assert payload["non_serializable"] == ["attn_grau"]
    cfg = payload["engine_config"]
    assert (cfg["kv_bits"], cfg["weight_bits"], cfg["paged_impl"]) == (
        4, 4, None)
    bare = P.restore(tmp_path / "snap")
    assert bare.ecfg.attn_grau is None and bare._attn_quant is None
    for rs in list(bare.scheduler.waiting):
        bare.cancel(rs.rid)
    bare.poll()
    bare.close()
    eng2 = P.restore(tmp_path / "snap", overrides={"attn_grau": attn})
    assert eng2._attn_quant is not None and eng2._kv_quant and eng2._wq
    got = {**first, **streams(eng2.run([]))}
    eng2.close()
    assert got == want


def test_restore_onto_a_journal(small_lm, tmp_path):
    """restore(journal=...) writes a fresh journal's submits and delivered
    tokens, so its replay proves the whole streams."""
    P = Pkg("port", small_lm)
    eng = P.engine()
    reqs = P.requests()
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    first = streams(eng.poll())
    eng.snapshot(tmp_path / "snap")
    eng.close()
    j = tjl.RequestJournal(tmp_path / "r.journal")
    eng2 = P.restore(tmp_path / "snap", journal=j)
    done = streams(eng2.run([]))
    eng2.close()
    j.close()
    st = tjl.replay(tmp_path / "r.journal")
    assert not st.live and set(st.retired) == set(done)
    ref = {**first, **done}
    assert all(len(ref[rid]) == 4 for rid in ref)


# ---------------------------------------------------------------------------
# Live handoff
# ---------------------------------------------------------------------------

def test_handoff_same_config_bit_identical(small_lm, ref_run, tmp_path):
    ref, _ = ref_run

    def scenario(P):
        jpath = tmp_path / f"h_{P.which}.journal"
        src = P.journaled(jpath)
        for r in P.requests():
            src.submit(r)
        for _ in range(3):
            src.step()
        first = streams(src.poll())
        ledger = src.journal
        tgt = P.engine()
        summary = src.handoff(tgt)
        assert summary["transferred"] + len(src.scheduler.finished) == 4
        assert src.health == "draining"
        health = [e["state"] for e in src.trace.events(-1)
                  if e["event"] == "health"]
        assert tgt.journal is ledger and src.journal is None
        assert tgt._owns_journal and not src._owns_journal
        handoffs = [e for e in src.trace.events() if e["event"] == "handoff"]
        assert len(handoffs) == summary["transferred"]
        assert src.trace.open_rids() == set()
        restores = [e for e in tgt.trace.events() if e["event"] == "restore"]
        assert len(restores) == summary["transferred"]
        assert src._tel.handoffs.value == 1 and tgt._tel.handoffs.value == 0
        assert src.allocator.free_blocks == src.allocator.num_blocks - 1
        got = {**first, **streams(tgt.run([]))}
        st = P.jl.replay(jpath)
        assert st.epochs == 2 and not st.live
        src.close()
        tgt.close()
        return summary, health, got, journal_ledger(jpath, P.jl)
    summary, health, got, _ = both(small_lm, scenario)
    assert health == ["handoff", "draining"]
    assert got == ref


@pytest.mark.parametrize("target", [{"kv_bits": 8, "slots": 4},
                                    {"kv_bits": 4, "weight_bits": 4}],
                         ids=["kv8_slots4", "wq4_kv4"])
def test_handoff_to_different_config_none_failed(small_lm, target):
    """Reconfiguration by handoff: every in-flight request finishes on the
    target, none failed, with the reference's streams."""
    def scenario(P):
        src = P.engine()
        for r in P.requests():
            src.submit(r)
        for _ in range(3):
            src.step()
        src.poll()
        live = set(src._requests)
        assert live
        tgt = P.engine(**target)
        summary = src.handoff(tgt)
        assert summary["transferred"] == len(live)
        done = streams(tgt.run([]))
        assert set(done) == live
        reasons = finish_reasons(tgt)
        assert all(v in ("eos", "max_tokens") for v in reasons.values())
        src.close()
        tgt.close()
        return done, reasons
    both(small_lm, scenario)


def test_handoff_guards(small_lm):
    for w in ("ref", "port"):
        P = Pkg(w, small_lm)
        src = P.engine()
        with pytest.raises(ValueError, match="different engine"):
            src.handoff(src)
        other_seed = P.engine(seed=99)
        with pytest.raises(ValueError, match="seed"):
            src.handoff(other_seed)
        other_eos = P.engine(eos_id=7)
        with pytest.raises(ValueError, match="eos_id"):
            src.handoff(other_eos)
        draining = P.engine()
        draining.begin_draining()
        with pytest.raises(ValueError, match="draining"):
            src.handoff(draining)
        assert src.health == "healthy"
        for e in (src, other_seed, other_eos, draining):
            e.close()


def test_handoff_validation_failure_is_atomic(small_lm):
    """A refused handoff (max_seq too small, a live-rid collision) raises
    before the source releases anything: it stays healthy and finishes
    every stream itself, as the reference's does."""
    def scenario(P):
        src = P.engine()
        for r in P.requests(max_new=8):
            src.submit(r)
        for _ in range(2):
            src.step()
        src.poll()
        live = set(src._requests)
        small = P.engine(max_seq=8)
        with pytest.raises(ValueError, match="max_seq"):
            src.handoff(small)
        busy = P.engine()
        busy.submit(P.eng.Request(rid=min(live), prompt=np.array([5, 6]),
                                  max_new_tokens=2))
        with pytest.raises(ValueError, match="live rid"):
            src.handoff(busy)
        assert src.health == "healthy" and set(src._requests) == live
        assert not [e for e in src.trace.events(-1)
                    if e["event"] == "health"]
        done = streams(src.run([]))
        assert set(done) == live
        reasons = finish_reasons(src)
        busy.run([])
        for e in (src, small, busy):
            e.close()
        return done, reasons
    both(small_lm, scenario)


def test_handoff_carries_residual_deadline(small_lm):
    def scenario(P):
        src = P.engine()
        src.submit(P.eng.Request(rid=0, prompt=np.array([5, 6, 7]),
                                 max_new_tokens=6, deadline_ms=1e7))
        src.step()
        src.poll()
        (rec,) = src._live_records()
        assert rec["deadline_elapsed_ms"] > 0
        tgt = P.engine()
        src.handoff(tgt)
        (rs,) = [rs for rs in list(tgt.scheduler.waiting)
                 + [s for s in tgt.slot_req if s is not None]]
        assert 0 < rs.deadline_ms < 1e7
        done = streams(tgt.run([]))
        src.close()
        tgt.close()
        return done, {k: v for k, v in rec.items()
                      if k != "deadline_elapsed_ms"}
    both(small_lm, scenario)


def test_handoff_healthz_answers_503_during_handoff(small_lm, monkeypatch):
    """While the target re-admits, the source is HANDOFF: the gauge reads
    3 and /healthz answers 503; afterwards it is DRAINING (2)."""
    P = Pkg("port", small_lm)
    src = P.engine()
    port = src.serve_metrics(0).server_address[1]
    for r in P.requests():
        src.submit(r)
    src.step()
    src.poll()
    tgt = P.engine()
    seen = {}
    real = tgt._readmit

    def readmit(records, journal_known_rids=frozenset()):
        seen["health"] = src.health
        seen["gauge"] = src.registry.snapshot()["serve_health"]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz")
        seen["code"] = e.value.code
        seen["body"] = json.load(e.value)
        return real(records, journal_known_rids)

    monkeypatch.setattr(tgt, "_readmit", readmit)
    src.handoff(tgt)
    assert seen == {"health": "handoff", "gauge": 3.0, "code": 503,
                    "body": {"status": "handoff"}}
    assert src.registry.snapshot()["serve_health"] == 2.0
    tgt.run([])
    src.close()
    tgt.close()


def test_begin_draining_keeps_queue_for_the_snapshot(small_lm):
    def scenario(P):
        eng = P.engine(slots=2)
        for r in P.requests(n=4):
            eng.submit(r)
        eng.step()
        eng.begin_draining("signal")
        assert eng.health == "draining"
        guard = 0
        while any(s is not None for s in eng.slot_req):
            eng.step()
            eng.poll()
            guard += 1
            assert guard < 200
        eng.poll()
        done = set(finish_reasons(eng))
        waiting = {rs.rid for rs in eng.scheduler.waiting}
        assert done and waiting and done | waiting == {0, 1, 2, 3}
        assert {rec["rid"] for rec in eng._live_records()} == waiting
        for rid in waiting:
            eng.cancel(rid)
        eng.poll()
        eng.close()
        return sorted(done), sorted(waiting)
    both(small_lm, scenario)


def test_retire_sink_sees_every_retirement(small_lm):
    """retire_sink fires at both retire sites (a slotted request's and an
    unslotted one's), after the token sink's last token, in the reference's
    order."""
    def scenario(P):
        eng = P.engine(slots=1)
        events = []
        eng.token_sink = lambda rid, tok: events.append(("tok", rid, tok))
        eng.retire_sink = lambda rid, why: events.append(("retire", rid,
                                                          why))
        for r in P.requests(n=3):
            eng.submit(r)
        eng.step()
        eng.cancel(2)                         # still queued: unslotted
        eng.run([])
        eng.close()
        return events
    events = both(small_lm, scenario)
    assert [e for e in events if e[0] == "retire"] == [
        ("retire", 2, "cancelled"), ("retire", 0, "max_tokens"),
        ("retire", 1, "max_tokens")]


# ---------------------------------------------------------------------------
# Replay: the port's readmission feeds delivered tokens back through decode
# ---------------------------------------------------------------------------

def _record(rs_prompt, budget, delivered, rid=0, sampling=None):
    return {"rid": rid, "prompt": [int(t) for t in rs_prompt],
            "max_new_tokens": budget, "delivered": list(delivered),
            "sampling": sampling or {}, "deadline_ms": None,
            "arrival_seq": rid}


def test_readmission_replays_through_decode_ticks(small_lm, ref_run):
    """A readmitted request prefills only its original prompt, then spends
    one decode tick per delivered token (outputs dropped, no token
    delivered twice), and continues as the uninterrupted run."""
    ref, _ = ref_run
    P = Pkg("port", small_lm)
    reqs = {r.rid: r for r in P.requests()}
    eng = P.engine()
    recs = [_record(reqs[rid].prompt, 4, ref[rid][:2], rid=rid,
                    sampling={"temperature": reqs[rid].sampling.temperature,
                              "top_k": reqs[rid].sampling.top_k,
                              "top_p": reqs[rid].sampling.top_p})
            for rid in (1, 2)]
    eng._readmit(recs)
    delivered = []
    eng.token_sink = lambda rid, tok: delivered.append((rid, tok))
    done = streams(eng.run([]))
    assert done == {1: ref[1], 2: ref[2]}
    assert sorted(delivered) == sorted((rid, t) for rid in (1, 2)
                                       for t in ref[rid][2:])
    assert eng.stats["prefill_tokens"] == sum(
        len(reqs[rid].prompt) - 1 for rid in (1, 2))
    assert eng.stats["decode_tokens"] == 4
    eng.close()


def test_replayed_ticks_cannot_end_on_eos(small_lm, ref_run):
    """During the replay the sampled token is dropped and cannot end the
    request: with eos_id set to the token the model draws at step 0, a
    record whose delivered token differs still runs its whole budget."""
    ref, _ = ref_run
    P = Pkg("port", small_lm)
    req = P.requests()[0]                    # greedy
    eos = ref[0][0]
    other = (eos + 1) % P.cfg.vocab_size
    eng = P.engine(eos_id=eos)
    eng._readmit([_record(req.prompt, 4, [other])])
    done = eng.run([], max_ticks=50)        # a stuck slot would not finish
    assert [r.rid for r in done] == [0]
    (r,) = done
    assert r.out_tokens[0] == other and len(r.out_tokens) >= 2
    assert finish_reasons(eng)[0] in ("eos", "max_tokens")
    assert eng.allocator.free_blocks == eng.allocator.num_blocks - 1
    eng.close()


def test_preemption_during_replay_folds_the_rest(small_lm, ref_run):
    """A replaying slot preempted mid-replay folds every delivered token
    into its prompt (the replay is cut short) and finishes as the
    uninterrupted run."""
    ref, _ = ref_run
    P = Pkg("port", small_lm)
    req = P.requests()[1]                    # sampled
    eng = P.engine()
    eng._readmit([_record(req.prompt, 4, ref[1][:3], rid=1,
                          sampling={"temperature": 0.8, "top_k": 8,
                                    "top_p": 1.0})])
    while not any(rs is not None and not rs.pending_chunks
                  and rs.replay == 2 for rs in eng.slot_req):
        eng.step()
    eng.drain()
    slot = next(s for s, rs in enumerate(eng.slot_req) if rs is not None)
    eng._preempt_slot(slot)
    rs = eng.scheduler.waiting[0]
    assert rs.replay == 0 and rs.folded_tokens == 3
    (r,) = eng.run([])
    assert r.out_tokens == ref[1]
    eng.close()
