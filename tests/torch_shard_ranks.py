"""Rank-side jobs of tests/test_torch_sharding.py, importable by the
spawned rank processes (torch and the port only, no JAX).

`run_cases(rank, model, work)` runs in each rank of a (1, model) gloo mesh
on the CPU: every job builds the port's engine (or calls the model) under
the mesh, with the same weights and traffic as the unsharded runs the test
makes in its own process (`unsharded`, the same jobs with no mesh), and
returns what the test compares. One spawn serves every job of every case
of one mesh size.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.nn import shard_ctx
from repro_torch.nn.common import build_lm_grau
from repro_torch.serve import faults as fl
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams

SLOTS, MAX_SEQ = 4, 64


def requests(vocab, sampled=False, deadline_ms=None, request_cls=Request):
    """The reference test's traffic (tests/test_sharding.py::_requests):
    six prompts of 3-14 tokens, 4-6 new tokens each, as `request_cls`
    (the reference's Request takes the greedy ones); `sampled` gives the
    rids greedy / top-k / top-p in turn, `deadline_ms` (rid -> ms) sets
    deadlines."""
    rng = np.random.default_rng(42)
    modes = [SamplingParams(), SamplingParams(temperature=0.7, top_k=20),
             SamplingParams(temperature=1.1, top_p=0.9)]
    out = []
    for i, n in enumerate((5, 9, 3, 14, 7, 11)):
        kw = {}
        if sampled:
            kw["sampling"] = modes[i % 3]
        if deadline_ms and i in deadline_ms:
            kw["deadline_ms"] = deadline_ms[i]
        out.append(request_cls(rid=i, prompt=rng.integers(2, vocab, size=n),
                               max_new_tokens=4 + (i % 3), **kw))
    return out


def mixed_traffic(engine, reqs, cancel=None):
    """Staggered submits interleaved with steps and polls (the reference
    test's _mixed_traffic); `cancel` (tick -> rid) cancels mid-flight.
    Returns {rid: (tokens, finish reason)}."""
    pending = list(reqs)
    schedule = {0: 2, 2: 2, 4: len(reqs) - 4}
    finished, tick = [], 0
    while (pending or engine.scheduler.waiting
           or any(s is not None for s in engine.slot_req)):
        for _ in range(schedule.get(tick, 0)):
            engine.submit(pending.pop(0))
        if cancel and tick in cancel:
            engine.cancel(cancel[tick])
        engine.step()
        finished.extend(engine.poll())
        tick += 1
        assert tick < 500, "traffic did not drain"
    reasons = {rs.rid: rs.finish_reason for rs in engine.scheduler.finished}
    return {r.rid: (tuple(r.out_tokens), reasons[r.rid]) for r in finished}


def _ecfg(job) -> EngineConfig:
    kw = dict(slots=SLOTS, max_seq=MAX_SEQ, telemetry=True)
    kw.update(job.get("ecfg", {}))
    if job.get("attn_grau"):
        kw["attn_grau"] = build_lm_grau("identity")
    return EngineConfig(**kw)


def _engine_job(cfg, params, job, mesh) -> Dict[str, Any]:
    if job.get("grau"):
        from repro_torch.models.config import GRAUConfig
        cfg = cfg.replace(grau=GRAUConfig())
    eng = ServeEngine(cfg, params, _ecfg(job), device="cpu", mesh=mesh)
    if job.get("skewed_clock") and eng.rank != 0:
        # this rank's clock says every deadline has passed: only rank 0's
        # decision may count
        eng._expired = lambda: [True] * len(eng._live_states())
    reqs = requests(cfg.vocab_size, sampled=job.get("sampled", False),
                    deadline_ms=job.get("deadline_ms"))
    if job.get("shared_prefix"):
        head = np.random.default_rng(7).integers(2, cfg.vocab_size, size=24)
        reqs = [dataclasses.replace(r, prompt=np.concatenate([head,
                                                              r.prompt]))
                for r in reqs]
    out = {"streams": mixed_traffic(eng, reqs, job.get("cancel"))}
    if job.get("pools"):
        out["caches"] = eng.caches
        if eng.paged:
            out["block_table"] = eng.block_table.copy()
            out["free_blocks"] = eng.allocator.free_blocks
            out["free_list"] = list(eng.allocator._free)
    m = eng.metrics()
    out["metrics"] = {k: m.get(k) for k in (
        "preempted", "cached_prefix_tokens", "weight_bytes", "mesh", "rank")}
    eng.close()
    return out


def _logits_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """Dense prefill of (2, 16) tokens, then one decode step (the
    reference test's test_sharded_prefill_decode_logits_match)."""
    from repro_torch.launch.steps import pad_heads_for
    from repro_torch.serve import sharding
    toks = torch.from_numpy(job["tokens"])
    b, ctx = toks.shape
    kvh = None
    if mesh is not None:
        cfg = pad_heads_for(cfg, mesh)
        params = sharding.place_params(sharding.pad_params(params, cfg), cfg,
                                       mesh)
        kvh = sharding.local_heads(cfg, shard_ctx.model_size(mesh))[1]
    caches = lm.init_caches(cfg, b, MAX_SEQ, dtype=torch.float32,
                            device="cpu", kv_heads=kvh)
    ctxm = (shard_ctx.use(mesh) if mesh is not None
            else shard_ctx.use(None))
    with ctxm:
        last, caches = lm.prefill_step(
            params, cfg, toks, caches,
            true_length=torch.full((b,), ctx, dtype=torch.int32),
            q_chunk=8, kv_chunk=8)
        nxt = torch.argmax(last, dim=-1)[:, None]
        dec, _ = lm.decode_step(params, cfg, nxt, caches)
    return {"last": last.numpy(), "decode": dec[:, -1].numpy()}


def _recover_job(cfg, params, job, mesh) -> Dict[str, Any]:
    eng = ServeEngine.recover(cfg, params, job["journal"], ecfg=_ecfg(job),
                              device="cpu", mesh=mesh)
    done = eng.run([])
    out = {"streams": {r.rid: tuple(r.out_tokens) for r in done},
           "journal_writer": eng.journal is not None}
    eng.close()
    return out


def _served_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """What a (1, 2) mesh serves that the model axis alone refused:
    snapshot and restore, a handoff to a (1, 2) engine and from a (2, 1)
    one (each over these two ranks), and the front door on global rank 0
    (tests/torch_mesh_ranks.py's jobs); and the message of the ValueError
    a handoff to an engine of this rank alone raises."""
    import torch_mesh_ranks as M
    M._MESHES[(1, 2)] = mesh
    out = {"snapshot": M._snapshot_job(cfg, params, {"dir": job["dir"]},
                                       mesh),
           "handoff": M._handoff_job(cfg, params,
                                     {"src": (1, 2), "dst": (1, 2)}, mesh),
           "handoff_into": M._handoff_job(cfg, params,
                                          {"src": (2, 1), "dst": (1, 2)},
                                          mesh),
           "frontdoor": M._frontdoor_job(cfg, params,
                                         {"n": 6, "cancel": 3}, mesh)}
    eng = ServeEngine(cfg, params, _ecfg(job), device="cpu", mesh=mesh)
    alone = ServeEngine(cfg, params, _ecfg(job), device="cpu")
    try:
        eng.handoff(alone)
        out["handoff_alone"] = None
    except ValueError as e:
        out["handoff_alone"] = str(e)
    alone.close()
    eng.close()
    return out


JOBS = {"engine": _engine_job, "logits": _logits_job,
        "recover": _recover_job, "served": _served_job}


def run_jobs(cfg, params, jobs, mesh) -> Dict[str, Any]:
    torch.manual_seed(0)
    return {name: JOBS[job["kind"]](cfg, params, job, mesh)
            for name, job in jobs.items()}


def run_cases(rank: int, model: int, work) -> Dict[str, Any]:
    """One rank of a (1, model) gloo mesh on the CPU: every job of every
    case in `work` ((name, cfg, params, jobs) each), by case name."""
    from repro_torch.launch.mesh import make_serve_mesh
    mesh = make_serve_mesh(1, model, device="cpu", backend="gloo")
    return {name: run_jobs(cfg, params, jobs, mesh)
            for name, cfg, params, jobs in work}


def raise_on_rank_one(rank: int) -> None:
    import time
    if rank == 1:
        raise RuntimeError("rank one fails")
    time.sleep(600)


def sleep(rank: int) -> None:
    import time
    time.sleep(600)


def unsharded(cfg, params, jobs) -> Dict[str, Any]:
    """The same jobs with no mesh (in the test's own process)."""
    return run_jobs(cfg, params, jobs, None)


def crash_journal(cfg, params, path, tick) -> Dict[int, tuple]:
    """An unsharded port engine serves requests() with a journal and dies
    by process_crash at `tick`; returns the streams delivered so far."""
    from repro_torch.serve.journal import RequestJournal
    plan = fl.FaultPlan()
    plan.arm("process_crash", tick=tick)
    eng = ServeEngine(cfg, params, EngineConfig(
        slots=SLOTS, max_seq=MAX_SEQ, journal=RequestJournal(path),
        faults=plan, telemetry=False), device="cpu")
    reqs = requests(cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    try:
        while True:
            eng.step()
            eng.poll()
    except fl.ProcessCrash:
        pass
    eng.journal.sync()
    eng.journal.close()
    del eng                     # a crashed process: no close()
    return {r.rid: tuple(r.out_tokens) for r in reqs}
