"""Rank-side jobs of tests/test_torch_data_axis.py and
tests/test_torch_mesh_durability.py (and of the served cases of
tests/test_torch_sharding.py), importable by the spawned rank processes
(torch and the port only, no JAX).

`run_mesh(rank, shape, work)` runs in each rank of a gloo mesh of `shape`
(data, model) on the CPU: every job of every case in `work`, by case name.
A job may name another mesh shape over the same ranks ("mesh", or a
handoff's "src" / "dst"); each shape's mesh is made once a spawn. One spawn
serves every job of every case of one test file's mesh size.
"""
from __future__ import annotations

import asyncio
import hashlib
import os
from typing import Any, Dict

import numpy as np
import torch

import torch_shard_ranks as R
from repro_torch.nn import shard_ctx
from repro_torch.serve import faults as fl
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams

_MESHES: Dict[tuple, Any] = {}


def mesh_of(shape):
    """The (data, model) mesh of `shape` over this spawn's ranks (made once;
    every rank makes the same meshes in the same order)."""
    from repro_torch.launch.mesh import make_serve_mesh
    shape = tuple(shape)
    if shape not in _MESHES:
        _MESHES[shape] = make_serve_mesh(*shape, device="cpu",
                                         backend="gloo")
    return _MESHES[shape]


def pool_digest(caches) -> str:
    """sha256 over every tensor of a cache tree, in tree order: a data rank's
    pool bytes (payload and exponents)."""
    h = hashlib.sha256()
    for group in caches:
        for c in group:
            for t in c:
                if torch.is_tensor(t):
                    h.update(t.contiguous().view(-1).view(torch.uint8)
                             .numpy().tobytes())
    return h.hexdigest()


def shared_prefix_requests(vocab, request_cls=Request,
                           sampling=SamplingParams()):
    """The reference test's shared_prefix_requests(6, prefix_len=40,
    seed=51) (tests/test_prefix_cache.py): two 40-token prefixes, each
    request one of them and a 2-11-token tail, 4 new tokens."""
    rng = np.random.default_rng(51)
    prefixes = [rng.integers(2, vocab, size=40) for _ in range(2)]
    reqs = []
    for i in range(6):
        pre = prefixes[int(rng.integers(0, 2))]
        t = rng.integers(2, vocab, size=int(rng.integers(2, 12)))
        reqs.append(request_cls(rid=i, prompt=np.concatenate([pre, t]),
                                max_new_tokens=4, sampling=sampling))
    return reqs


PREFIX_ECFG = dict(slots=2, max_seq=64, page_size=8, prefill_chunk=16)


def durable_requests(vocab, request_cls=Request, sampling_cls=SamplingParams,
                     n=4, max_new=10):
    """The durability cases' traffic: prompts of 9-35 tokens (two of them
    longer than a 16-token chunk, so a crash can land mid-prefill), even
    rids greedy, odd rids sampled (T 0.8, top-k 8)."""
    rng = np.random.default_rng(13)
    lens = (20, 35, 9, 28, 14, 31, 6, 24)[:n]
    return [request_cls(rid=i, prompt=rng.integers(2, vocab, size=k),
                        max_new_tokens=max_new,
                        sampling=sampling_cls(
                            temperature=0.8 if i % 2 else 0.0,
                            top_k=8 if i % 2 else 0))
            for i, k in enumerate(lens)]


DURABLE_ECFG = dict(slots=4, max_seq=64, page_size=8, prefill_chunk=16,
                    seed=11)


def _ecfg(job, base) -> EngineConfig:
    return EngineConfig(**{**base, **job.get("ecfg", {})})


def streams(done) -> Dict[int, tuple]:
    return {r.rid: tuple(r.out_tokens) for r in done}


def busy(eng) -> bool:
    return bool(eng.scheduler.waiting
                or any(s is not None for s in eng.slot_req))


def decoding(eng) -> int:
    return sum(1 for s in eng.slot_req
               if s is not None and not s.pending_chunks)


# ---------------------------------------------------------------------------
# Data-axis jobs
# ---------------------------------------------------------------------------

def _engine_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """tests/torch_shard_ranks.py's engine job (mixed submit / poll
    traffic), with the digest of this rank's pool bytes."""
    eng_job = dict(job, pools=True)
    out = R._engine_job(cfg, params, eng_job, mesh)
    out["pool_digest"] = pool_digest(out["caches"])
    if not job.get("pools"):
        out.pop("caches")
    return out


def _prefix51_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """The reference's mesh prefix-cache test: shared_prefix_requests
    through run(), the cache on or off."""
    ecfg = EngineConfig(**PREFIX_ECFG, prefix_cache=job["prefix_cache"])
    eng = ServeEngine(cfg, params, ecfg, device="cpu", mesh=mesh)
    reqs = shared_prefix_requests(cfg.vocab_size)
    eng.run(reqs)
    out = {"streams": streams(reqs),
           "cached_prefix_tokens": eng.metrics()["cached_prefix_tokens"],
           "free_blocks": eng.allocator.free_blocks,
           "pool_digest": pool_digest(eng.caches)}
    eng.close()
    return out


def _logits_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """Dense prefill of (2, 16) tokens, then one decode step (the reference
    test's test_sharded_prefill_decode_logits_match), each data rank on
    its range of the rows (all of them where the data axis does not divide
    the batch), the rows gathered over the data axis."""
    from repro_torch.launch.steps import pad_heads_for
    from repro_torch.models import lm
    from repro_torch.serve import sharding
    toks = torch.from_numpy(job["tokens"])
    b, ctx = toks.shape
    lo, hi = shard_ctx.data_slots(b, mesh)
    cfg = pad_heads_for(cfg, mesh)
    params = sharding.place_params(sharding.pad_params(params, cfg), cfg,
                                   mesh)
    kvh = sharding.local_heads(cfg, shard_ctx.model_size(mesh))[1]
    caches = lm.init_caches(cfg, hi - lo, R.MAX_SEQ, dtype=torch.float32,
                            device="cpu", kv_heads=kvh)
    with shard_ctx.use(mesh):
        last, caches = lm.prefill_step(
            params, cfg, toks[lo:hi], caches,
            true_length=torch.full((hi - lo,), ctx, dtype=torch.int32),
            q_chunk=8, kv_chunk=8)
        nxt = torch.argmax(last, dim=-1)[:, None]
        dec, _ = lm.decode_step(params, cfg, nxt, caches)
        if (lo, hi) != (0, b):
            last = shard_ctx.gather_data(last, dim=0)
            dec = shard_ctx.gather_data(dec, dim=0)
    return {"last": last.numpy(), "decode": dec[:, -1].numpy()}


# ---------------------------------------------------------------------------
# Durability jobs
# ---------------------------------------------------------------------------

def _count_saves():
    """Wrap ckpt/checkpoint.save to count this rank's calls."""
    from repro_torch.ckpt import checkpoint as ckpt
    calls = []
    save = ckpt.save

    def counted(*a, **kw):
        calls.append(1)
        return save(*a, **kw)
    ckpt.save = counted
    return calls, lambda: setattr(ckpt, "save", save)


def _snapshot_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """The uninterrupted run; then the same traffic snapshotted with every
    slot busy (every rank calls snapshot(); global rank 0 writes) and
    restored on the same mesh: the streams, the decoded payload's requests
    and radix summary, this rank's checkpoint writes, the trace lines it
    exported and the returned path."""
    reqs = durable_requests(cfg.vocab_size)
    eng = ServeEngine(cfg, params, _ecfg(job, DURABLE_ECFG), device="cpu",
                      mesh=mesh)
    whole = streams(eng.run(reqs))
    eng.close()
    eng = ServeEngine(cfg, params, _ecfg(job, DURABLE_ECFG), device="cpu",
                      mesh=mesh)
    done = []
    for r in durable_requests(cfg.vocab_size):
        eng.submit(r)
    # every slot holds a request, some of them decoding
    while not all(s is not None for s in eng.slot_req) or \
            eng.stats["ticks"] < 2:
        eng.step()
        done.extend(eng.poll())
        assert busy(eng), "the traffic ended before every slot was busy"
    calls, undo = _count_saves()
    try:
        path = eng.snapshot(job["dir"], step=123)
    finally:
        undo()
    trace_lines = eng.export_trace(os.path.join(
        job["dir"], f"trace{torch.distributed.get_rank()}.jsonl"
        if mesh is not None else "trace.jsonl"))
    payload = ServeEngine._load_snapshot(job["dir"], 123)
    eng.close()
    restored = ServeEngine.restore(cfg, params, job["dir"], step=123,
                                   device="cpu", mesh=mesh)
    done.extend(restored.run([]))
    restored.close()
    for rec in payload["requests"]:
        rec.pop("deadline_elapsed_ms")
    return {"whole": whole, "streams": streams(done), "path": str(path),
            "saves": len(calls), "trace_lines": trace_lines,
            "requests": payload["requests"],
            "radix": payload["radix"], "tick": payload["tick"]}


def _crash_ticks(cfg, params, job, mesh):
    """The uninterrupted run's state at the start of each engine tick
    value (the first step that sees it): the crash ticks — one with a slot
    mid-prefill, the first with >= 3 slots decoding, the last."""
    eng = ServeEngine(cfg, params, _ecfg(job, DURABLE_ECFG), device="cpu",
                      mesh=mesh)
    for r in durable_requests(cfg.vocab_size):
        eng.submit(r)
    seen = {}
    while busy(eng):
        t = eng.stats["ticks"]
        if t not in seen:
            seen[t] = (any(s is not None and s.pending_chunks
                           for s in eng.slot_req), decoding(eng))
        eng.step()
        eng.poll()
    eng.close()
    mid_prefill = next(t for t, (pre, _) in sorted(seen.items())
                       if pre and t > 0)
    three = next(t for t, (_, n) in sorted(seen.items()) if n >= 3)
    return [mid_prefill, three, max(seen)]


def _crash_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """process_crash at three ticks (_crash_ticks) on every rank, then
    ServeEngine.recover(mesh=) from the journal global rank 0 wrote: each
    rank's recovered streams, who held a journal writer, and (rank 0) the
    journal's own streams."""
    from repro_torch.launch.mesh import global_rank, host_broadcast
    from repro_torch.serve.journal import RequestJournal
    rank0 = global_rank(mesh) == 0
    os.makedirs(job["dir"], exist_ok=True)
    out = {"ticks": _crash_ticks(cfg, params, job, mesh), "runs": []}
    for t in out["ticks"]:
        path = os.path.join(job["dir"], f"crash{t}.journal")
        plan = fl.FaultPlan()
        plan.arm("process_crash", tick=t)
        eng = ServeEngine(cfg, params, _ecfg(job, {
            **DURABLE_ECFG, "faults": plan,
            "journal": RequestJournal(path) if rank0 else None}),
            device="cpu", mesh=mesh)
        writers = [eng.journal is not None]
        for r in durable_requests(cfg.vocab_size):
            eng.submit(r)
        try:
            while busy(eng):
                eng.step()
                eng.poll()
        except fl.ProcessCrash:
            pass
        if eng.journal is not None:
            eng.journal.sync()
            eng.journal.close()
        del eng                 # a crashed process: no close()
        host_broadcast(mesh, None)      # the journal is on disk
        rec = ServeEngine.recover(cfg, params, path,
                                  ecfg=_ecfg(job, DURABLE_ECFG),
                                  device="cpu", mesh=mesh)
        writers.append(rec.journal is not None)
        got = streams(rec.run([]))
        rec.close()
        host_broadcast(mesh, None)
        out["runs"].append({"tick": t, "writers": writers, "streams": got,
                            "journal": journal_streams(path)
                            if rank0 else None})
    return out


def journal_streams(path) -> Dict[int, tuple]:
    """{rid: every delivered token} from a journal's records."""
    import json
    out: Dict[int, list] = {}
    with open(path, "rb") as f:
        for line in f.read().splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec["kind"] == "submit":
                out.setdefault(rec["rid"], [])
            elif rec["kind"] == "token":
                out[rec["rid"]].append(rec["tok"])
    return {rid: tuple(t) for rid, t in out.items()}


def _handoff_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """Live handoff mid-decode from an engine on mesh `src` to a fresh one
    on `dst` (both over this spawn's ranks): the streams, and the source's
    health and free blocks after it."""
    src = ServeEngine(cfg, params, _ecfg(job, DURABLE_ECFG), device="cpu",
                      mesh=mesh_of(job["src"]))
    done = []
    for r in durable_requests(cfg.vocab_size):
        src.submit(r)
    while decoding(src) < 2 or src.stats["decode_tokens"] < 2:
        src.step()
        done.extend(src.poll())
    dst = ServeEngine(cfg, params, _ecfg(job, DURABLE_ECFG), device="cpu",
                      mesh=mesh_of(job["dst"]))
    summary = src.handoff(dst)
    out = {"transferred": summary["transferred"], "health": src.health,
           "free_blocks": src.allocator.free_blocks,
           "usable_blocks": src.allocator.num_blocks - 1}
    done.extend(dst.run([]))
    src.close()
    dst.close()
    out["streams"] = streams(done)
    return out


def _frontdoor_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """The asyncio front door on global rank 0 (the other ranks follow):
    `n` concurrent submits with max_waiting=2, rid `cancel` cancelled after
    its 4th token. Rank 0 returns each client's (tokens, finish reason) and
    the deepest waiting queue a submit saw; every rank returns its engine's
    finished streams."""
    from repro_torch.launch.mesh import global_rank
    from repro_torch.serve.frontdoor import FrontDoor, follow
    eng = ServeEngine(cfg, params, _ecfg(job, DURABLE_ECFG), device="cpu",
                      mesh=mesh)
    reqs = durable_requests(cfg.vocab_size, n=job["n"],
                            max_new=job.get("max_new", 10))
    out: Dict[str, Any] = {}
    if global_rank(mesh) != 0:
        follow(eng).close()
    else:
        async def main():
            depth = [0]
            async with FrontDoor(eng, max_waiting=2) as door:
                async def client(req):
                    st = await door.submit(req.prompt, req.max_new_tokens,
                                           req.sampling, rid=req.rid)
                    depth[0] = max(depth[0], len(eng.scheduler.waiting))
                    n = 0
                    async for _ in st:
                        n += 1
                        if req.rid == job["cancel"] and n == 4:
                            await st.cancel()
                    return req.rid, (tuple(st.tokens), st.finish_reason)
                got = await asyncio.gather(*(client(r) for r in reqs))
            return dict(got), depth[0]
        out["clients"], out["max_waiting_seen"] = asyncio.run(main())
    out["engine"] = {rs.rid: (tuple(rs.out_tokens), rs.finish_reason)
                     for rs in eng.scheduler.finished}
    return out


JOBS = {"engine": _engine_job, "prefix51": _prefix51_job,
        "logits": _logits_job, "snapshot": _snapshot_job,
        "crash": _crash_job, "handoff": _handoff_job,
        "frontdoor": _frontdoor_job}


def run_mesh(rank: int, shape, work) -> Dict[str, Any]:
    """One rank of a gloo mesh of `shape` on the CPU: every job of every
    case in `work` ((name, cfg, params, jobs) each), by case name; a job's
    "mesh" names another shape over the same ranks."""
    out = {}
    for name, cfg, params, jobs in work:
        res = {}
        for jname, job in jobs.items():
            torch.manual_seed(0)
            res[jname] = JOBS[job["kind"]](
                cfg, params, job, mesh_of(job.get("mesh", shape)))
        out[name] = res
    return out
