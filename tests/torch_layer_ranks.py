"""Rank-side jobs of tests/test_torch_mesh_layers.py, importable by the
spawned rank processes (torch and the port only, no JAX).

`run_layers(rank, shape, work)` runs in each rank of a (data, model) gloo
mesh of `shape` on the CPU: every job of every case in `work` ((name, cfg,
params, jobs) each, `params` the full tree this rank shards), by case name.
One spawn serves every job of every case of one mesh shape.
"""
from __future__ import annotations

import asyncio
import hashlib
from typing import Any, Dict

import numpy as np
import torch

import torch_shard_ranks as R
from repro_torch.models import lm
from repro_torch.nn import moe, shard_ctx
from repro_torch.nn.common import tree_flatten
from repro_torch.serve import faults as fl
from repro_torch.serve import sharding
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

SLOTS, MAX_SEQ = 4, 64
LENS = (5, 9, 3, 14, 7, 11)     # tests/test_sharding.py's prompt lengths


def frames_for(cfg, n, seed=5):
    """n stub encoder-frame arrays (0.02 * normal), or Nones."""
    if cfg.encoder is None:
        return [None] * n
    rng = np.random.default_rng(seed)
    return [(0.02 * rng.standard_normal(
        (cfg.encoder.num_frames, cfg.d_model))).astype(np.float32)
        for _ in range(n)]


def requests(cfg, request_cls=Request):
    """Six greedy requests of LENS prompt tokens and 4-6 new, with stub
    frames for an enc-dec arch, as `request_cls` (the reference's Request
    takes them too)."""
    rng = np.random.default_rng(42)
    frames = frames_for(cfg, len(LENS))
    return [request_cls(rid=i, prompt=rng.integers(2, cfg.vocab_size,
                                                   size=n),
                        max_new_tokens=4 + i % 3, encoder_frames=f)
            for i, (n, f) in enumerate(zip(LENS, frames))]


def ecfg(**kw) -> EngineConfig:
    return EngineConfig(**{"slots": SLOTS, "max_seq": MAX_SEQ,
                           "telemetry": False, **kw})


def digest(caches) -> str:
    """sha256 over every tensor of a cache tree, in tree order."""
    h = hashlib.sha256()
    for _, t in tree_flatten(caches):
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _local(cfg, params, mesh):
    """(serving config, this rank's shard, init_caches' local shares)."""
    scfg = sharding.serving_config(cfg, mesh)
    return (scfg, sharding.shard_params(params, scfg, mesh),
            sharding.local_caches(scfg, shard_ctx.model_size(mesh)))


def _engine_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """The reference test's mixed submit / poll traffic (requests()):
    streams, this rank's caches or pools and their digest."""
    eng = ServeEngine(cfg, params, ecfg(), device="cpu", mesh=mesh)
    out = {"streams": R.mixed_traffic(eng, requests(cfg))}
    out.update(caches=eng.caches, digest=digest(eng.caches),
               paged=eng.paged)
    eng.close()
    return out


def _logits_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """Dense prefill of the job's (2, 16) tokens (and frames), then one
    decode step, each data rank on its rows (the decode inside
    split_rows, as the engine's tick), the rows gathered."""
    scfg, p, kw = _local(cfg, params, mesh)
    toks = torch.from_numpy(job["tokens"])
    b, ctx = toks.shape
    lo, hi = shard_ctx.data_slots(b, mesh)
    frames = job.get("frames")
    caches = lm.init_caches(scfg, hi - lo, MAX_SEQ, dtype=torch.float32,
                            device="cpu", **kw)
    split = (lo, hi) != (0, b)
    with shard_ctx.use(mesh):
        last, caches = lm.prefill_step(
            p, scfg, toks[lo:hi], caches,
            true_length=torch.full((hi - lo,), ctx, dtype=torch.int32),
            q_chunk=8, kv_chunk=8,
            encoder_frames=(None if frames is None
                            else torch.from_numpy(frames[lo:hi])))
        nxt = torch.argmax(last, dim=-1)[:, None]
        with shard_ctx.split_rows(split):
            dec, _ = lm.decode_step(p, scfg, nxt, caches)
        if split:
            last = shard_ctx.gather_data(last, dim=0)
            dec = shard_ctx.gather_data(dec, dim=0)
    return {"last": last.numpy(), "decode": dec[:, -1].numpy()}


def _drops_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """An MoE layer (group0's l1) at a tight `capacity` over the job's (S,
    1, d) rows, each data rank passing its own inside split_rows: the
    gathered output."""
    _, p, _ = _local(cfg, params, mesh)
    x = torch.from_numpy(job["x"])
    lo, hi = shard_ctx.data_slots(x.shape[0], mesh)
    with shard_ctx.use(mesh), shard_ctx.split_rows():
        y, _ = moe.apply_moe(p["group0"][0]["l1"]["moe"], x[lo:hi], cfg.moe,
                             lm.make_act(cfg, "cpu"),
                             capacity=job["capacity"])
        y = shard_ctx.gather_data(y, dim=0)
    return {"y": y.numpy()}


def _vision_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """apply_lm's train-mode forward with the job's patch embeddings before
    the tokens."""
    scfg, p, _ = _local(cfg, params, mesh)
    with shard_ctx.use(mesh):
        logits, _, _ = lm.apply_lm(
            p, scfg, torch.from_numpy(job["tokens"]),
            patch_embeds=torch.from_numpy(job["patches"]), q_chunk=8,
            kv_chunk=8)
    return {"logits": logits.numpy()}


def _frontdoor_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """requests() through the asyncio front door on global rank 0, each
    with its encoder frames (the other ranks follow, replaying rank 0's
    submits from the mesh sync): rank 0's clients' streams, and every
    rank's engine's finished streams."""
    from repro_torch.launch.mesh import global_rank
    from repro_torch.serve.frontdoor import FrontDoor, follow
    eng = ServeEngine(cfg, params, ecfg(), device="cpu", mesh=mesh)
    out: Dict[str, Any] = {}
    if global_rank(mesh) != 0:
        follow(eng).close()
    else:
        async def main():
            async with FrontDoor(eng, max_waiting=2) as door:
                async def client(req):
                    st = await door.submit(
                        req.prompt, req.max_new_tokens,
                        encoder_frames=req.encoder_frames, rid=req.rid)
                    async for _ in st:
                        pass
                    return req.rid, tuple(st.tokens)
                return dict(await asyncio.gather(
                    *(client(r) for r in requests(cfg))))
        out["clients"] = asyncio.run(main())
    out["engine"] = {rs.rid: tuple(rs.out_tokens)
                     for rs in eng.scheduler.finished}
    return out


def _recover_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """recover(mesh=, encoder_frames=) from the job's journal (an unsharded
    engine's, crashed mid-run), run to the end: every stream."""
    frames = {r.rid: r.encoder_frames for r in requests(cfg)}
    eng = ServeEngine.recover(cfg, params, job["journal"], ecfg=ecfg(),
                              device="cpu", encoder_frames=frames, mesh=mesh)
    out = {"streams": {r.rid: tuple(r.out_tokens) for r in eng.run([])}}
    eng.close()
    return out


def _drawn_job(cfg, params, job, mesh) -> Dict[str, Any]:
    """The engine handed sharding.Draw(job's seed) at the job's weight bits
    beside the engine built from `params` (that draw, whole): whether every
    leaf has the same bits (packed planes and attributes), how many are
    packed, and both engines' streams."""
    from repro_torch.quant.weights import QuantWeight
    kw = ecfg(weight_bits=job["bits"])
    out: Dict[str, Any] = {}
    trees = []
    for label, src in (("tree", params),
                       ("drawn", sharding.Draw(job["seed"], torch.float32))):
        eng = ServeEngine(cfg, src, kw, device="cpu", mesh=mesh)
        trees.append(tree_flatten(eng.params))
        out[label] = R.mixed_traffic(eng, requests(cfg))
        eng.close()

    def same(x, y):
        if isinstance(x, QuantWeight):
            return (isinstance(y, QuantWeight) and x.bits == y.bits
                    and torch.equal(x.q, y.q) and torch.equal(x.e, y.e))
        return torch.equal(x, y)
    (a, b) = trees
    out["same"] = ([p for p, _ in a] == [p for p, _ in b]
                   and all(same(x, y) for (_, x), (_, y) in zip(a, b)))
    out["packed"] = sum(isinstance(x, QuantWeight) for _, x in b)
    return out


JOBS = {"engine": _engine_job, "drawn": _drawn_job, "logits": _logits_job, "drops": _drops_job,
        "vision": _vision_job, "frontdoor": _frontdoor_job,
        "recover": _recover_job}


def run_layers(rank: int, shape, work) -> Dict[str, Any]:
    """One rank of a (data, model) gloo mesh of `shape` on the CPU."""
    from repro_torch.launch.mesh import make_serve_mesh
    mesh = make_serve_mesh(*shape, device="cpu", backend="gloo")
    out = {}
    for name, cfg, params, jobs in work:
        res = {}
        for jname, job in jobs.items():
            torch.manual_seed(0)
            res[jname] = JOBS[job["kind"]](cfg, params, job, mesh)
        out[name] = res
    return out


def crash_journal(cfg, params, path, tick) -> None:
    """An unsharded port engine serves requests() with a journal and dies by
    process_crash at `tick`."""
    from repro_torch.serve.journal import RequestJournal
    plan = fl.FaultPlan()
    plan.arm("process_crash", tick=tick)
    eng = ServeEngine(cfg, params, ecfg(journal=RequestJournal(path),
                                        faults=plan), device="cpu")
    for r in requests(cfg):
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
