"""PyTorch port vs the JAX reference: the serving mesh's data axis (the
port's counterparts of tests/test_sharding.py's and
tests/test_prefix_cache.py's (2, 2) and (4, 1) cases).

The port runs one process a rank (launch/mesh.spawn_ranks, gloo on the
CPU). A data rank decodes its contiguous range of the slots; one all-gather
a tick brings every rank the tick's records and every layer's new K/V rows,
which each rank writes through the unsharded write, so every rank of a
model column holds the same pool. Each mesh shape spawns its ranks once
(module cache) and runs every job there (tests/torch_mesh_ranks.py); the
reference runs unsharded in this process, as its own mesh tests compare
(three of its mesh tests fail on this jax: the port is not held against
its mesh paths). Checks, f32 at smoke size:

  * dense prefill / decode logits at (2, 2) and (4, 1): the reference's
    unsharded ones within 1e-4, the same bits on every rank;
  * the reference test's mixed submit / poll traffic at (2, 2) paged,
    (2, 2) dense and (4, 1) paged: the reference's tokens; pools (and dense
    caches) within 1e-4 of the reference's, the null block included, each
    rank against its model slice; block tables and free lists equal; every
    data rank's pool bytes equal to every other's, exactly;
  * sampled (greedy / top-k / top-p) traffic at (2, 2); int4 weights + int4
    KV + GRAU at (2, 2) (the requantizing write, pool bytes equal across
    data ranks); shared-prefix traffic (cache on and off) at (2, 2) and
    (4, 1); preemption and cancel at (2, 1); 3 slots over 2 data ranks
    (the decode replicated); gemma-smoke's traffic at every shape;
  * decode_plan's `plan_batch`: a data rank's launch cuts each slot's
    sequence where the unsharded launch does; the exact decode write (idle
    slots sharing the null block, a position past the table) the
    reference's scatter byte for byte.

Every process group has a 60 s collective timeout and every spawn a join
deadline, so a divergence fails its test instead of hanging the suite.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ranks as M  # noqa: E402
import torch_shard_ranks as R  # noqa: E402
from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import GRAUConfig as JGRAUConfig  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn.common import build_lm_grau as jbuild_lm_grau  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.convert import (caches_from_reference,  # noqa: E402
                                        from_reference,
                                        pools_from_reference)
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.serve import sharding  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
JOIN_S = 240.0
SHAPES = {"2x1": (2, 1), "2x2": (2, 2), "4x1": (4, 1)}
ARCHS = {"llama3": "llama3.2-3b", "gemma": "gemma-7b"}


class FakeMesh:
    """A (data, model) mesh's shape and one rank's place, for placement in
    this process (no process group)."""
    mesh_dim_names = ("data", "model")

    def __init__(self, d, m, dr, mr):
        self.shape, self.place = (d, m), {"data": dr, "model": mr}

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, name):
        return self.place[name]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def models(arch):
    """(reference cfg, reference f32 params, port cfg, port params)."""
    jcfg = jget_config(arch, smoke=True)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tcfg = tget_config(arch, smoke=True)
    return jcfg, jparams, tcfg, from_reference(jparams, tcfg, device="cpu")


def _tokens(cfg):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 2,
                                         cfg.vocab_size), np.int64)


# the reference engine's settings of each engine job (slots, max_seq and
# the mixed traffic of tests/torch_shard_ranks.py)
ENGINE_JOBS = {
    "paged": {"kind": "engine", "pools": True},
    "dense": {"kind": "engine", "pools": True, "ecfg": {"paged": False}},
    "sampled": {"kind": "engine", "sampled": True, "ecfg": {"seed": 3}},
    "wq4_kv4_grau": {"kind": "engine", "grau": True, "attn_grau": True,
                     "ecfg": {"weight_bits": 4, "kv_bits": 4}},
    "preempt_cancel": {"kind": "engine", "cancel": {5: 2},
                       "ecfg": {"num_blocks": 5, "preempt_after_ticks": 1,
                                "page_size": 8}},
    "slots3": {"kind": "engine", "ecfg": {"slots": 3}},
}
PREFIX_JOBS = {"prefix_on": {"kind": "prefix51", "prefix_cache": True},
               "prefix_off": {"kind": "prefix51", "prefix_cache": False}}


def _jobs(shape, arch):
    """Each mesh shape's jobs of an arch (gemma: its paged traffic)."""
    if arch == "gemma":
        return {"paged": ENGINE_JOBS["paged"]}
    cfg = tget_config(ARCHS[arch], smoke=True)
    logits = {"logits": {"kind": "logits", "tokens": _tokens(cfg)}}
    names = {"2x1": ("preempt_cancel", "slots3"),
             "2x2": ("paged", "dense", "sampled", "wq4_kv4_grau"),
             "4x1": ("paged",)}[shape]
    jobs = {n: ENGINE_JOBS[n] for n in names}
    if shape != "2x1":
        jobs.update(logits, **PREFIX_JOBS)
    return jobs


_SPAWNED = {}


def spawned(shape):
    """Every rank's results at `shape`, by arch: one spawn a shape."""
    if shape not in _SPAWNED:
        d, m = SHAPES[shape]
        work = [(arch, models(ARCHS[arch])[2], models(ARCHS[arch])[3],
                 _jobs(shape, arch)) for arch in ARCHS]
        _SPAWNED[shape] = tmesh.spawn_ranks(
            M.run_mesh, d * m, args=((d, m), work), threads=1,
            join_s=JOIN_S)
    return _SPAWNED[shape]


def _rank(shape, r):
    """FakeMesh of global rank r at `shape` (ranks are data-major)."""
    d, m = SHAPES[shape]
    return FakeMesh(d, m, r // m, r % m)


@functools.lru_cache(maxsize=None)
def reference_engine(arch, job):
    """The reference's unsharded engine on a job's traffic: streams (with
    finish reasons), pools / caches in the port's layout, block table and
    free list."""
    jcfg, jparams, _, _ = models(ARCHS[arch])
    spec = {**ENGINE_JOBS, **PREFIX_JOBS}[job]
    kw = dict(slots=R.SLOTS, max_seq=R.MAX_SEQ, telemetry=False,
              paged_impl="gather")
    if spec["kind"] == "prefix51":
        kw = dict(telemetry=False, paged_impl="gather", **M.PREFIX_ECFG,
                  prefix_cache=spec["prefix_cache"])
    kw.update(spec.get("ecfg", {}))
    if kw.get("paged") is False:
        kw.pop("paged_impl")
    if spec.get("grau"):
        jcfg = jcfg.replace(grau=JGRAUConfig())
        kw["attn_grau"] = jbuild_lm_grau("identity")
    eng = jeng.ServeEngine(jcfg, jparams, jeng.EngineConfig(**kw))
    if spec["kind"] == "prefix51":
        reqs = M.shared_prefix_requests(jcfg.vocab_size,
                                        request_cls=jeng.Request,
                                        sampling=jeng.SamplingParams())
        eng.run(reqs)
        return {"streams": M.streams(reqs),
                "cached_prefix_tokens": eng.metrics()["cached_prefix_tokens"],
                "free_blocks": eng.allocator.free_blocks}
    reqs = R.requests(jcfg.vocab_size, sampled=spec.get("sampled", False),
                      request_cls=jeng.Request)
    if spec.get("sampled"):
        reqs = [jeng.Request(rid=r.rid, prompt=r.prompt,
                             max_new_tokens=r.max_new_tokens,
                             sampling=jeng.SamplingParams(
                                 temperature=r.sampling.temperature,
                                 top_k=r.sampling.top_k,
                                 top_p=r.sampling.top_p))
                for r in reqs]
    out = {"streams": R.mixed_traffic(eng, reqs, spec.get("cancel"))}
    if kw.get("paged") is False:
        out["caches"] = caches_from_reference(eng.caches, device="cpu")
    else:
        out["caches"] = pools_from_reference(eng.caches, device="cpu")
        out["block_table"] = np.asarray(eng.block_table)
        out["free_list"] = list(eng.allocator._free)
    return out


@functools.lru_cache(maxsize=None)
def reference_logits(arch):
    jcfg, jparams, tcfg, _ = models(ARCHS[arch])
    toks = jnp.asarray(_tokens(tcfg), jnp.int32)
    b, ctx = toks.shape
    tl = jnp.full((b,), ctx, jnp.int32)
    caches = jlm.init_caches(jcfg, b, R.MAX_SEQ, dtype=jnp.float32)
    last, caches = jax.jit(lambda p, t, c: jlm.prefill_step(
        p, jcfg, t, c, true_length=tl, q_chunk=8, kv_chunk=8))(
            jparams, toks, caches)
    nxt = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
    dec, _ = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))(
        jparams, nxt, caches)
    return np.asarray(last), np.asarray(dec)[:, -1]


def _tensors(caches):
    return [t for group in caches for c in group for t in c
            if torch.is_tensor(t)]


# ---------------------------------------------------------------------------
# Plumbing
# ---------------------------------------------------------------------------

def test_data_slots_split_or_replicate():
    """A data rank's slots are its contiguous range where the axis divides
    the slots, all of them otherwise (the reference's divisibility rule)."""
    from repro_torch.nn import shard_ctx
    assert [shard_ctx.data_slots(8, FakeMesh(2, 2, d, 0))
            for d in range(2)] == [(0, 4), (4, 8)]
    assert [shard_ctx.data_slots(4, FakeMesh(4, 1, d, 0))
            for d in range(4)] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert shard_ctx.data_slots(3, FakeMesh(2, 1, 1, 0)) == (0, 3)
    assert shard_ctx.data_slots(5, None) == (0, 5)


def test_decode_plan_batch_gives_a_data_rank_the_unsharded_cut():
    """decode_plan sizes the bf16 decode's sequence parts from slots x KV
    heads: a data rank launching 4 of 8 slots would plan its own parts
    (here 4 parts of 16 blocks against 2 of 32 on 8 SMs) and round each
    slot's sum apart from the unsharded launch. Planned for the whole batch
    (`plan_batch`, which the engine's shard_ctx.use carries into the
    wrapper), each rank's share — emulated part by part and warp by warp —
    is the unsharded launch's bits slot for slot."""
    from repro_torch.nn import shard_ctx
    from test_torch_paged_attention import emulate_decode_parts, make_table
    rng = np.random.default_rng(81)
    slots, h, kvh, d, bs, cap = 8, 4, 2, 32, 8, 64
    full = pa.decode_plan(slots, kvh, cap, cap, bs, sms=8)
    own = pa.decode_plan(slots // 2, kvh, cap, cap, bs, sms=8)
    assert full == (2, 32) and own == (4, 16)
    with shard_ctx.use(None, plan_batch=slots):
        assert pa.decode_plan(shard_ctx.plan_batch(), kvh, cap, cap, bs,
                              sms=8) == full
    lengths = np.array([1, 140, 300, 512, 77, 3, 257, 65], np.int32)
    num_blocks = slots * cap + 1
    table = torch.from_numpy(make_table(rng, list(lengths), cap, num_blocks))
    k, v = (torch.from_numpy(rng.normal(size=(num_blocks, bs, kvh, d))
                             .astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.normal(size=(slots, h, d)).astype(np.float32))
    tl = torch.from_numpy(lengths)
    want = emulate_decode_parts(q, k, v, table, tl, *full, tile=16)
    for lo in (0, 4):
        sl = slice(lo, lo + 4)
        got = emulate_decode_parts(q[sl], k, v, table[sl], tl[sl], *full,
                                   tile=16)
        assert torch.equal(got, want[sl])


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_exact_decode_write_matches_reference_scatter(bits):
    """The write a data rank's decode and write-back use
    (paged_update(exact=True)): three idle slots writing different rows
    into the null block, a slot whose position lies past the sliced
    table, and two live slots — every byte of the pool, the null block
    included (and the exponent planes of an 8- or 4-bit pool), equals the
    reference's one scatter."""
    rng = np.random.default_rng(60 + bits)
    nb, bs, kvh, hd = 8, 8, 2, 16
    table = np.array([[3, 1], [0, 0], [2, 5], [0, 0], [4, 7], [0, 0]],
                     np.int32)
    lengths = np.array([9, 5, 3, 12, 16, 1], np.int32)   # slot 4: past
    new = rng.normal(size=(6, 1, kvh, hd)).astype(np.float32)
    if bits == 16:
        k = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
        pools = (k, k + 1)
        jc = jattn.PagedKVCache(*map(jnp.asarray, pools))
        tc = tattn.PagedKVCache(*(torch.from_numpy(a.copy()) for a in pools))
    else:
        hdp = hd // 2 if bits == 4 else hd
        pools = tuple(rng.integers(-128, 128, size=(nb, bs, kvh, hdp))
                      .astype(np.int8) for _ in range(2)) + tuple(
            rng.integers(-12, -2, size=(nb, kvh)).astype(np.int8)
            for _ in range(2))
        jc = jattn.QuantPagedKVCache(*map(jnp.asarray, pools), bits=bits)
        tc = tattn.QuantPagedKVCache(
            *(torch.from_numpy(a.copy()) for a in pools), bits=bits)
    jc = jattn.paged_update(jc, jnp.asarray(new), jnp.asarray(new * 2),
                            jattn.PagedState(jnp.asarray(table),
                                             jnp.asarray(lengths)))
    tattn.paged_update(tc, torch.from_numpy(new), torch.from_numpy(new * 2),
                       tattn.PagedState(torch.from_numpy(table),
                                        torch.from_numpy(lengths)),
                       exact=True)
    names = ("k", "v") + (("k_exp", "v_exp") if bits < 16 else ())
    for name in names:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))


# ---------------------------------------------------------------------------
# Logits and engine traffic under data axes (spawned ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["2x2", "4x1"])
def test_data_axis_logits_match_reference(shape):
    """prefill_step / decode_step through dense caches, a data rank on its
    rows, gathered: the reference's unsharded logits within 1e-4, the same
    bits on every rank."""
    want_last, want_dec = reference_logits("llama3")
    res = [r["llama3"]["logits"] for r in spawned(shape)]
    for r in res:
        np.testing.assert_array_equal(r["last"], res[0]["last"])
        np.testing.assert_array_equal(r["decode"], res[0]["decode"])
    np.testing.assert_allclose(res[0]["last"], want_last, **TOL)
    np.testing.assert_allclose(res[0]["decode"], want_dec, **TOL)


@pytest.mark.parametrize("shape,arch,job", [
    ("2x2", "llama3", "paged"), ("2x2", "llama3", "dense"),
    ("4x1", "llama3", "paged"), ("2x1", "gemma", "paged"),
    ("2x2", "gemma", "paged"), ("4x1", "gemma", "paged")])
def test_data_axis_traffic_matches_reference(shape, arch, job):
    """Mixed submit / poll traffic: the reference's unsharded tokens on
    every rank; each rank's pools (dense caches) within 1e-4 of the
    reference's sliced to its KV heads (and slots), the null block
    included; the block table and free list the reference's; and every
    data rank of a model column holds the same pool bytes."""
    want = reference_engine(arch, job)
    res = [r[arch][job] for r in spawned(shape)]
    d, m = SHAPES[shape]
    _, _, tcfg, _ = models(ARCHS[arch])
    place = (sharding.place_dense_caches if job == "dense"
             else sharding.place_paged_pools)
    for r, got in enumerate(res):
        assert got["streams"] == want["streams"], r
        ref = place(want["caches"], tcfg, _rank(shape, r))
        pairs = list(zip(_tensors(got["caches"]), _tensors(ref)))
        assert pairs and len(pairs) == len(_tensors(want["caches"]))
        for g, w in pairs:
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        if job == "paged":
            np.testing.assert_array_equal(got["block_table"],
                                          want["block_table"])
            assert got["free_list"] == want["free_list"]
            # a model column's data ranks hold the same bytes
            assert got["pool_digest"] == res[r % m]["pool_digest"]


def test_sampled_streams_under_data_axis():
    """Greedy, top-k and top-p slots side by side at (2, 2): the reference's
    draws (each data rank samples its slots with the per-request keys)."""
    want = reference_engine("llama3", "sampled")["streams"]
    res = [r["llama3"]["sampled"]["streams"] for r in spawned("2x2")]
    assert all(r == want for r in res)
    assert sum(len(t) for t, _ in want.values()) > 12


def test_wq4_kv4_grau_under_data_axis():
    """int4 weights + int4 KV + the GRAU MLP and epilogue at (2, 2): the
    reference's tokens, and the data ranks' 4-bit pools (payload and
    exponents, which the requantizing write raises) the same bytes."""
    want = reference_engine("llama3", "wq4_kv4_grau")["streams"]
    res = [r["llama3"]["wq4_kv4_grau"] for r in spawned("2x2")]
    assert all(r["streams"] == want for r in res)
    assert res[0]["pool_digest"] == res[2]["pool_digest"]
    assert res[1]["pool_digest"] == res[3]["pool_digest"]


@pytest.mark.parametrize("shape", ["2x2", "4x1"])
def test_prefix_cache_under_data_axis(shape):
    """The reference's shared_prefix_requests(6, prefix_len=40, seed=51),
    cache on and off: its tokens, cached-prefix tokens and free blocks on
    every rank, and the same pool bytes on a model column's data ranks."""
    m = SHAPES[shape][1]
    for job in ("prefix_on", "prefix_off"):
        want = reference_engine("llama3", job)
        res = [r["llama3"][job] for r in spawned(shape)]
        for r, got in enumerate(res):
            for key in ("streams", "cached_prefix_tokens", "free_blocks"):
                assert got[key] == want[key], (job, key)
            assert got["pool_digest"] == res[r % m]["pool_digest"]
    assert reference_engine("llama3", "prefix_on")[
        "cached_prefix_tokens"] > 0


def test_preemption_and_cancel_under_data_axis():
    """A 4-block pool preempts and rid 2 is cancelled mid-flight at (2, 1):
    the reference's tokens and finish reasons on both ranks."""
    want = reference_engine("llama3", "preempt_cancel")["streams"]
    res = [r["llama3"]["preempt_cancel"] for r in spawned("2x1")]
    assert want[2][1] == "cancelled"
    assert all(r["streams"] == want for r in res)
    assert res[0]["metrics"]["preempted"] > 0
    assert res[0]["pool_digest"] == res[1]["pool_digest"]


def test_replicated_decode_when_slots_do_not_split():
    """3 slots over 2 data ranks: both ranks decode every slot (the
    reference's divisibility rule), the reference's tokens."""
    want = reference_engine("llama3", "slots3")["streams"]
    res = [r["llama3"]["slots3"] for r in spawned("2x1")]
    assert all(r["streams"] == want for r in res)
    assert res[0]["pool_digest"] == res[1]["pool_digest"]
