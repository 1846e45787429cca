"""PyTorch port vs the JAX reference: the block allocator's refcounts, the
radix prefix cache, the copy-on-write block copy and prefix reuse in the
serving engine.

The host-side structures run the same operation sequences in both packages
and must report the same results. The port's engine must keep the
reference's invariant — prefix reuse only skips work, so cache-on and
cache-off streams and pool contents are the same bits — and serve the
reference's traces with the reference's token streams and prefix counters
(the reference on its gather path, the port on its kernels' plain
versions, both in f32 from the same weights).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import GRAUConfig as JGRAUConfig  # noqa: E402
from repro.nn.common import build_lm_grau as jbuild_lm_grau  # noqa: E402
from repro.quant.policy import kv_policy as jkv_policy  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import kv_cache as jkvc  # noqa: E402
from repro.serve import radix_cache as jradix  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models.config import GRAUConfig as TGRAUConfig  # noqa: E402
from repro_torch.models.convert import (from_reference,  # noqa: E402
                                        pools_from_reference)
from repro_torch.nn.common import build_lm_grau  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import kv_cache as tkvc  # noqa: E402
from repro_torch.serve import radix_cache as tradix  # noqa: E402

ARCH = "llama3.2-3b"
PKGS = {"ref": (jkvc, jradix), "port": (tkvc, tradix)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{mode: (reference cfg, reference params, port cfg, port params)} at
    llama3-smoke; "grau" has the GRAU MLP activation."""
    out = {}
    for mode in ("float", "grau"):
        jcfg, tcfg = (jget_config(ARCH, smoke=True),
                      tget_config(ARCH, smoke=True))
        if mode == "grau":
            jcfg, tcfg = (jcfg.replace(grau=JGRAUConfig()),
                          tcfg.replace(grau=TGRAUConfig()))
        jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        out[mode] = (jcfg, jp, tcfg, from_reference(jp, tcfg, device="cpu"))
    return out


# modes of the engine: (model, EngineConfig extras)
MODES = {
    "float": ("float", {}),
    "grau_mlp": ("grau", {}),
    "attn_epilogue": ("float", {"attn_grau": "identity"}),
    "kv4": ("float", {"kv_bits": 4}),
}


def _engines(models, mode, **kw):
    """(reference engine, port engine) over the same weights and config."""
    model, extra = MODES[mode]
    jcfg, jp, tcfg, tp = models[model]
    extra = dict(extra, **kw)
    jx, tx = dict(extra), dict(extra)
    if "attn_grau" in extra:
        jx["attn_grau"] = jbuild_lm_grau(extra["attn_grau"])
        tx["attn_grau"] = build_lm_grau(extra["attn_grau"])
    je = jeng.ServeEngine(jcfg, jp, jeng.EngineConfig(
        paged_impl="gather", telemetry=False, **jx))
    te = teng.ServeEngine(tcfg, tp, teng.EngineConfig(**tx), device="cpu")
    return je, te


def _port(models, mode, **kw):
    model, extra = MODES[mode]
    _, _, tcfg, tp = models[model]
    extra = dict(extra, **kw)
    if "attn_grau" in extra:
        extra["attn_grau"] = build_lm_grau(extra["attn_grau"])
    return teng.ServeEngine(tcfg, tp, teng.EngineConfig(**extra),
                            device="cpu")


def shared_prefix_requests(mod, n, *, prefix_len=70, n_prefixes=2,
                           max_new=4, seed=3, tail=(2, 12)):
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(2, 512, size=prefix_len)
                for _ in range(n_prefixes)]
    reqs = []
    for i in range(n):
        pre = prefixes[int(rng.integers(0, n_prefixes))]
        t = rng.integers(2, 512, size=int(rng.integers(tail[0], tail[1])))
        reqs.append(mod.Request(rid=i, prompt=np.concatenate([pre, t]),
                                max_new_tokens=max_new))
    return reqs


def ecfg(prefix_cache, **kw):
    base = dict(slots=2, max_seq=128, page_size=8, prefill_chunk=16,
                prefix_cache=prefix_cache)
    base.update(kw)
    return base


def _streams(reqs):
    return {r.rid: tuple(r.out_tokens) for r in reqs}


# ---------------------------------------------------------------------------
# BlockAllocator: the same operations, the same answers
# ---------------------------------------------------------------------------

def _observe(fn):
    """fn()'s value, or the exception's type and message."""
    try:
        return ("ok", fn())
    except Exception as e:                      # noqa: BLE001
        return ("raise", type(e).__name__, str(e))


def _alloc_double_free(kvc, _):
    a = kvc.BlockAllocator(8)
    got = a.alloc(3)
    a.free(got)
    return [got, _observe(lambda: a.free([got[0]])), a.free_blocks,
            sorted(a.alloc(7))]


def _alloc_bogus_ids(kvc, _):
    a = kvc.BlockAllocator(8)
    return [_observe(lambda: a.free(ids)) for ids in ([3], [0], [99], [-1])
            ] + [a.free_blocks]


def _alloc_refcounts(kvc, _):
    a = kvc.BlockAllocator(8)
    (b,) = a.alloc(1)
    out = [b]
    a.incref([b])
    out += [a.refcount(b), a.live_blocks, a.shared_blocks]
    a.free([b])
    out += [a.refcount(b), a.free_blocks, a.shared_blocks]
    a.free([b])
    out += [a.refcount(b), a.free_blocks, a.live_blocks,
            _observe(lambda: a.free([b])), _observe(lambda: a.incref([b]))]
    return out


# ---------------------------------------------------------------------------
# RadixCache: the same operations, the same answers
# ---------------------------------------------------------------------------

def _match_view(m):
    return (list(m.blocks), m.tokens_matched, m.cow_src, m.cow_tokens,
            [n.block for n in m.nodes])


def _radix_match_block_aligned(kvc, radix):
    alloc = kvc.BlockAllocator(32)
    cache = radix.RadixCache(alloc, 4)
    toks = np.arange(100, 112)
    blocks = alloc.alloc(3)
    cache.insert(toks, blocks)
    bad = toks.copy()
    bad[5] = 9
    return [_match_view(cache.match(t)) for t in
            (toks, bad, np.array([1, 2, 3]))] + [cache.num_nodes(),
                                                 cache.clock]


def _radix_cow_probe(kvc, radix):
    alloc = kvc.BlockAllocator(32)
    cache = radix.RadixCache(alloc, 4)
    toks = np.arange(100, 108)
    cache.insert(toks, alloc.alloc(2))
    bad = toks[:6].copy()
    bad[5] = 9
    return [_match_view(cache.match(toks[:6])), _match_view(cache.match(bad))]


def _radix_insert_shares(kvc, radix):
    alloc = kvc.BlockAllocator(32)
    cache = radix.RadixCache(alloc, 4)
    toks = np.arange(50, 58)
    blocks = alloc.alloc(2)
    cache.insert(toks, blocks)
    out = [[alloc.refcount(b) for b in blocks]]
    dup = alloc.alloc(2)
    _, walked = cache.insert(toks, dup)
    out += [cache.num_nodes(), [n.block for n in walked],
            [alloc.refcount(b) for b in blocks + dup], alloc.shared_blocks]
    return out


def _radix_cursor_and_pins(kvc, radix):
    alloc = kvc.BlockAllocator(32)
    cache = radix.RadixCache(alloc, 4)
    toks = np.arange(200, 212)
    blocks = alloc.alloc(3)
    tail, w1 = cache.insert(toks[:4], blocks[:1])
    tail, w2 = cache.insert(toks[4:], blocks[1:], node=tail)
    cache.pin(w1 + w2)
    out = [len(w1) + len(w2), _match_view(cache.match(toks))]
    alloc.free(blocks)
    out += [cache.evictable_blocks(), cache.evictable_after_unpin(w1 + w2),
            cache.evict(99), cache.match(toks).tokens_matched]
    cache.unpin(w1 + w2)
    out += [cache.evict(99), cache.match(toks).tokens_matched,
            alloc.free_blocks, cache.evictions]
    return out


def _radix_lru_skips_pinned(kvc, radix):
    alloc = kvc.BlockAllocator(8)
    cache = radix.RadixCache(alloc, 4)
    a = alloc.alloc(2)
    cache.insert(np.arange(0, 8), a)
    b = alloc.alloc(2)
    cache.insert(np.arange(100, 108), b)
    alloc.free(a)
    alloc.free(b)
    m = cache.match(np.arange(100, 108))
    cache.commit(m)
    cache.pin(m.nodes)
    out = [alloc.free_blocks, cache.evictable_blocks(), cache.evict(7),
           alloc.free_blocks, cache.match(np.arange(0, 8)).tokens_matched,
           cache.match(np.arange(100, 108)).tokens_matched]
    cache.unpin(m.nodes)
    out += [cache.evict(7), alloc.free_blocks, cache.evictions, cache.hits,
            cache.misses]
    return out


def _radix_deep_chain(kvc, radix):
    alloc = kvc.BlockAllocator(2002)
    cache = radix.RadixCache(alloc, 1)
    toks = np.arange(2000) % 7
    blocks = alloc.alloc(2000)
    _, walked = cache.insert(toks, blocks)
    alloc.free(blocks)
    return [len(walked), cache.evictable_blocks(), cache.num_nodes(),
            cache.match(toks).tokens_matched, cache.evict(2001),
            alloc.free_blocks]


def _radix_random_ops(kvc, radix):
    """A seeded mix of inserts (shared and fresh prefixes, cursor
    publishes), matches with commits, pins, unpins, frees and evictions."""
    rng = np.random.default_rng(11)
    alloc = kvc.BlockAllocator(64)
    cache = radix.RadixCache(alloc, 4)
    bases = [rng.integers(0, 6, size=40) for _ in range(3)]
    held, pinned, out = [], [], []
    for step in range(120):
        op = int(rng.integers(0, 5))
        base = bases[int(rng.integers(0, 3))]
        n = int(rng.integers(1, 40))
        toks = np.concatenate([base[:n], rng.integers(0, 6, size=3)])
        if op == 0 and alloc.free_blocks >= 10:
            k = len(toks) // 4
            blocks = alloc.alloc(k)
            tail, walked = cache.insert(toks[:k * 4], blocks)
            held.append(blocks)
            out.append(("ins", [w.block for w in walked]))
        elif op == 1:
            m = cache.match(toks)
            cache.commit(m)
            out.append(("match", _match_view(m)))
            if m.nodes and rng.integers(0, 2):
                cache.pin(m.nodes)
                alloc.incref(m.blocks)
                pinned.append((m.nodes, m.blocks))
        elif op == 2 and pinned:
            nodes, blocks = pinned.pop(int(rng.integers(0, len(pinned))))
            cache.unpin(nodes)
            alloc.free(blocks)
        elif op == 3 and held:
            alloc.free(held.pop(0))
        else:
            out.append(("evict", cache.evict(int(rng.integers(0, 64))),
                        cache.evictable_blocks()))
        out.append((alloc.free_blocks, alloc.live_blocks,
                    alloc.shared_blocks, cache.num_nodes(), cache.clock))
    return out


@pytest.mark.parametrize("scenario", [
    _alloc_double_free, _alloc_bogus_ids, _alloc_refcounts,
    _radix_match_block_aligned, _radix_cow_probe, _radix_insert_shares,
    _radix_cursor_and_pins, _radix_lru_skips_pinned, _radix_deep_chain,
    _radix_random_ops], ids=lambda f: f.__name__.lstrip("_"))
def test_host_structures_match_reference(scenario):
    got = {k: scenario(*mods) for k, mods in PKGS.items()}
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# copy_pool_block: bytes equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [16, 8, 4])
def test_copy_pool_block_bytes_match_reference(bits):
    cfg = jget_config(ARCH, smoke=True)
    jpools = jkvc.init_paged_caches(cfg, 9, 8, dtype=jnp.float32,
                                    policy=jkv_policy(bits))
    rng = np.random.default_rng(bits)

    def fill(a):
        if a.dtype == jnp.float32:
            return jnp.asarray(rng.normal(size=a.shape).astype(np.float32))
        return jnp.asarray(rng.integers(-128, 128, size=a.shape)
                           .astype(np.int8))

    jpools = jax.tree.map(fill, jpools)
    tpools = pools_from_reference(jpools, device="cpu")
    want = pools_from_reference(
        jkvc.copy_pool_block(jpools, jnp.int32(2), jnp.int32(6)),
        device="cpu")
    got = tkvc.copy_pool_block(tpools, 2, 6)
    for gp, wp in zip(got[0], want[0]):
        assert type(gp) is type(wp)
        for g, w in zip(gp, wp):
            if torch.is_tensor(g):
                assert g.dtype == w.dtype
                assert g.view(torch.uint8).equal(w.view(torch.uint8))
            else:
                assert g == w


# ---------------------------------------------------------------------------
# Engine: cache-on == cache-off inside the port, bit for bit
# ---------------------------------------------------------------------------

def _slot_prefix_views(eng, slot, ctx):
    """Each layer's (reps, ctx, ...) view of one slot's prompt-context
    payload (and, quantized, its blocks' exponents), read bitwise from the
    pool through the slot's table row."""
    row = torch.from_numpy(eng.block_table[slot, :eng.blocks_per_slot]).long()
    nblk = -(-ctx // eng.ecfg.page_size)
    views = []
    for group in eng.caches:
        for pool in group:
            for buf in pool:
                if not torch.is_tensor(buf):
                    continue
                if buf.dim() == 3:                     # exponent plane
                    views.append(buf[:, row[:nblk]])
                    continue
                dense = buf[:, row].reshape(buf.shape[0], -1,
                                            *buf.shape[3:])
                views.append(dense[:, :ctx])
    return views


@pytest.mark.parametrize("mode", list(MODES))
def test_cache_on_off_streams_and_pools_bit_identical(models, mode):
    """A randomized shared-prefix trace served cache-off and cache-on by the
    port: identical greedy streams; then two requests frozen mid-decode: each
    slot's prompt-context pool bytes identical, and the second admission
    reused the first one's prefix."""
    out = {}
    for on in (False, True):
        eng = _port(models, mode, **ecfg(on))
        reqs = shared_prefix_requests(teng, 8)
        eng.run(reqs)
        out[on] = _streams(reqs)
    assert out[True] == out[False]
    engines = {}
    for on in (False, True):
        eng = _port(models, mode, **ecfg(on))
        for r in shared_prefix_requests(teng, 2, max_new=40, seed=11,
                                        n_prefixes=1):
            eng.submit(r)
        for _ in range(30):
            eng.step()
        eng._drain()
        assert all(rs is not None and not rs.pending_chunks
                   for rs in eng.slot_req)
        engines[on] = eng
    for slot in range(2):
        on, off = engines[True], engines[False]
        assert on.slot_req[slot].rid == off.slot_req[slot].rid
        ctx = on.slot_req[slot].prefill_ctx
        for a, b in zip(_slot_prefix_views(on, slot, ctx),
                        _slot_prefix_views(off, slot, ctx)):
            assert a.view(torch.uint8).equal(b.view(torch.uint8))
    assert engines[True].slot_req[1].cached_prefix_tokens > 0


COUNTERS = ("prefill_tokens", "cached_prefix_tokens", "prefix_hit_rate",
            "preempted", "hol_skips", "evictions", "prefix_cache_hits",
            "prefix_cache_misses", "prefix_cache_nodes", "admitted",
            "cached_prefix_tokens_per_request", "prefill_tokens_per_request")


@pytest.mark.parametrize("mode", list(MODES))
def test_shared_prefix_trace_matches_reference(models, mode):
    """The shared-prefix trace with the cache on: streams, prefill tokens
    computed and cached, hit rate, preemptions and the trie's counters equal
    the reference engine's."""
    je, te = _engines(models, mode, **ecfg(True))
    jr, tr = shared_prefix_requests(jeng, 8), shared_prefix_requests(teng, 8)
    je.run(jr)
    te.run(tr)
    assert _streams(tr) == _streams(jr)
    jm, tm = je.metrics(), te.metrics()
    assert {k: tm[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert tm["cached_prefix_tokens"] > 0 and tm["prefix_cache"] is True
    assert te.allocator.free_blocks == je.allocator.free_blocks


# ---------------------------------------------------------------------------
# Engine scenarios against the reference engine
# ---------------------------------------------------------------------------

def _resubmit(mod, eng):
    p = np.random.default_rng(0).integers(2, 512, size=66)
    r1 = mod.Request(rid=0, prompt=p, max_new_tokens=4)
    eng.run([r1])
    r2 = mod.Request(rid=1, prompt=p, max_new_tokens=4)
    eng.run([r2])
    rs2 = eng.scheduler.finished[-1]
    # ctx = 65: 64 grid-aligned tokens cached, one suffix chunk computed
    assert (rs2.cached_prefix_tokens, rs2.computed_prefill_tokens) == (64, 1)
    assert r1.out_tokens == r2.out_tokens
    return [r1, r2]


def _cow(mod, eng):
    donor = np.random.default_rng(1).integers(2, 512, size=53)
    reqs = [mod.Request(rid=0, prompt=donor, max_new_tokens=4),
            mod.Request(rid=1, prompt=donor[:44], max_new_tokens=4),
            mod.Request(rid=2, prompt=donor, max_new_tokens=4)]
    for r in reqs:
        eng.run([r])
    # the donor's cached block survives the borrower's decode writes
    assert reqs[2].out_tokens == reqs[0].out_tokens
    return reqs


def _churn(mod, eng):
    rng = np.random.default_rng(2)
    prefixes = [rng.integers(2, 512, size=30) for _ in range(4)]
    reqs = [mod.Request(rid=i, prompt=np.concatenate(
        [prefixes[i % 4], rng.integers(2, 512, size=3)]), max_new_tokens=3)
        for i in range(12)]
    assert len(eng.run(reqs)) == 12
    # nothing leaked: cache refs + the free list account for every block
    assert eng.allocator.free_blocks + eng.allocator.live_blocks == 16
    return reqs


def _overcommit(mod, eng):
    rng = np.random.default_rng(6)
    warm = mod.Request(rid=0, prompt=rng.integers(2, 512, size=33),
                       max_new_tokens=3)
    eng.run([warm])
    assert eng.allocator.live_blocks == 4        # cache-held, evictable
    # two picks in one tick, each needing 7 of the 12 usable blocks: both
    # pass can_admit (8 free + 4 evictable), only one can land; the other
    # is requeued, never over-allocated
    reqs = [mod.Request(rid=1 + i, prompt=rng.integers(2, 512, size=50),
                        max_new_tokens=3) for i in range(2)]
    assert len(eng.run(reqs)) == 2
    ticks = {rs.rid: rs.admit_tick for rs in eng.scheduler.finished}
    assert ticks[1] != ticks[2]
    assert eng.radix.hits + eng.radix.misses == 3
    return [warm] + reqs


def _interleave(mod, eng):
    rng = np.random.default_rng(4)
    reqs = [mod.Request(rid=0, prompt=rng.integers(2, 512, size=200),
                        max_new_tokens=2),
            mod.Request(rid=1, prompt=rng.integers(2, 512, size=5),
                        max_new_tokens=2)]
    eng.run(reqs)
    # admitted together; the short one finishes while the long prompt is
    # still working through its chunk grants
    assert [rs.rid for rs in eng.scheduler.finished] == [1, 0]
    return reqs


SCENARIOS = {
    "identical_resubmit": (_resubmit, "float", ecfg(True, slots=1)),
    "cow_partial_block": (_cow, "float", ecfg(True, slots=1)),
    "cow_refused_at_kv4": (_cow, "kv4", ecfg(True, slots=1)),
    "eviction_churn": (_churn, "float", ecfg(True, max_seq=64,
                                             num_blocks=17)),
    "same_tick_overcommit": (_overcommit, "float", ecfg(
        True, max_seq=64, num_blocks=13, policy="prefill")),
    "chunked_prefill_interleaves": (_interleave, "float", dict(
        slots=2, max_seq=256, page_size=8, prefill_chunk=16,
        policy="prefill")),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_scenarios_match_reference(models, name):
    """The reference's prefix-cache scenarios run on both engines: the same
    streams, per-request cached / computed prefill tokens, admission ticks,
    evictions and pool occupancy (and each scenario's own assertions hold
    on both)."""
    fn, mode, kw = SCENARIOS[name]
    je, te = _engines(models, mode, **kw)
    jr, tr = fn(jeng, je), fn(teng, te)
    assert _streams(tr) == _streams(jr)

    def recs(eng):
        return [(rs.rid, rs.admit_tick, rs.finish_tick, rs.finish_reason,
                 rs.cached_prefix_tokens, rs.computed_prefill_tokens)
                for rs in eng.scheduler.finished]
    assert recs(te) == recs(je)
    jm, tm = je.metrics(), te.metrics()
    assert ({k: tm.get(k) for k in COUNTERS}
            == {k: jm.get(k) for k in COUNTERS})
    assert te.allocator.free_blocks == je.allocator.free_blocks
    if name == "cow_partial_block":
        assert te.scheduler.finished[1].cached_prefix_tokens == 43
    if name == "cow_refused_at_kv4":
        # no partial-block copy on packed pools: reuse rounds to the grid
        assert te.scheduler.finished[1].cached_prefix_tokens == 32
    if name == "eviction_churn":
        assert tm["evictions"] > 0


def test_cow_stream_equals_cache_off(models):
    """The borrower of a copy-on-write block decodes exactly as with the
    cache off."""
    out = {}
    for on in (False, True):
        eng = _port(models, "float", **ecfg(on, slots=1))
        out[on] = _streams(_cow(teng, eng))
    assert out[True] == out[False]


def test_prefix_cache_metrics_and_config_errors(models):
    eng = _port(models, "float", **ecfg(True))
    eng.run(shared_prefix_requests(teng, 6))
    m = eng.metrics()
    assert m["prefix_cache"] is True and m["cached_prefix_tokens"] > 0
    assert 0.0 < m["prefix_hit_rate"] < 1.0 and m["evictions"] == 0
    assert m["prefix_cache_hits"] > 0
    assert m["cached_prefix_tokens_per_request"] > 0
    off = _port(models, "float", **ecfg(False))
    off.run(shared_prefix_requests(teng, 6))
    mo = off.metrics()
    assert mo["prefix_hit_rate"] == 0.0 and mo["cached_prefix_tokens"] == 0
    assert "prefix_cache_hits" not in mo
    with pytest.raises(ValueError, match="prefill_chunk"):
        _port(models, "float", slots=1, max_seq=64, page_size=16,
              prefill_chunk=24)
    with pytest.raises(ValueError, match="budget"):
        _port(models, "float", slots=1, max_seq=64, prefill_chunk=32,
              prefill_token_budget=16)
    with pytest.raises(ValueError, match="preempt_after_ticks"):
        _port(models, "float", slots=1, max_seq=64, preempt_after_ticks=0)
