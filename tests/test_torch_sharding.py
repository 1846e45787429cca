"""PyTorch port vs the JAX reference: tensor-parallel serving over
torch.distributed (the counterparts of tests/test_sharding.py and of
tests/test_roofline.py::test_pad_heads_inert).

The reference shards one process's devices under GSPMD; the port runs one
process a rank (launch/mesh.spawn_ranks, gloo on the CPU), each holding its
shard of the weights and KV heads, the model code summing and gathering
across ranks. Each (arch, mesh) case spawns its ranks once (module cache)
and runs every job of the case there; the reference runs once per case in
this process. Checks, f32 at smoke size:

  * prefill / decode logits of every case against the reference's
    unsharded ones, rtol = atol = 1e-4 (tests/test_sharding.py's bound),
    and the same bits on every rank;
  * engine streams under the reference test's mixed submit / poll traffic
    (paged, and dense at (1, 2)): equal to the reference's unsharded
    engine for llama3-smoke at (1, 2) and (1, 4), to the port's unsharded
    engine otherwise; pools and dense caches equal (1e-4) to the unsharded
    engine's local slice, block tables and free blocks exactly;
  * cases: llama3-smoke at (1, 2) and (1, 4) (4 heads over 2 KV heads: at
    4 ranks two ranks share a KV head), glm4-smoke at (1, 4) (8 over 2:
    shared), qwen-smoke at (1, 2) (qkv bias), llama3-smoke at (1, 3)
    (heads padded, attn_pad);
  * at (1, 2): int4 weights + int4 KV + the GRAU epilogue, the prefix cache
    on / off, preemption and cancel, sampled streams cut by deadlines that
    rank 0 alone decides, recover() from a journal the unsharded engine
    wrote, the launcher's --mesh 1x2 (and 2x1), snapshot / restore /
    handoff / the front door on the mesh (the other layer kinds under a
    mesh: tests/test_torch_mesh_layers.py).

Every process group here has a 60 s collective timeout and every spawn a
join deadline, so a divergence fails its test instead of hanging the suite.
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
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.steps import pad_heads_for  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.nn.common import tree_flatten  # noqa: E402
from repro_torch.quant import weights as wq  # noqa: E402
from repro_torch.quant.policy import PrecisionPolicy  # noqa: E402
from repro_torch.serve import sharding  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
JOIN_S = 240.0
CASES = {"llama3_m2": ("llama3.2-3b", 2), "llama3_m4": ("llama3.2-3b", 4),
         "glm4_m4": ("glm4-9b", 4), "qwen_m2": ("qwen1.5-32b", 2),
         "llama3_m3": ("llama3.2-3b", 3)}
DEADLINES = {1: 1e-3, 4: 1e-3}      # expire at the first tick boundary


class FakeMesh:
    """A (1, m) mesh's shape and one rank's place, for placement checks in
    this process (no process group)."""
    mesh_dim_names = ("data", "model")

    def __init__(self, m, r):
        self.m, self.r = m, r

    def size(self, i):
        return (1, self.m)[i]

    def get_local_rank(self, name):
        return self.r


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread here (the ranks run one each too): the suite's
    workers share the host's cores."""
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


def _jobs(case, journal=None):
    arch, m = CASES[case]
    cfg = tget_config(arch, smoke=True)
    jobs = {"logits": {"kind": "logits", "tokens": _tokens(cfg)},
            "paged": {"kind": "engine", "pools": True}}
    if case == "llama3_m2":
        jobs.update({
            "dense": {"kind": "engine", "pools": True,
                      "ecfg": {"paged": False}},
            "wq4_kv4_grau": {"kind": "engine", "grau": True,
                             "attn_grau": True,
                             "ecfg": {"weight_bits": 4, "kv_bits": 4}},
            "prefix_on": {"kind": "engine", "shared_prefix": True,
                          "ecfg": {"prefix_cache": True,
                                   "prefill_chunk": 16}},
            "prefix_off": {"kind": "engine", "shared_prefix": True,
                           "ecfg": {"prefill_chunk": 16}},
            "preempt_cancel": {"kind": "engine", "cancel": {5: 2},
                               "ecfg": {"num_blocks": 5,
                                        "preempt_after_ticks": 1,
                                        "page_size": 8}},
            # sampled streams, two of them cut by deadlines that rank 0
            # alone decides
            "sampled_deadline": {"kind": "engine", "sampled": True,
                                 "deadline_ms": DEADLINES,
                                 "skewed_clock": True, "ecfg": {"seed": 3}},
            "recover": {"kind": "recover", "journal": journal},
            "served": {"kind": "served"},
        })
    return jobs


_SPAWNED = {}


def spawned(case, tmp_path_factory=None):
    """Every rank's results of `case`: one spawn serves every case of its
    mesh size (cached)."""
    if case not in _SPAWNED:
        m = CASES[case][1]
        group = [c for c, (_, cm) in CASES.items() if cm == m]
        work = []
        for c in group:
            _, _, tcfg, tparams = models(CASES[c][0])
            journal = None
            jobs = _jobs(c)
            if c == "llama3_m2":
                tmp = tmp_path_factory.mktemp("shard")
                journal = str(tmp / "crash.journal")
                R.crash_journal(tcfg, tparams, journal, tick=6)
                jobs = _jobs(c, journal)
                jobs["served"]["dir"] = str(tmp / "snap")
            work.append((c, tcfg, tparams, jobs))
        res = tmesh.spawn_ranks(R.run_cases, m, args=(m, work), threads=1,
                                join_s=JOIN_S)
        for c in group:
            _SPAWNED[c] = [r[c] for r in res]
    return _SPAWNED[case]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return lambda case: spawned(case, tmp_path_factory)


@functools.lru_cache(maxsize=None)
def unsharded(case):
    """The port's unsharded results of the case's jobs but the journal and
    served ones."""
    arch, _ = CASES[case]
    _, _, tcfg, tparams = models(arch)
    jobs = {k: v for k, v in _jobs(case).items()
            if v["kind"] in ("engine", "logits")}
    return R.unsharded(tcfg, tparams, jobs)


@functools.lru_cache(maxsize=None)
def reference_logits(arch):
    jcfg, jparams, tcfg, _ = models(arch)
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


@functools.lru_cache(maxsize=None)
def reference_streams(paged):
    jcfg, jparams, _, _ = models("llama3.2-3b")
    eng = jeng.ServeEngine(jcfg, jparams, jeng.EngineConfig(
        slots=R.SLOTS, max_seq=R.MAX_SEQ, paged=paged, telemetry=False))
    out = R.mixed_traffic(eng, R.requests(jcfg.vocab_size,
                                          request_cls=jeng.Request))
    return {rid: toks for rid, (toks, _) in out.items()}


def _tensors(caches):
    return [t for group in caches for c in group for t in c
            if torch.is_tensor(t)]


def _streams(res):
    return {rid: toks for rid, (toks, _) in res["streams"].items()}


# ---------------------------------------------------------------------------
# Mesh plumbing
# ---------------------------------------------------------------------------

def test_parse_mesh_spec_matches_reference():
    for spec in ("4", "2x2", " 4X1 ", "1x3", "1"):
        assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)
    for bad in ("", "0", "2x0", "axb", "1x2x3"):
        with pytest.raises(ValueError):
            jmesh.parse_mesh_spec(bad)
        with pytest.raises(ValueError):
            tmesh.parse_mesh_spec(bad)


def test_make_serve_mesh_refusals():
    """Too few ranks (a data axis as a model axis), nccl on the CPU and nccl
    with ranks sharing a card all raise before any process group exists."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_serve_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_serve_mesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        tmesh.make_serve_mesh(1, 1, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="share"):
        tmesh.check_mesh(1, torch.cuda.device_count() + 1,
                         torch.device("cuda"), "nccl")
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        tmesh.spawn_ranks(R.run_cases, 2, device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()


def test_spawn_ranks_fails_when_a_rank_raises():
    """A rank's exception fails the whole call at once (the other rank,
    still running, is stopped)."""
    import time
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank one fails"):
        tmesh.spawn_ranks(R.raise_on_rank_one, 2, threads=1, join_s=60)
    assert time.monotonic() - t0 < 45


def test_spawn_ranks_join_deadline():
    """Ranks still running at the join deadline fail the call with
    TimeoutError and are stopped."""
    with pytest.raises(TimeoutError):
        tmesh.spawn_ranks(R.sleep, 2, threads=1, join_s=4)


# ---------------------------------------------------------------------------
# Head padding
# ---------------------------------------------------------------------------

class _JMesh:
    """The reference's pad_heads_for reads axis names and the device grid's
    shape only."""
    axis_names = ("data", "model")

    def __init__(self, m):
        self.devices = np.zeros((1, m))


@pytest.mark.parametrize("arch,m", [
    ("llama3.2-3b", 3), ("llama3.2-3b", 2), ("qwen1.5-32b", 3),
    ("glm4-9b", 3), ("gemma-7b", 3)])
@pytest.mark.parametrize("smoke", [True, False])
def test_pad_heads_for_keeps_the_group(arch, m, smoke):
    """The port pads KV heads to the next multiple of the axis and query
    heads to the group times that: the heads divide the axis, every real
    query head keeps its KV head, and where the reference's formula keeps
    the group too the two agree (ROADMAP C, D5)."""
    t = tget_config(arch, smoke=smoke)
    j = jsteps.pad_heads_for(jget_config(arch, smoke=smoke), _JMesh(m))
    p = pad_heads_for(t, m)
    h, kv = p.heads_phys, p.kv_heads_phys
    assert h % m == 0 and h // kv == t.num_heads // t.num_kv_heads
    assert h >= t.num_heads and kv >= t.num_kv_heads
    if t.num_heads % m == 0:
        assert p.attn_pad is None and j.attn_pad is None
    elif j.heads_phys // j.kv_heads_phys == t.num_heads // t.num_kv_heads:
        assert p.attn_pad == j.attn_pad


def test_pad_heads_inert_from_reference_tree():
    """The counterpart of test_roofline.py::test_pad_heads_inert: the
    reference's one-layer llama3-smoke tree padded to (8, 4) heads with the
    unpadded weights grafted in, carried by from_reference into a port
    model with attn_pad, gives the reference's unpadded logits (2e-5, the
    reference test's bound); and init_lm zeroes the pad heads."""
    cfg, params, _, _ = models("llama3.2-3b")
    key = jax.random.PRNGKey(0)
    cfg_1 = cfg.replace(groups=((cfg.groups[0][0], 1),))
    pu = dict(params, group0=jax.tree.map(lambda x: x[:1], params["group0"]))
    pp2 = jax.tree.map(np.asarray, pu)
    a_p = pp2["group0"]["l0"]["attn"]
    for k, ax, n in (("wq", 2, 8), ("wk", 2, 4), ("wv", 2, 4), ("wo", 1, 8)):
        pad = [(0, 0)] * a_p[k].ndim
        pad[ax] = (0, n - a_p[k].shape[ax])
        a_p[k] = np.pad(a_p[k], pad)
    toks = jax.random.randint(key, (2, 16), 0, cfg.vocab_size)
    lu, _, _ = jax.jit(lambda p, t: jlm.apply_lm(
        p, cfg_1, t, q_chunk=8, kv_chunk=8))(pu, toks)

    t = tget_config("llama3.2-3b", smoke=True)
    tp = t.replace(groups=((t.groups[0][0], 1),), attn_pad=(8, 4))
    port = from_reference(pp2, tp, device="cpu")
    lp, _, _ = tlm.apply_lm(port, tp, torch.from_numpy(np.array(toks)),
                            q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lu), rtol=2e-5,
                               atol=2e-5)
    fresh = tlm.init_lm(tp, seed=0, dtype=torch.float32, device="cpu")
    attn = fresh["group0"][0]["l0"]["attn"]
    assert attn["wq"].shape[1] == 8 and attn["wk"].shape[1] == 4
    for k, lo in (("wq", 4), ("wk", 2), ("wv", 2)):
        assert not attn[k][:, lo:].any() and attn[k][:, :lo].any()
    assert not attn["wo"][4:].any()


# ---------------------------------------------------------------------------
# Placement (in this process, no process group)
# ---------------------------------------------------------------------------

def test_place_params_slices_packed_planes():
    """int4 llama3-smoke at (1, 2), k-tiles of 64 (the smoke d_ff of 256
    splits on whole tiles): each rank's packed leaves are slices of
    the unsharded packed tree's payload and exponent planes (the bytes the
    card's slice (l) compares), w_down cut on whole k-tiles, and they
    dequantize to the slices of the dequantized tree."""
    _, _, cfg, params = models("llama3.2-3b")
    packed = wq.pack_params(params, cfg, PrecisionPolicy(
        weight_default_bits=4), tile_k=64)
    full = packed["group0"][0]["l0"]
    total = 0
    for r in range(2):
        loc = sharding.place_params(packed, cfg, FakeMesh(2, r))
        layer = loc["group0"][0]["l0"]
        wd, fwd = layer["mlp"]["w_down"], full["mlp"]["w_down"]
        assert wd.kdim == cfg.d_ff // 2 and wd.tile == fwd.tile
        half = fwd.q.shape[0] // 2
        assert torch.equal(wd.q, fwd.q[r * half:(r + 1) * half])
        ke = fwd.e.shape[0] // 2
        assert torch.equal(wd.e, fwd.e[r * ke:(r + 1) * ke])
        assert torch.equal(wq.dense(wd), wq.dense(fwd)[r * 128:(r + 1) * 128])
        wqr = layer["attn"]["wq"]
        assert torch.equal(wqr.q, full["attn"]["wq"].q[:, 2 * r:2 * r + 2])
        assert torch.equal(wq.dense(layer["mlp"]["w_up"]),
                           wq.dense(full["mlp"]["w_up"])[:, r * 128:
                                                         (r + 1) * 128])
        n = cfg.vocab_size // 2
        assert torch.equal(loc["embed"].q, packed["embed"].q[r * n:
                                                             (r + 1) * n])
        total += wq.packed_param_bytes(loc)
    # everything but the norms is split in two
    norms = sum(t.numel() * 4 for k, t in params.items() if k.endswith("_w"))
    norms += sum(t.numel() * 4 for rep in params["group0"]
                 for k, t in rep["l0"].items() if k.endswith("_w"))
    assert total == wq.packed_param_bytes(packed) + norms


def test_place_params_replicates_untiled_w_down():
    """A packed w_down whose d_ff / m is not a multiple of its k-tile is
    replicated with its whole MLP (the reference replicates a packed
    contraction axis); the attention still shards."""
    _, _, cfg, params = models("llama3.2-3b")
    packed = wq.pack_params(params, cfg, PrecisionPolicy(
        weight_default_bits=4), tile_k=128)
    loc = sharding.place_params(packed, cfg, FakeMesh(4, 1))
    layer, full = loc["group0"][0]["l0"], packed["group0"][0]["l0"]
    assert layer["mlp"] is full["mlp"]
    assert layer["attn"]["wq"].q.shape[1] == 1


def _same_leaves(a, b):
    """Two trees with the same structure and the same bits in every leaf
    (packed leaves: planes and attributes)."""
    fa, fb = tree_flatten(a), tree_flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, wq.QuantWeight):
            assert (x.bits, x.caxis, x.kdim, x.tile) == (
                y.bits, y.caxis, y.kdim, y.tile), path
            assert torch.equal(x.q, y.q) and torch.equal(x.e, y.e), path
        else:
            assert torch.equal(x, y), path


@pytest.mark.parametrize("m,bits", [(2, 4), (2, 16), (3, 4)])
def test_shard_params_piecewise_is_the_whole_tree_placement(m, bits):
    """sharding.shard_params, the engine's build from a full tree under a
    mesh (pad, pack and slice one piece at a time), gives every rank the
    bits that pad_params, pack_params and place_params give on the whole
    tree; at (1, 3) with the heads padded."""
    _, _, cfg, params = models("llama3.2-3b")
    cfg = pad_heads_for(cfg, m)
    policy = PrecisionPolicy(weight_default_bits=bits)
    pack = (None if bits == 16 else
            (lambda t: wq.pack_params(t, cfg, policy, tile_k=64)))
    for r in range(m):
        mesh = FakeMesh(m, r)
        whole = sharding.pad_params(params, cfg)
        whole = sharding.place_params(whole if pack is None else pack(whole),
                                      cfg, mesh)
        _same_leaves(sharding.shard_params(params, cfg, mesh, pack),
                     whole)


@pytest.mark.parametrize("arch,m,want", [
    ("llama3.2-3b", 4, [((0, 1), (0, 1)), ((1, 2), (0, 1)),
                        ((2, 3), (1, 2)), ((3, 4), (1, 2))]),
    ("glm4-9b", 4, [((0, 2), (0, 1)), ((2, 4), (0, 1)),
                    ((4, 6), (1, 2)), ((6, 8), (1, 2))]),
    ("llama3.2-3b", 2, [((0, 2), (0, 1)), ((2, 4), (1, 2))])])
def test_head_ranges_share_kv_heads(arch, m, want):
    """Each rank holds the contiguous KV heads its query heads read
    (q // group): with fewer KV heads than ranks, ranks share one."""
    cfg = tget_config(arch, smoke=True)
    assert [sharding.head_ranges(cfg, m, r) for r in range(m)] == want


# ---------------------------------------------------------------------------
# Logits and engine streams under meshes (spawned ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_sharded_logits_match_reference(case, ranks):
    """prefill_step / decode_step through the dense caches under the mesh:
    the reference's unsharded logits within 1e-4, the same bits on every
    rank (llama3_m3 runs with its heads padded)."""
    arch, _ = CASES[case]
    want_last, want_dec = reference_logits(arch)
    res = [r["logits"] for r in ranks(case)]
    for r in res:
        np.testing.assert_array_equal(r["last"], res[0]["last"])
        np.testing.assert_array_equal(r["decode"], res[0]["decode"])
    np.testing.assert_allclose(res[0]["last"], want_last, **TOL)
    np.testing.assert_allclose(res[0]["decode"], want_dec, **TOL)


@pytest.mark.parametrize("case,backend", [
    ("llama3_m2", "paged"), ("llama3_m2", "dense"), ("llama3_m4", "paged"),
    ("glm4_m4", "paged"), ("qwen_m2", "paged"), ("llama3_m3", "paged")])
def test_engine_streams_under_mesh(case, backend, ranks):
    """Mixed submit / poll traffic: every rank delivers the same streams,
    equal to the reference's unsharded engine (llama3-smoke at (1, 2) and
    (1, 4)) or to the port's unsharded engine."""
    res = [_streams(r[backend]) for r in ranks(case)]
    assert all(r == res[0] for r in res)
    want = (reference_streams(backend == "paged")
            if case in ("llama3_m2", "llama3_m4")
            else _streams(unsharded(case)[backend]))
    assert res[0] == want
    assert _streams(unsharded(case)[backend]) == want


@pytest.mark.parametrize("case,backend", [
    ("llama3_m2", "paged"), ("llama3_m4", "paged"), ("glm4_m4", "paged"),
    ("llama3_m3", "paged"), ("llama3_m2", "dense")])
def test_kv_storage_is_the_unsharded_local_slice(case, backend, ranks):
    """After the same traffic each rank's pools (or dense caches) equal the
    unsharded engine's sliced to the rank's KV heads by
    sharding.place_paged_pools / place_dense_caches (1e-4; with padded heads
    the unsharded engine runs the padded config), and the block table and
    free blocks are the unsharded engine's exactly."""
    arch, m = CASES[case]
    _, _, tcfg, tparams = models(arch)
    cfg = pad_heads_for(tcfg, m)
    base = unsharded(case)[backend]
    if cfg.attn_pad is not None:
        base = R.unsharded(cfg, sharding.pad_params(tparams, cfg),
                           {backend: _jobs(case)[backend]})[backend]
    place = (sharding.place_paged_pools if backend == "paged"
             else sharding.place_dense_caches)
    for r, res in enumerate(ranks(case)):
        got = res[backend]
        want = place(base["caches"], cfg, FakeMesh(m, r))
        pairs = list(zip(_tensors(got["caches"]), _tensors(want)))
        assert pairs and len(pairs) == len(_tensors(base["caches"]))
        for g, w in pairs:
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        if backend == "paged":
            np.testing.assert_array_equal(got["block_table"],
                                          base["block_table"])
            assert got["free_blocks"] == base["free_blocks"]


# ---------------------------------------------------------------------------
# Compositions at (1, 2)
# ---------------------------------------------------------------------------

def _same_as_unsharded(ranks, job):
    res = [r[job] for r in ranks("llama3_m2")]
    base = unsharded("llama3_m2")[job]
    for r in res:
        assert r["streams"] == base["streams"], job
    return res, base


def test_wq4_kv4_grau_under_mesh(ranks):
    """int4 weights (the MLP through matmul_wq's plain version) + int4 KV +
    the GRAU MLP and attention epilogue: the unsharded engine's streams on
    every rank, each rank holding fewer packed bytes (at smoke size the
    MLP's d_ff / 2 is not a whole k-tile, so the MLP is replicated)."""
    res, base = _same_as_unsharded(ranks, "wq4_kv4_grau")
    full = base["metrics"]["weight_bytes"]
    for r in res:
        assert r["metrics"]["weight_bytes"] == res[0]["metrics"][
            "weight_bytes"] < full


def test_prefix_cache_on_off_bit_identical_under_mesh(ranks):
    """A shared 24-token prefix: cache on and off give the same streams
    (and the unsharded engine's), with prefix tokens served from cache."""
    on, _ = _same_as_unsharded(ranks, "prefix_on")
    off, _ = _same_as_unsharded(ranks, "prefix_off")
    assert on[0]["streams"] == off[0]["streams"]
    assert on[0]["metrics"]["cached_prefix_tokens"] > 0


def test_preemption_and_cancel_under_mesh(ranks):
    """A 4-block pool preempts, and one request is cancelled mid-flight: the
    same decisions and streams as the unsharded engine on every rank."""
    res, base = _same_as_unsharded(ranks, "preempt_cancel")
    assert base["metrics"]["preempted"] > 0
    assert base["streams"][2][1] == "cancelled"
    assert all(r["metrics"]["preempted"] == base["metrics"]["preempted"]
               for r in res)


def test_sampled_streams_under_mesh(ranks):
    """Greedy, top-k and top-p slots side by side (seed 3): the same draws
    as the unsharded engine (every rank samples the same full logits)."""
    res, _ = _same_as_unsharded(ranks, "sampled_deadline")
    assert sum(len(toks) for toks, _ in res[0]["streams"].values()) > 12


def test_deadlines_decided_by_rank_zero(ranks):
    """Two requests with 1 us deadlines retire with reason "deadline" on
    every rank, the others run out, although rank 1's clock says every
    deadline has passed: rank 0's broadcast decision is the only one read."""
    res, base = _same_as_unsharded(ranks, "sampled_deadline")
    for r in res:
        reasons = {rid: why for rid, (_, why) in r["streams"].items()}
        assert {rid for rid, why in reasons.items()
                if why == "deadline"} == set(DEADLINES)


def test_recover_under_mesh_from_unsharded_journal(ranks):
    """An unsharded engine journals the traffic and dies at tick 6; the
    mesh recovers the journal (rank 0 alone reopens it) and every stream
    ends as the uninterrupted reference run's."""
    want = reference_streams(True)
    res = [r["recover"] for r in ranks("llama3_m2")]
    assert [r["journal_writer"] for r in res] == [True, False]
    for r in res:
        assert r["streams"] and all(r["streams"][rid] == want[rid]
                                    for rid in r["streams"])


@functools.lru_cache(maxsize=None)
def durable_unsharded(snapdir):
    """The port's unsharded engine on tests/torch_mesh_ranks.py's durable
    traffic: the uninterrupted streams and the snapshot payload's request
    records at the served job's point (4 requests), and the uninterrupted
    streams of the front door's 6."""
    _, _, tcfg, tparams = models("llama3.2-3b")
    snap = M._snapshot_job(tcfg, tparams, {"dir": snapdir}, None)
    eng = M.ServeEngine(tcfg, tparams, M._ecfg({}, M.DURABLE_ECFG),
                        device="cpu")
    six = M.streams(eng.run(M.durable_requests(tcfg.vocab_size, n=6)))
    eng.close()
    return snap, six


SERVED = ("snapshot", "restore", "handoff", "handoff_into", "frontdoor")


@pytest.mark.parametrize("what", SERVED)
def test_served_under_mesh(what, ranks, tmp_path_factory):
    """What the (1, 2) mesh serves since the data axis came (these cases
    raised naming A10b before): snapshot() on every rank, global rank 0
    alone writing, the payload's request records the unsharded engine's;
    restore(mesh=) finishing every stream as the unsharded engine does;
    a live handoff to a fresh (1, 2) engine and one from a (2, 1) engine
    over the same ranks, the source draining with every block free (and a
    handoff to an engine of one rank refused); the front door on global
    rank 0 with the other rank following, its streams the unsharded
    engine's but the cancelled one, which keeps a prefix."""
    res = [r["served"] for r in ranks("llama3_m2")]
    snap, six = durable_unsharded(str(tmp_path_factory.mktemp("unsharded")))
    whole = snap["whole"]
    if what == "snapshot":
        assert [r["snapshot"]["saves"] for r in res] == [1, 0]
        assert len({r["snapshot"]["path"] for r in res}) == 1
        for r in res:
            assert r["snapshot"]["requests"] == snap["requests"]
            assert r["snapshot"]["tick"] == snap["tick"]
    elif what == "restore":
        for r in res:
            assert r["snapshot"]["whole"] == whole
            assert r["snapshot"]["streams"] == whole
    elif what in ("handoff", "handoff_into"):
        for r in res:
            h = r[what]
            assert h["streams"] == whole and h["transferred"] > 0
            assert h["health"] == "draining"
            assert h["free_blocks"] == h["usable_blocks"]
        assert "different ranks" in res[0]["handoff_alone"]
    else:
        door = res[0]["frontdoor"]
        for rid, (toks, why) in door["clients"].items():
            if rid == 3 and why == "cancelled":
                assert 4 <= len(toks) < len(six[rid])
                assert toks == six[rid][:len(toks)]
            else:
                assert toks == six[rid], rid
        assert door["max_waiting_seen"] <= 2
        assert res[1]["frontdoor"]["engine"] == door["engine"]


def test_launcher_mesh_1x2(capfd, monkeypatch):
    """`python -m repro_torch.launch.serve --mesh 1x2 --device cpu`: rank 0
    prints the unsharded launcher's streams and the mesh in its metrics;
    so does `--mesh 2x1`, the data axis. (The launcher's ranks run with no
    join deadline, as a server's do; here they get one.)"""
    from repro_torch.launch import serve as launch
    spawn = tmesh.spawn_ranks
    monkeypatch.setattr(tmesh, "spawn_ranks", lambda *a, **kw: spawn(
        *a, **{**kw, "join_s": JOIN_S}))
    argv = ["--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
            "--max-seq", "64", "--page-size", "8", "--max-new", "3"]
    launch.main(argv)
    want = [ln for ln in capfd.readouterr().out.splitlines()
            if ln.startswith("rid=")]
    launch.main(argv + ["--mesh", "1x2"])
    out = capfd.readouterr().out
    got = [ln for ln in out.splitlines() if ln.startswith("rid=")]
    assert len(want) == 3 and got == want
    assert '"mesh": "mesh(data=1xmodel=2, devices=2)"' in out
    launch.main(argv + ["--mesh", "2x1"])
    out = capfd.readouterr().out
    assert [ln for ln in out.splitlines() if ln.startswith("rid=")] == want
    assert '"mesh": "mesh(data=2xmodel=1, devices=2)"' in out


def test_mesh_metrics_and_refused_arch_before_spawn():
    """The mesh summary names each axis; no registered arch is refused
    before a spawn (the placement of every layer kind:
    tests/test_torch_mesh_layers.py)."""
    assert not hasattr(sharding, "check_servable")
    for arch in ("llama4-maverick-400b-a17b", "jamba-v0.1-52b",
                 "mamba2-1.3b", "llava-next-mistral-7b"):
        cfg = tget_config(arch, smoke=True)
        assert sharding.serving_config(cfg, 4).name == cfg.name
    assert sharding.mesh_summary(FakeMesh(4, 0)) == \
        "mesh(data=1xmodel=4, devices=4)"
