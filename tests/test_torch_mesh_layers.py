"""PyTorch port vs the JAX reference: the serving mesh over every layer kind
— Mixture-of-Experts (by experts), MLA (by heads, the latent cache
replicated), Mamba-2 (by SSM head), Whisper's encoder and cross-attention
(by heads) and LLaVA's vision prefix (a replicated input) — on the model
axis, the data axis and both (the counterparts of tests/test_sharding.py's
cases, which the reference runs on every arch).

The port runs one process a rank (launch/mesh.spawn_ranks, gloo on the
CPU): one spawn a mesh shape, every case of the file served by it
(tests/torch_layer_ranks.py); the reference runs unsharded in this process.
Checks, f32 at smoke size, for llama4-smoke (paged), deepseek-smoke,
mamba2-smoke, jamba-smoke and whisper-smoke (dense) at (1, 2), (2, 1) and
(2, 2):

  * greedy streams under mixed submit / poll traffic: the reference's
    unsharded engine's, bit for bit, on every rank;
  * dense prefill and first-decode logits within 1e-4 of the reference's;
  * each rank's caches within 1e-4 of the reference engine's, sliced by
    sharding.place_dense_caches / place_paged_pools (the null block
    included), and every data rank's pool bytes equal;
  * an MoE layer at a tight capacity over a data-sharded batch drops
    exactly the unsharded layer's slots (the routing is the whole
    batch's); a Mamba-2 mixer whose heads the axis does not divide is
    replicated and serves the reference's streams; LLaVA's patch-embedding
    forward, a Whisper request through the front door and
    recover(mesh=, encoder_frames=) at (1, 2); the launcher's --mesh 1x2
    on each arch; draw_shard against the whole draw sharded (and packed at
    int4), and an int4 engine handed a sharding.Draw against one built
    from the whole draw; every registered arch placed at every shape.

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

import torch_layer_ranks as L  # noqa: E402
import torch_shard_ranks as R  # noqa: E402
from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs.archs import ARCHS as TARCHS  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import (caches_from_reference,  # noqa: E402
                                        from_reference,
                                        pools_from_reference)
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.nn.common import tree_flatten  # noqa: E402
from repro_torch.quant import weights as wq  # noqa: E402
from repro_torch.quant.policy import PrecisionPolicy  # noqa: E402
from repro_torch.serve import sharding  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
JOIN_S = 240.0
SHAPES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
ARCHS = {"llama4": "llama4-maverick-400b-a17b", "deepseek": "deepseek-v3-671b",
         "mamba2": "mamba2-1.3b", "jamba": "jamba-v0.1-52b",
         "whisper": "whisper-medium"}
DROP_CAPACITY = 1     # 8 rows top-1 over 4 experts: some expert overflows
DRAW_SEED = 3


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


def _configs(arch):
    """(reference cfg, port cfg): an arch's smoke config, or "mamba2-h5":
    mamba2-smoke at d_model 80, whose 5 SSM heads no even axis divides."""
    if arch == "mamba2-h5":
        return (jget_config("mamba2-1.3b", smoke=True).replace(d_model=80),
                tget_config("mamba2-1.3b", smoke=True).replace(d_model=80))
    return jget_config(arch, smoke=True), tget_config(arch, smoke=True)


@functools.lru_cache(maxsize=None)
def models(arch):
    """(reference cfg, reference f32 params, port cfg, port params)."""
    jcfg, tcfg = _configs(arch)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jparams, tcfg, from_reference(jparams, tcfg, device="cpu")


def _tokens(cfg):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 2,
                                         cfg.vocab_size), np.int64)


def _frames(cfg):
    f = L.frames_for(cfg, 2, seed=9)
    return None if f[0] is None else np.stack(f)


def _patches(cfg):
    rng = np.random.default_rng(4)
    return (0.02 * rng.standard_normal((2, 6, cfg.d_model))).astype(
        np.float32)


def _drop_rows(cfg):
    rng = np.random.default_rng(3)
    return rng.standard_normal((8, 1, cfg.d_model)).astype(np.float32)


def _jobs(shape, arch):
    cfg = models(arch)[2]
    jobs = {"engine": {"kind": "engine"},
            "logits": {"kind": "logits", "tokens": _tokens(cfg),
                       "frames": _frames(cfg)}}
    if arch == ARCHS["llama4"] and SHAPES[shape][0] > 1:
        jobs["drops"] = {"kind": "drops", "x": _drop_rows(cfg),
                         "capacity": DROP_CAPACITY}
    return jobs


def _extra_cases(tmp_path_factory):
    """(1, 2)'s cases beyond the five archs: the Mamba-2 mixer whose heads
    the axis does not divide, LLaVA's vision prefix, and Whisper's front
    door and recovery (from a journal an unsharded engine crashed on)."""
    h5 = models("mamba2-h5")[2]
    llava = models("llava-next-mistral-7b")[2]
    _, _, wcfg, wparams = models(ARCHS["whisper"])
    journal = str(tmp_path_factory.mktemp("layers") / "whisper.journal")
    L.crash_journal(wcfg, wparams, journal, tick=5)
    return [("mamba2-h5", h5, models("mamba2-h5")[3], {
                "engine": {"kind": "engine"},
                "logits": {"kind": "logits", "tokens": _tokens(h5)}}),
            ("llava", llava, models("llava-next-mistral-7b")[3], {
                "vision": {"kind": "vision", "tokens": _tokens(llava),
                           "patches": _patches(llava)}}),
            ("whisper-door", wcfg, wparams, {
                "frontdoor": {"kind": "frontdoor"},
                "recover": {"kind": "recover", "journal": journal}}),
            ("drawn-int4", models(ARCHS["llama4"])[2], _drawn(),
             {"drawn": {"kind": "drawn", "seed": DRAW_SEED, "bits": 4}})]


def _drawn():
    """llama4-smoke's lm.init_lm draw from DRAW_SEED, f32."""
    return tlm.init_lm(models(ARCHS["llama4"])[2], seed=DRAW_SEED,
                       dtype=torch.float32, device="cpu")


_SPAWNED = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def get(shape):
        if shape not in _SPAWNED:
            d, m = SHAPES[shape]
            work = [(arch, models(arch)[2], models(arch)[3],
                     _jobs(shape, arch)) for arch in ARCHS.values()]
            if shape == "1x2":
                work += _extra_cases(tmp_path_factory)
            _SPAWNED[shape] = tmesh.spawn_ranks(
                L.run_layers, d * m, args=((d, m), work), threads=1,
                join_s=JOIN_S)
        return _SPAWNED[shape]
    return get


@functools.lru_cache(maxsize=None)
def reference_engine(arch):
    """The reference's unsharded engine on requests(): {rid: tokens} and
    its final caches (or pools) in the port's layout."""
    jcfg, jparams, tcfg, _ = models(arch)
    kw = dict(slots=L.SLOTS, max_seq=L.MAX_SEQ, telemetry=False)
    if arch == ARCHS["llama4"]:
        kw["paged_impl"] = "gather"
    eng = jeng.ServeEngine(jcfg, jparams, jeng.EngineConfig(**kw))
    out = R.mixed_traffic(eng, L.requests(tcfg, request_cls=jeng.Request))
    conv = pools_from_reference if eng.paged else caches_from_reference
    return ({rid: toks for rid, (toks, _) in out.items()},
            conv(eng.caches, device="cpu"))


@functools.lru_cache(maxsize=None)
def reference_logits(arch):
    """The reference's dense prefill of (2, 16) tokens and one decode step:
    (last-position logits, first-decode logits)."""
    jcfg, jparams, tcfg, _ = models(arch)
    toks = jnp.asarray(_tokens(tcfg), jnp.int32)
    b, ctx = toks.shape
    frames = _frames(tcfg)
    frames = None if frames is None else jnp.asarray(frames)
    tl = jnp.full((b,), ctx, jnp.int32)
    caches = jlm.init_caches(jcfg, b, L.MAX_SEQ, dtype=jnp.float32)
    last, caches = jlm.prefill_step(jparams, jcfg, toks, caches,
                                    true_length=tl, q_chunk=8, kv_chunk=8,
                                    encoder_frames=frames)
    nxt = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
    dec, _ = jlm.decode_step(jparams, jcfg, nxt, caches)
    return np.asarray(last), np.asarray(dec)[:, -1]


def _streams(res):
    return {rid: toks for rid, (toks, _) in res["streams"].items()}


CASES = [(s, a) for s in SHAPES for a in ARCHS]
IDS = [f"{s}-{a}" for s, a in CASES]


# ---------------------------------------------------------------------------
# The five archs at every mesh shape (spawned ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_streams_match_reference(shape, arch, ranks):
    """Mixed submit / poll traffic: every rank delivers the reference's
    unsharded engine's greedy streams bit for bit."""
    want, _ = reference_engine(ARCHS[arch])
    for res in ranks(shape):
        assert _streams(res[ARCHS[arch]]["engine"]) == want


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_first_decode_logits_match_reference(shape, arch, ranks):
    """Dense prefill and the first decode step under the mesh (each data
    rank on its rows, an MoE layer's decode routing the gathered batch):
    the reference's unsharded logits within 1e-4, the same bits on every
    rank."""
    want_last, want_dec = reference_logits(ARCHS[arch])
    res = [r[ARCHS[arch]]["logits"] for r in ranks(shape)]
    for r in res:
        np.testing.assert_array_equal(r["last"], res[0]["last"])
        np.testing.assert_array_equal(r["decode"], res[0]["decode"])
    np.testing.assert_allclose(res[0]["last"], want_last, **TOL)
    np.testing.assert_allclose(res[0]["decode"], want_dec, **TOL)


@functools.lru_cache(maxsize=None)
def port_unsharded_caches(arch):
    """The port's unsharded engine's caches (or pools) after requests()."""
    _, _, tcfg, tparams = models(arch)
    eng = L.ServeEngine(tcfg, tparams, L.ecfg(), device="cpu")
    R.mixed_traffic(eng, L.requests(tcfg))
    eng.close()
    return eng.caches


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_caches_are_unsharded_slices(shape, arch, ranks):
    """After the traffic each rank's dense caches (KV heads, the SSM
    state's heads and conv channels, the replicated MLA latent, the cross
    K/V; its data rank's slots) or paged pools (its KV heads, the null
    block included) are the unsharded engine's, sliced by
    place_dense_caches / place_paged_pools, within 1e-4: the reference's,
    but for pools on a mesh with no data axis, whose plain scatter leaves
    other garbage in the null block than the reference's (ROADMAP C4): the
    port's unsharded engine's there. Every data rank of a model column
    holds the same pool bytes."""
    d, m = SHAPES[shape]
    _, ref = reference_engine(ARCHS[arch])
    if d == 1 and ranks(shape)[0][ARCHS[arch]]["engine"]["paged"]:
        ref = port_unsharded_caches(ARCHS[arch])
    cfg = sharding.serving_config(models(ARCHS[arch])[2], m)
    res = [r[ARCHS[arch]]["engine"] for r in ranks(shape)]
    for g, got in enumerate(res):
        place = (sharding.place_paged_pools if got["paged"]
                 else sharding.place_dense_caches)
        want = tree_flatten(place(ref, cfg, FakeMesh(d, m, g // m, g % m)))
        have = tree_flatten(got["caches"])
        assert [p for p, _ in have] == [p for p, _ in want]
        for (path, x), (_, y) in zip(have, want):
            assert x.shape == y.shape, path
            np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL,
                                       err_msg=path)
    if res[0]["paged"]:
        for g in range(d * m):
            assert res[g]["digest"] == res[g % m]["digest"]


@pytest.mark.parametrize("shape", ["2x1", "2x2"])
def test_moe_drops_match_unsharded(shape, ranks):
    """llama4-smoke's MoE layer at capacity 1 over 8 rows, each data rank
    passing its 4 inside split_rows: the unsharded layer's output on all
    8 (the whole batch routed and dropped as one), where routing each
    rank's rows alone would drop other slots."""
    _, _, cfg, params = models(ARCHS["llama4"])
    p = params["group0"][0]["l1"]["moe"]
    x = torch.from_numpy(_drop_rows(cfg))
    act = tlm.make_act(cfg, "cpu")
    want, _ = tmoe.apply_moe(p, x, cfg.moe, act, capacity=DROP_CAPACITY)
    # the drops: the whole batch's, and each half's routed alone
    _, topi, _ = tmoe.route(p, x.reshape(8, -1), cfg.moe)
    whole = tmoe.queue_positions(topi, 4) >= DROP_CAPACITY
    halves = torch.cat([tmoe.queue_positions(topi[i:i + 4], 4)
                        >= DROP_CAPACITY for i in (0, 4)])
    assert whole.any() and not torch.equal(whole, halves)
    alone = torch.cat([tmoe.apply_moe(p, x[i:i + 4], cfg.moe, act,
                                      capacity=DROP_CAPACITY)[0]
                       for i in (0, 4)])
    assert not torch.allclose(alone, want, atol=1e-3)
    for r in ranks(shape):
        np.testing.assert_allclose(r[ARCHS["llama4"]]["drops"]["y"],
                                   want.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# (1, 2)'s other cases
# ---------------------------------------------------------------------------

def test_mamba_heads_not_dividing_are_replicated(ranks):
    """mamba2-smoke at d_model 80 (5 SSM heads) at (1, 2): the mixer is
    replicated whole (every leaf the full tree's) and serves the
    reference's streams and logits."""
    _, _, cfg, params = models("mamba2-h5")
    loc = sharding.place_params(params, cfg, FakeMesh(1, 2, 0, 1))
    full = params["group0"][0]["l0"]["mamba"]
    assert all(loc["group0"][0]["l0"]["mamba"][k] is full[k] for k in full)
    assert sharding.local_caches(cfg, 2) == {"ssm_share": (5, 1)}
    want, _ = reference_engine("mamba2-h5")
    want_last, want_dec = reference_logits("mamba2-h5")
    for r in ranks("1x2"):
        assert _streams(r["mamba2-h5"]["engine"]) == want
        np.testing.assert_allclose(r["mamba2-h5"]["logits"]["decode"],
                                   want_dec, **TOL)
        np.testing.assert_allclose(r["mamba2-h5"]["logits"]["last"],
                                   want_last, **TOL)


def test_vision_prefix_under_mesh(ranks):
    """LLaVA's forward with 6 patch embeddings before 16 tokens at (1, 2):
    the reference's unsharded logits within 1e-4 on every rank."""
    jcfg, jparams, tcfg, _ = models("llava-next-mistral-7b")
    patches = _patches(tcfg)
    want, _, _ = jlm.apply_lm(jparams, jcfg,
                              jnp.asarray(_tokens(tcfg), jnp.int32),
                              patch_embeds=jnp.asarray(patches), q_chunk=8,
                              kv_chunk=8)
    for r in ranks("1x2"):
        got = r["llava"]["vision"]["logits"]
        assert got.shape == (2, 22, tcfg.vocab_size)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_whisper_front_door_under_mesh(ranks):
    """Whisper requests with their frames through the front door on global
    rank 0 at (1, 2): the follower replays each submit with the frames
    that ride the mesh sync, and both ranks finish the reference's
    streams."""
    want, _ = reference_engine(ARCHS["whisper"])
    res = [r["whisper-door"]["frontdoor"] for r in ranks("1x2")]
    assert res[0]["clients"] == want
    assert all(r["engine"] == want for r in res)


def test_recover_with_encoder_frames_under_mesh(ranks):
    """An unsharded engine journals Whisper traffic and dies at tick 5;
    recover(mesh=, encoder_frames=) at (1, 2) ends every stream as the
    reference's uninterrupted run does."""
    want, _ = reference_engine(ARCHS["whisper"])
    for r in ranks("1x2"):
        got = r["whisper-door"]["recover"]["streams"]
        assert got and all(got[rid] == want[rid] for rid in got)


def test_drawn_engine_is_the_tree_engine_int4(ranks):
    """ServeEngine(mesh=) handed a sharding.Draw at weight_bits 4 (the
    launcher's way under a mesh) draws this rank's shard packed by the
    engine's own precision: at (1, 2) every leaf has the bits of the engine
    built from the whole draw, packed leaves among them, and both serve
    the same streams."""
    for r in ranks("1x2"):
        got = r["drawn-int4"]["drawn"]
        assert got["packed"] > 0 and got["same"]
        assert got["drawn"] == got["tree"]


@pytest.mark.parametrize("arch", list(ARCHS.values()))
def test_launcher_mesh_1x2_each_arch(arch, capfd, monkeypatch):
    """`python -m repro_torch.launch.serve --arch <arch> --mesh 1x2 --device
    cpu --dtype float32` prints the unsharded launcher's `rid=` lines
    (whisper's requests with zero frames)."""
    from repro_torch.launch import serve as launch
    spawn = tmesh.spawn_ranks
    monkeypatch.setattr(tmesh, "spawn_ranks", lambda *a, **kw: spawn(
        *a, **{**kw, "join_s": JOIN_S}))
    argv = ["--smoke", "--device", "cpu", "--dtype", "float32", "--arch",
            arch, "--requests", "3", "--slots", "2", "--max-seq", "64",
            "--page-size", "8", "--max-new", "3"]
    launch.main(argv)
    want = [ln for ln in capfd.readouterr().out.splitlines()
            if ln.startswith("rid=")]
    launch.main(argv + ["--mesh", "1x2"])
    out = capfd.readouterr().out
    assert len(want) == 3
    assert [ln for ln in out.splitlines() if ln.startswith("rid=")] == want
    assert '"mesh": "mesh(data=1xmodel=2, devices=2)"' in out


# ---------------------------------------------------------------------------
# Placement (in this process, no process group)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS.values()))
def test_draw_shard_is_the_whole_draw_sharded(arch):
    """sharding.draw_shard (each piece drawn, sliced, the rest freed) gives
    every rank at m = 2 and 3 the bits shard_params gives on init_lm's
    whole draw."""
    cfg = tget_config(arch, smoke=True)
    full = tlm.init_lm(cfg, seed=3, dtype=torch.float32, device="cpu")
    for m in (2, 3):
        for r in range(m):
            mesh = FakeMesh(1, m, 0, r)
            got = tree_flatten(sharding.draw_shard(
                cfg, mesh, sharding.Draw(3, torch.float32), "cpu"))
            want = tree_flatten(sharding.shard_params(
                full, sharding.serving_config(cfg, mesh), mesh))
            assert [p for p, _ in got] == [p for p, _ in want]
            for (path, x), (_, y) in zip(got, want):
                assert torch.equal(x, y), path


@pytest.mark.parametrize("arch", list(ARCHS.values()))
def test_draw_shard_packs_as_the_engine(arch):
    """draw_shard with an int4 engine's pack step gives every rank at
    m = 2 the bits shard_params gives on the whole draw with that pack
    (a drawn shard arrives packed, never re-packed), packed leaves among
    them."""
    cfg = tget_config(arch, smoke=True)
    full = tlm.init_lm(cfg, seed=3, dtype=torch.float32, device="cpu")
    policy = PrecisionPolicy(weight_default_bits=4)
    for r in range(2):
        mesh = FakeMesh(1, 2, 0, r)
        scfg = sharding.serving_config(cfg, mesh)

        def pack(t):
            return wq.pack_params(t, scfg, policy)
        got = tree_flatten(sharding.draw_shard(
            cfg, mesh, sharding.Draw(3, torch.float32), "cpu", pack))
        want = tree_flatten(sharding.shard_params(full, scfg, mesh, pack))
        assert [p for p, _ in got] == [p for p, _ in want]
        assert any(isinstance(x, wq.QuantWeight) for _, x in got)
        for (path, x), (_, y) in zip(got, want):
            if isinstance(x, wq.QuantWeight):
                assert (x.bits, x.caxis, x.kdim, x.tile) == (
                    y.bits, y.caxis, y.kdim, y.tile), path
                assert torch.equal(x.q, y.q) and torch.equal(x.e, y.e), path
            else:
                assert torch.equal(x, y), path


def test_draw_without_mesh_is_refused():
    """A sharding.Draw is drawn a shard at a time under a mesh; an engine
    without one refuses it rather than serving some other tree."""
    cfg = tget_config(ARCHS["mamba2"], smoke=True)
    with pytest.raises(ValueError, match="under a mesh"):
        L.ServeEngine(cfg, sharding.Draw(0, torch.float32), L.ecfg(),
                      device="cpu")


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_every_arch_placed_at_every_shape(arch):
    """No registered arch is refused at (1, 2), (2, 1) or (2, 2): its
    serving config, its ranks' weight slices (every leaf's shares over the
    model axis covering it) and their local cache shapes, which are
    place_dense_caches' slices of the unsharded caches."""
    cfg = tget_config(arch, smoke=True)
    params = tlm.init_lm(cfg, seed=1, dtype=torch.float32, device="cpu")
    total = sum(t.numel() for _, t in tree_flatten(params))
    for d, m in SHAPES.values():
        scfg = sharding.serving_config(cfg, m)
        whole = sum(t.numel() for _, t in tree_flatten(
            sharding.pad_params(params, scfg)))
        assert whole >= total
        shards = [sharding.place_params(sharding.pad_params(params, scfg),
                                        scfg, FakeMesh(d, m, 0, r))
                  for r in range(m)]
        sizes = [{p: t.numel() for p, t in tree_flatten(s)} for s in shards]
        assert all(s.keys() == sizes[0].keys() for s in sizes)
        full = {p: t.numel() for p, t in tree_flatten(
            sharding.pad_params(params, scfg))}
        for p, n in full.items():
            # replicated, split, or (Mamba-2's in_proj and conv: B and C
            # replicated beside the split heads) partly both
            got = [s[p] for s in sizes]
            assert max(got) <= n <= sum(got), (arch, (d, m), p)
        caches = tlm.init_caches(scfg, 2, 16, dtype=torch.float32,
                                 device="cpu",
                                 **sharding.local_caches(scfg, m))
        want = sharding.place_dense_caches(
            tlm.init_caches(scfg, 2, 16, dtype=torch.float32, device="cpu"),
            scfg, FakeMesh(1, m, 0, 0))
        assert [t.shape for _, t in tree_flatten(caches)] == [
            t.shape for _, t in tree_flatten(want)]


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-v0.1-52b",
                                  "whisper-medium"])
def test_place_params_layer_kinds(arch):
    """At (1, 2): MoE experts in halves of E and the shared experts' d_ff
    in halves, the router replicated; MLA's wq_b / wk_b / wv_b / wo by
    heads, wq_a / wkv_a replicated; Mamba-2's in_proj the rank's z, x and
    dt columns with B and C whole, its conv channels and out_proj rows;
    cross-attention and the encoder's attention by heads."""
    cfg = tget_config(arch, smoke=True)
    params = tlm.init_lm(cfg, seed=1, dtype=torch.float32, device="cpu")
    for r in range(2):
        loc = sharding.place_params(params, cfg, FakeMesh(1, 2, 0, r))
        for gi, (period, _) in enumerate(cfg.groups):
            full, got = params[f"group{gi}"][0], loc[f"group{gi}"][0]
            for li, spec in enumerate(period):
                f, g = full[f"l{li}"], got[f"l{li}"]
                if spec.mlp == "moe":
                    e = cfg.moe.num_experts // 2
                    assert torch.equal(g["moe"]["w_up"],
                                       f["moe"]["w_up"][r * e:(r + 1) * e])
                    assert g["moe"]["router"] is f["moe"]["router"]
                    if cfg.moe.num_shared:
                        n = f["moe"]["ws_down"].shape[0] // 2
                        assert torch.equal(g["moe"]["ws_down"],
                                           f["moe"]["ws_down"][r * n:
                                                               (r + 1) * n])
                if spec.kind == "attn" and cfg.mla is not None:
                    h = cfg.num_heads // 2
                    assert torch.equal(g["attn"]["wk_b"], f["attn"]["wk_b"][
                        :, r * h:(r + 1) * h])
                    assert g["attn"]["wq_a"] is f["attn"]["wq_a"]
                if spec.kind == "mamba":
                    s = cfg.ssm
                    di = s.d_inner(cfg.d_model)
                    hl = s.n_heads(cfg.d_model) // 2
                    gn, p = s.n_groups * s.d_state, s.head_dim
                    wi, gi_ = f["mamba"]["in_proj"], g["mamba"]["in_proj"]
                    z = wi[:, r * hl * p:(r + 1) * hl * p]
                    x = wi[:, di + r * hl * p:di + (r + 1) * hl * p]
                    bc = wi[:, 2 * di:2 * di + 2 * gn]
                    dt = wi[:, 2 * di + 2 * gn + r * hl:
                            2 * di + 2 * gn + (r + 1) * hl]
                    assert torch.equal(gi_, torch.cat([z, x, bc, dt], 1))
                    assert torch.equal(g["mamba"]["out_proj"],
                                       f["mamba"]["out_proj"][
                                           r * hl * p:(r + 1) * hl * p])
                if spec.cross_attn:
                    h = cfg.num_heads // 2
                    assert torch.equal(g["xattn"]["wq"], f["xattn"]["wq"][
                        :, r * h:(r + 1) * h])
        if cfg.encoder is not None:
            h = cfg.num_heads // 2
            f = params["encoder"]["layers"][0]["attn"]["wo"]
            assert torch.equal(loc["encoder"]["layers"][0]["attn"]["wo"],
                               f[r * h:(r + 1) * h])
