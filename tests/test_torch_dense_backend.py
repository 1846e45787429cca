"""PyTorch port vs the JAX reference: the dense-cache serving backend.

The (slots, max_seq) caches (init_caches, set_cache_lengths), the
bucket-padded one-shot prefill, and ServeEngine(paged=False) — greedy and
sampled streams equal to the reference's dense engine, greedy streams equal
to the port's own paged engine — on llama3-smoke (GQA) and gemma-smoke
(MHA, head_dim 64, GeGLU); the automatic backend choice, every refusal of
the reference's dense backend, and the prefill bucket ladder. f32 on the
CPU; caches and logits within 1e-5, streams exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401
from torch_dense_common import (assert_caches_close, engine, model,  # noqa: E402
                                requests, serve, t)

import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.quant.policy import kv_policy as jkv_policy  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import kv_cache as jkvc  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.quant.policy import kv_policy  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import kv_cache as tkvc  # noqa: E402

ARCHS = ["llama3.2-3b", "gemma-7b"]
LENS = [3, 9, 17, 40, 70]      # contexts in buckets 16, 16, 16, 64, 128


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS + ["deepseek-v3-671b",
                                          "mamba2-1.3b", "whisper-medium",
                                          "jamba-v0.1-52b"])
def test_init_caches_match_reference(arch):
    """The cache tree (KVCache, MLACache, SSMState, CrossKV pairs): the
    reference's leaves, shapes, dtypes and starting lengths; a quantizing
    policy is refused by both."""
    jcfg, _, tcfg, _ = model(arch)
    jc = jlm.init_caches(jcfg, 3, 24, length=5, dtype=jnp.float32)
    tc = tlm.init_caches(tcfg, 3, 24, length=5, dtype=torch.float32,
                         device="cpu")
    assert_caches_close(jc, tc, tol=0)
    with pytest.raises(ValueError, match="paged backend"):
        jlm.init_caches(jcfg, 1, 8, policy=jkv_policy(8))
    with pytest.raises(ValueError, match="paged backend"):
        tlm.init_caches(tcfg, 1, 8, device="cpu", policy=kv_policy(8))


@pytest.mark.parametrize("arch", ARCHS)
def test_set_cache_lengths_matches_reference(arch):
    jcfg, _, tcfg, _ = model(arch)
    lengths = np.array([4, 11], np.int32)
    jc = jlm.set_cache_lengths(
        jlm.init_caches(jcfg, 2, 16, dtype=jnp.float32), jnp.asarray(lengths))
    tc = tlm.set_cache_lengths(
        tlm.init_caches(tcfg, 2, 16, dtype=torch.float32, device="cpu"),
        t(lengths))
    assert_caches_close(jc, tc, tol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_prefill_matches_reference(arch):
    """prefill_step on a (2, 32) bucket with true lengths 13 and 32: the
    last real position's logits and every cache leaf (the padded tail's
    K/V included; the lengths set to the true ones) within 1e-5, and one
    decode step after it."""
    jcfg, jp, tcfg, tp = model(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(2, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    tl = np.array([13, 32], np.int32)
    jlog, jc = jlm.prefill_step(jp, jcfg, jnp.asarray(toks),
                                jlm.init_caches(jcfg, 2, 32,
                                                dtype=jnp.float32),
                                true_length=jnp.asarray(tl))
    tlog, tc = tlm.prefill_step(tp, tcfg, t(toks),
                                tlm.init_caches(tcfg, 2, 32,
                                                dtype=torch.float32,
                                                device="cpu"),
                                true_length=t(tl))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
    assert_caches_close(jc, tc)
    nxt = np.array([[5], [9]], np.int32)
    jd, jc = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
    td, tc = tlm.decode_step(tp, tcfg, t(nxt), tc)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    assert_caches_close(jc, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engine_streams_match_reference(arch):
    """paged=False on both packages: greedy and sampled streams equal."""
    ref = serve("ref", arch, LENS, paged=False)
    assert serve("port", arch, LENS, paged=False) == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_matches_paged_greedy(arch):
    """The port's dense engine gives its paged engine's greedy streams
    (the reference's test_paged_matches_dense)."""
    dense = serve("port", arch, LENS, sampled=False, paged=False)
    paged = serve("port", arch, LENS, sampled=False, paged=True, page_size=8)
    assert dense == paged


@pytest.mark.parametrize("arch,want", [
    ("llama3.2-3b", "paged"), ("gemma-7b", "paged"),
    ("mamba2-1.3b", "dense"), ("jamba-v0.1-52b", "dense"),
    ("deepseek-v3-671b", "dense"), ("whisper-medium", "dense")])
def test_auto_backend_choice(arch, want):
    """paged=None picks the paged backend wherever the arch allows it, as
    the reference's kv_cache.paged_supported decides; metrics() names it
    and the dense one carries no pool entries."""
    jcfg, _, tcfg, _ = model(arch)
    assert tkvc.paged_supported(tcfg) == jkvc.paged_supported(jcfg) == (
        want == "paged")
    eng = engine("port", arch)
    m = eng.metrics()
    assert m["backend"] == want and eng.paged == (want == "paged")
    assert ("free_blocks" in m) == ("total_blocks" in m) == (want == "paged")
    eng.close()


REFUSALS = [
    ("mamba2-1.3b", dict(paged=True), "paged KV cache unsupported"),
    ("whisper-medium", dict(paged=True), "paged KV cache unsupported"),
    ("llama3.2-3b", dict(paged=False, paged_impl="kernel"),
     "paged_impl requires the paged backend"),
    ("llama3.2-3b", dict(paged=False, attn_grau="grau"),
     "attn_grau epilogue requires the paged backend"),
    ("deepseek-v3-671b", dict(prefix_cache=True),
     "prefix_cache requires the paged backend"),
    ("mamba2-1.3b", dict(kv_bits=8), "requires the paged backend"),
    ("llama3.2-3b", dict(paged=False, prefill_buckets=(16, 64)),
     "does not cover max_seq - 1"),
]


@pytest.mark.parametrize("arch,kw,match", REFUSALS,
                         ids=[f"{a}-{list(k)[-1]}" for a, k, _ in
                              REFUSALS])
def test_dense_backend_refusals(arch, kw, match):
    """Each configuration the reference's dense backend refuses raises the
    same ValueError on both packages."""
    if "attn_grau" in kw:
        from repro.nn.common import build_lm_grau as jgrau
        from repro_torch.nn.common import build_lm_grau as tgrau
    for which in ("ref", "port"):
        kw2 = dict(kw)
        if "attn_grau" in kw:
            kw2["attn_grau"] = (jgrau if which == "ref" else tgrau)(
                "identity")
        with pytest.raises(ValueError, match=match):
            engine(which, arch, **kw2)


def test_exact_length_ssm_engine_needs_no_ladder():
    """An SSM arch prefills at exact length: a ladder that does not cover
    max_seq - 1 is accepted there (nothing is bucketed), as in the
    reference."""
    for which in ("ref", "port"):
        eng = engine(which, "mamba2-1.3b", prefill_buckets=(16,))
        assert not eng.bucketed
        eng.close()


def test_enc_dec_submit_needs_frames():
    for which in ("ref", "port"):
        eng = engine(which, "whisper-medium")
        mod = teng if which == "port" else jeng
        with pytest.raises(ValueError, match="encoder_frames"):
            eng.submit(mod.Request(rid=0, prompt=np.array([3, 4, 5])))
        eng.close()


@pytest.mark.parametrize("max_seq", [64, 160, 448, 2048])
def test_default_bucket_ladder_matches_reference(max_seq):
    """The dense ladder (multiple=1) and the paged one (multiple=16)."""
    for multiple in (1, 16):
        assert (tkvc.default_buckets(max_seq, multiple=multiple)
                == jkvc.default_buckets(max_seq, multiple=multiple))


def test_custom_bucket_ladder_streams_match_reference():
    """A coarse ladder (48, 159): every context pads to one of the two, and
    the streams stay the reference's."""
    kw = dict(paged=False, prefill_buckets=(48, 159))
    ref = serve("ref", "llama3.2-3b", LENS, **kw)
    assert serve("port", "llama3.2-3b", LENS, **kw) == ref
    eng = engine("port", "llama3.2-3b", **kw)
    assert eng.buckets == (48, 159)
    assert eng.warmup() == 3           # one decode tick, two prefills
    assert eng.metrics()["compiles"] == 0
    eng.close()


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "whisper-medium",
                                  "mamba2-1.3b", "jamba-v0.1-52b"])
def test_pack_params_of_the_dense_archs_matches_reference(arch):
    """weight_bits=8 packs what the reference packs and nothing else: GQA
    attention and cross-attention projections and dense MLPs, but no MLA
    leaf (its projections are not the GQA layout), no Mamba or MoE leaf
    and no encoder layer; every leaf's bytes equal the reference's, repeat
    by repeat."""
    from repro.quant import policy as jpol
    from repro.quant import weights as jwq
    from repro_torch.models.convert import from_reference
    from repro_torch.nn.common import tree_flatten
    from repro_torch.quant import policy as tpol
    from repro_torch.quant import weights as twq
    jcfg, jp, tcfg, tp = model(arch)
    mine = twq.pack_params(tp, tcfg, tpol.weight_policy(8))
    theirs = from_reference(jwq.pack_params(jp, jcfg, jpol.weight_policy(8)),
                            tcfg, device="cpu")
    got, want = tree_flatten(mine), tree_flatten(theirs)
    assert [p for p, _ in got] == [p for p, _ in want]
    packed = set()
    for (path, g), (_, w) in zip(got, want):
        assert type(g) is type(w), path
        if isinstance(w, twq.QuantWeight):
            packed.add(path)
            assert (g.bits, g.caxis, g.kdim, g.tile) == (
                w.bits, w.caxis, w.kdim, w.tile), path
            assert torch.equal(g.q, w.q) and torch.equal(g.e, w.e), path
        else:
            assert torch.equal(g, w), path
    assert not any("/mamba/" in p or "/moe/" in p or p.startswith("encoder")
                   for p in packed)
    assert any("/xattn/" in p for p in packed) == (arch == "whisper-medium")
    # GQA self-attention packs (jamba's attention layers, whisper's
    # decoder); MLA's does not, and mamba2 has none
    assert any("/attn/" in p for p in packed) == (
        arch in ("jamba-v0.1-52b", "whisper-medium"))


def test_real_nan_in_a_dense_slot_is_quarantined_and_scrubbed():
    """NaN written into a decoding slot's dense K/V rows: that request
    retires "numeric_error", its co-batched neighbour's stream is the clean
    run's, the slot's rows of every cache leaf hold no NaN afterwards
    (they were zeroed; the idle slot's ghost decode writes finite values),
    and a fresh request admitted into the slot decodes as it would on a
    fresh engine."""
    from repro_torch.nn.common import tree_flatten
    lens = [12, 40]
    want = serve("port", "llama3.2-3b", lens, paged=False, max_new=8)
    eng = engine("port", "llama3.2-3b", paged=False)
    mod_reqs = requests(teng, model("llama3.2-3b")[2], lens, max_new=8)
    for r in mod_reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    eng.poll()
    victim = mod_reqs[0].rid
    slot = next(s for s, rs in enumerate(eng.slot_req)
                if rs is not None and rs.rid == victim)
    # past the context: every decode reads the whole row (0 * NaN)
    eng.caches[0][0].v[:, slot, 100:103] = float("nan")
    done = {r.rid: r for r in eng.run([])}
    reasons = {rs.rid: rs.finish_reason for rs in eng.scheduler.finished}
    assert reasons[victim] == "numeric_error"
    other = mod_reqs[1].rid
    assert done[other].out_tokens == want[other]
    for path, leaf in tree_flatten(eng.caches):
        if leaf.is_floating_point():
            assert torch.isfinite(leaf[:, slot]).all(), path
    fresh = requests(teng, model("llama3.2-3b")[2], [9], max_new=5, seed=3)
    got = eng.run(fresh)[0].out_tokens
    eng.close()
    clean = engine("port", "llama3.2-3b", paged=False)
    again = requests(teng, model("llama3.2-3b")[2], [9], max_new=5, seed=3)
    assert clean.run(again)[0].out_tokens == got
    clean.close()
