"""PyTorch port vs the JAX reference: the dense decoder forward on the paged
pool. Parameters come from the reference's `init_lm(PRNGKey(0), f32)`,
converted by `repro_torch.models.convert`; both packages then prefill the
same prompts chunk by chunk through the same block tables and decode
greedily. f32 logits must agree within 1e-4 (float summation order differs
between the frameworks) and the greedy tokens must be identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import GRAUConfig as JGRAUConfig  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.serve import kv_cache as jkvc  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import GRAUConfig as TGRAUConfig  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.serve import kv_cache as tkvc  # noqa: E402

BS, CHUNK, BLOCKS_PER_SLOT = 8, 16, 8
# glm4: a GQA group of 4 at smoke size (16 at full size), head_dim 16, an
# untied head; qwen: MHA with QKV bias and an untied head; llava: served
# text-only; llama4: an MoE layer (full capacity when serving) after a
# dense one, a shared expert
ARCHS = ["llama3.2-3b", "gemma-7b", "glm4-9b", "qwen1.5-32b",
         "llava-next-mistral-7b", "llama4-maverick-400b-a17b"]
NEW_ARCHS = ["llava-next-mistral-7b", "llama4-maverick-400b-a17b"]
# the dense-backend archs: Mamba-2 (SSD), the Mamba/attention/MoE hybrid,
# MLA with MoE, and the encoder-decoder
DENSE_ARCHS = ["mamba2-1.3b", "jamba-v0.1-52b", "deepseek-v3-671b",
               "whisper-medium"]
ALL_ARCHS = ARCHS + DENSE_ARCHS
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, grau):
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    if grau:
        jcfg, tcfg = jcfg.replace(grau=JGRAUConfig()), tcfg.replace(
            grau=TGRAUConfig())
    return jcfg, tcfg


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_match_reference(arch):
    for smoke in (False, True):
        j, t = jget_config(arch, smoke=smoke), tget_config(arch, smoke=smoke)
        for f in ("name", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "head_dim", "activation", "gated_mlp",
                  "qkv_bias", "norm", "norm_eps", "rope_theta",
                  "tie_embeddings", "num_layers"):
            assert getattr(j, f) == getattr(t, f), (arch, smoke, f)


def test_init_lm_layout_matches_reference():
    jcfg, tcfg = _configs("llama3.2-3b", False)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    conv = from_reference(jparams, tcfg, device="cpu")
    mine = tlm.init_lm(tcfg, seed=0, dtype=torch.float32, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(mine) == shapes(conv)
    w = mine["group0"][0]["l0"]["attn"]["wq"]
    # fan-in truncated normal: |w| <= 2 / sqrt(d_model)
    assert float(w.abs().max()) <= 2 / np.sqrt(tcfg.d_model) + 1e-6
    assert float(mine["embed"].abs().max()) <= 0.04 + 1e-6


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grau", [False, True])
def test_paged_prefill_and_decode_logits_match_reference(arch, grau):
    jcfg, tcfg = _configs(arch, grau)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = from_reference(jparams, tcfg, device="cpu")
    jact, tact = jlm.make_act(jcfg), tlm.make_act(tcfg, "cpu")
    nblocks = 2 * BLOCKS_PER_SLOT + 1
    jcaches = jkvc.init_paged_caches(jcfg, nblocks, BS, dtype=jnp.float32)
    tcaches = tkvc.init_paged_caches(tcfg, nblocks, BS, dtype=torch.float32,
                                     device="cpu")
    cols = BLOCKS_PER_SLOT + CHUNK // BS
    table = np.zeros((2, cols), np.int32)
    table[0, :BLOCKS_PER_SLOT] = np.arange(1, 1 + BLOCKS_PER_SLOT)[::-1]
    table[1, :BLOCKS_PER_SLOT] = np.arange(1 + BLOCKS_PER_SLOT, nblocks)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, jcfg.vocab_size, size=n) for n in (21, 9)]
    buckets = tkvc.decode_block_buckets(cols)
    for s, prompt in enumerate(prompts):
        ctx = len(prompt) - 1
        for p0 in tkvc.chunk_starts(0, ctx, CHUNK):
            w = tkvc.chunk_table_width(p0, CHUNK, BS, buckets)
            toks = np.zeros((1, CHUNK), np.int32)
            n = min(ctx - p0, CHUNK)
            toks[0, :n] = prompt[p0:p0 + n]
            row = table[s:s + 1, :w]
            jl, jcaches = jlm.prefill_step(
                jparams, jcfg, jnp.asarray(toks), jcaches, act=jact,
                paged=jattn.PagedState(jnp.asarray(row),
                                       jnp.array([p0], jnp.int32),
                                       jnp.array([ctx], jnp.int32)),
                paged_impl="gather")
            for impl in ("kernel", "gather"):
                tl, _ = tlm.prefill_step(
                    tparams, tcfg, torch.from_numpy(toks), tcaches, act=tact,
                    paged=tattn.PagedState(torch.from_numpy(row),
                                           torch.tensor([p0], dtype=torch.int32)),
                    paged_impl=impl)
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    lengths = np.array([len(p) - 1 for p in prompts], np.int32)
    last = np.array([[p[-1]] for p in prompts], np.int32)
    for step in range(5):
        w = tkvc.bucket_for(tkvc.blocks_for(int(lengths.max()) + 1, BS),
                            tkvc.decode_block_buckets(BLOCKS_PER_SLOT))
        jl, jcaches = jlm.decode_step(
            jparams, jcfg, jnp.asarray(last), jcaches, act=jact,
            paged=jattn.PagedState(jnp.asarray(table[:, :w]),
                                   jnp.asarray(lengths)),
            paged_impl="gather")
        impl = "kernel" if step % 2 else "gather"
        tl, _ = tlm.decode_step(
            tparams, tcfg, torch.from_numpy(last).long(), tcaches, act=tact,
            paged=tattn.PagedState(torch.from_numpy(table[:, :w]),
                                   torch.from_numpy(lengths.copy())),
            paged_impl=impl)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, **TOL)
        jtok = np.argmax(jl[:, -1], axis=-1)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), jtok)
        last = jtok[:, None].astype(np.int32)
        lengths = lengths + 1
    for jpool, tpool in zip(jcaches[0], tcaches[0]):
        np.testing.assert_allclose(tpool.k.numpy(), np.asarray(jpool.k),
                                   **TOL)


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat_leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen1.5-32b"])
@pytest.mark.parametrize("bits", [8, 4])
def test_pack_params_untied_head_matches_reference(arch, bits):
    """The packed tree of the untied-head archs: every leaf's bytes are the
    reference's, the head (d_model, vocab) packed along d_model (caxis -2,
    the logits' contraction) and qwen's QKV biases left in float."""
    from repro.quant import policy as jpol
    from repro.quant import weights as jwq
    from repro_torch.quant import policy as tpol
    from repro_torch.quant import weights as twq
    jcfg, tcfg = _configs(arch, False)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    mine = twq.pack_params(from_reference(jparams, tcfg, device="cpu"), tcfg,
                           tpol.weight_policy(bits))
    theirs = from_reference(jwq.pack_params(jparams, jcfg,
                                            jpol.weight_policy(bits)),
                            tcfg, device="cpu")
    got, want = dict(_flat_leaves(mine)), dict(_flat_leaves(theirs))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert type(g) is type(w), name
        if isinstance(w, twq.QuantWeight):
            assert (g.bits, g.caxis, g.kdim, g.tile) == (
                w.bits, w.caxis, w.kdim, w.tile), name
            assert torch.equal(g.q, w.q) and torch.equal(g.e, w.e), name
        else:
            assert torch.equal(g, w), name
    head = mine["head"]
    assert isinstance(head, twq.QuantWeight) and head.caxis == -2
    assert head.kdim == tcfg.d_model
    assert torch.equal(twq.dense(head), twq.dense(theirs["head"]))
    if tcfg.qkv_bias:
        assert not isinstance(got["group0.0.l0.attn.bq"], twq.QuantWeight)


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen1.5-32b"])
def test_engine_streams_match_reference_new_archs(arch):
    """The port's engine (kernels' plain versions, prefix cache on) and the
    reference engine (gather path) serve the same requests at glm4-smoke
    and qwen-smoke with the same greedy streams, float and with int4
    weights (the untied head packed)."""
    from repro.serve import engine as jeng
    from repro_torch.serve import engine as teng
    jcfg, tcfg = _configs(arch, False)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = from_reference(jparams, tcfg, device="cpu")
    rng = np.random.default_rng(2)
    shared = rng.integers(2, jcfg.vocab_size, size=40)
    prompts = [np.concatenate([shared, rng.integers(2, jcfg.vocab_size,
                                                    size=n)])
               for n in (3, 11, 30)]
    for extra in ({}, {"weight_bits": 4}):
        kw = dict(slots=2, max_seq=96, page_size=8, prefill_chunk=16,
                  prefix_cache=True,
                  **extra)
        je = jeng.ServeEngine(jcfg, jparams, jeng.EngineConfig(
            paged_impl="gather", telemetry=False, **kw))
        te = teng.ServeEngine(tcfg, tparams, teng.EngineConfig(**kw),
                              device="cpu")
        want = {r.rid: r.out_tokens for r in je.run(
            [jeng.Request(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)])}
        got = {r.rid: r.out_tokens for r in te.run(
            [teng.Request(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)])}
        assert got == want
        assert (te.metrics()["cached_prefix_tokens"]
                == je.metrics()["cached_prefix_tokens"] > 0)


def _fields(cfg):
    """Every field of a config, nested dataclasses (MoEConfig, VisionStub,
    LayerSpec in the groups) as plain values."""
    import dataclasses
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                     else v)
            for f in dataclasses.fields(cfg)
            for v in (getattr(cfg, f.name),)
            if f.name != "groups"} | {"groups": [
                ([dataclasses.asdict(spec) for spec in period], reps)
                for period, reps in cfg.groups]}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_new_configs_match_reference_field_for_field(arch):
    """All ten archs, full and smoke: the port has the reference's fields
    and every one equals the reference's (moe, mla, ssm, encoder, vision,
    the layer specs of each group and attn_pad, the tensor-parallel head
    padding, included)."""
    for smoke in (False, True):
        j, t = _fields(jget_config(arch, smoke=smoke)), _fields(
            tget_config(arch, smoke=smoke))
        assert set(j) == set(t), (arch, smoke, set(j) ^ set(t))
        for name, v in t.items():
            assert j[name] == v, (arch, smoke, name)


def test_layer_specs_moe_accepted_the_rest_still_raise():
    """init_layer builds every layer kind with the reference's parameter
    tree (keys and shapes: attention or MLA or Mamba-2, cross-attention,
    a dense, MoE or no MLP); a spec of no known kind still raises; and the
    group builders (moe, dense with cross-attention, jamba, ssm) give the
    reference's layer specs."""
    from repro.nn import blocks as jblocks
    from repro.nn.common import ParamBuilder
    from repro_torch.models.config import (dense_groups, jamba_groups,
                                           moe_groups, ssm_groups)
    from repro_torch.nn import blocks
    gen = torch.Generator().manual_seed(0)

    def shapes(t):
        return ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                else tuple(t.shape))
    for arch, spec in (
            ("llama4-maverick-400b-a17b", ("attn", "moe", False)),
            ("mamba2-1.3b", ("mamba", "none", False)),
            ("jamba-v0.1-52b", ("mamba", "moe", False)),
            ("jamba-v0.1-52b", ("attn", "dense", False)),
            ("deepseek-v3-671b", ("attn", "moe", False)),
            ("whisper-medium", ("attn", "dense", True))):
        cfg, jcfg = tget_config(arch, smoke=True), jget_config(arch,
                                                               smoke=True)
        p = blocks.init_layer(blocks.LayerSpec(*spec), cfg, gen,
                              device="cpu", dtype=torch.float32)
        pb = ParamBuilder(jax.random.PRNGKey(0), jnp.float32)
        jblocks.init_layer(pb, jblocks.LayerSpec(*spec), jcfg)
        assert shapes(p) == jax.tree.map(lambda a: tuple(a.shape),
                                         pb.params), (arch, spec)
    cfg = tget_config("llama3.2-3b", smoke=True)
    for spec in (blocks.LayerSpec("conv", "dense"),
                 blocks.LayerSpec("attn", "sparse")):
        with pytest.raises(ValueError, match="layer spec"):
            blocks.init_layer(spec, cfg, gen, device="cpu",
                              dtype=torch.float32)
    from repro.models.config import moe_groups as jmoe_groups

    from repro.models.config import dense_groups as jdense_groups
    from repro.models.config import jamba_groups as jjamba_groups
    from repro.models.config import ssm_groups as jssm_groups

    def plain(groups):
        return [([(s.kind, s.mlp, s.cross_attn) for s in period], reps)
                for period, reps in groups]
    for args in ((48, 0, 2), (61, 3, 1), (8, 2, 2)):
        assert plain(moe_groups(*args)) == plain(jmoe_groups(*args)), args
    for fn, jfn, args in ((dense_groups, jdense_groups, (24, True)),
                          (jamba_groups, jjamba_groups, (32, 8, 4)),
                          (ssm_groups, jssm_groups, (48,))):
        assert plain(fn(*args)) == plain(jfn(*args)), (fn, args)


def _vision_batch(jcfg, seed=0):
    """The reference's own batch (make_lm_batch_for: tokens, labels and,
    for LLaVA, its patch_embeds) at (2, 24) in f32, as numpy."""
    from repro.configs.shapes import ShapeSpec
    from repro.data.pipeline import make_lm_batch_for
    b = make_lm_batch_for(jcfg, ShapeSpec("t", 24, 2, "train"), 0, seed=seed,
                          dtype=jnp.float32)
    return {k: np.array(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("grau", [False, True])
def test_forward_aux_loss_and_grads_match_reference(arch, grau):
    _check_forward_and_grads(arch, grau)


# jamba-smoke with GRAU is held by test_jamba_grau_forward_loss_and_grads
# below: the element tolerance cannot take its rounding flips
@pytest.mark.parametrize("arch,grau", [(a, False) for a in DENSE_ARCHS] + [
    (a, True) for a in ("mamba2-1.3b", "deepseek-v3-671b", "whisper-medium")])
def test_dense_archs_forward_loss_and_grads_match_reference(arch, grau):
    """As test_forward_aux_loss_and_grads_match_reference, for the
    dense-backend archs (Whisper's encoder reads the batch's
    encoder_frames stub)."""
    _check_forward_and_grads(arch, grau)


def test_jamba_grau_forward_loss_and_grads_match_reference():
    """jamba-smoke with the GRAU apot activation, which slice (k) serves.
    Its 8 layers put ~1e5 GRAU sites after SSD scans and top-2 MoE
    routing, and the frameworks' f32 summation orders round a few of them
    to the neighbouring output level: measured, 3 of the 48 positions move
    (4.7% of the logits beyond 1e-3, at most 0.0128), the other 45 stay
    within 6e-5; loss 2.2e-5 relative; gradient leaves at most 3.6e-3
    relative L2, 1.7e-3 over all of them. A flip moves the positions it
    reaches; a wrong layer moves every position. So: at least 90% of the
    positions within 1e-4 in every logit, every logit within 0.05 and
    argmax equal everywhere, logits within 5e-3 relative L2, aux within
    1e-6, loss within 1e-4 relative, each gradient leaf within 1e-2 and
    all of them together within 5e-3 relative L2."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.nn.common import tree_flatten
    jcfg, tcfg = _configs("jamba-v0.1-52b", True)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = from_reference(jparams, tcfg, device="cpu")
    batch = _vision_batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, _, jaux = jlm.apply_lm(jparams, jcfg, jb["tokens"],
                                    q_chunk=8, kv_chunk=8)
    tlogits, _, taux = tlm.apply_lm(tparams, tcfg, tb["tokens"],
                                    q_chunk=8, kv_chunk=8)
    want, got = np.asarray(jlogits, np.float64), tlogits.numpy()
    diff = np.abs(got - want)
    assert (diff.max(-1) <= 1e-4).mean() >= 0.9
    assert diff.max() <= 0.05
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert np.linalg.norm(got - want) <= 5e-3 * np.linalg.norm(want)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    jloss, jgrads = jax.value_and_grad(lambda p: jlm.lm_loss(
        p, jcfg, jb, q_chunk=8, kv_chunk=8))(jparams)
    tloss, tgrads = tsteps.make_loss_and_grads(
        tcfg, remat="full", q_chunk=8, kv_chunk=8)(tparams, tb)
    assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    wantg = dict(tree_flatten(from_reference(jgrads, tcfg, device="cpu")))
    gotg = dict(tree_flatten(tgrads))
    assert gotg.keys() == wantg.keys()
    num = den = 0.0
    for path, g in gotg.items():
        w = wantg[path].numpy().astype(np.float64)
        d2, w2 = np.sum((g.numpy() - w) ** 2), np.sum(w ** 2)
        assert np.sqrt(d2) <= 1e-2 * max(np.sqrt(w2), 1e-30), path
        num, den = num + d2, den + w2
    assert np.sqrt(num) <= 5e-3 * np.sqrt(den)


def _check_forward_and_grads(arch, grau):
    """The training forward (logits and the router's aux loss), lm_loss
    (the vision prefix carries no labels; + aux) and its gradient through
    autograd against the reference's jax.value_and_grad: loss within 1e-5
    relative, every gradient leaf within a relative L2 of 1e-4 (1e-3 with
    GRAU, whose rounding steps move an activation by s_out)."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.nn.common import tree_flatten
    jcfg, tcfg = _configs(arch, grau)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = from_reference(jparams, tcfg, device="cpu")
    batch = _vision_batch(jcfg)
    assert ("patch_embeds" in batch) == (jcfg.vision is not None)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert ("encoder_frames" in batch) == (jcfg.encoder is not None)
    jlogits, _, jaux = jlm.apply_lm(jparams, jcfg, jb["tokens"],
                                    patch_embeds=jb.get("patch_embeds"),
                                    encoder_frames=jb.get("encoder_frames"),
                                    q_chunk=8, kv_chunk=8)
    tlogits, _, taux = tlm.apply_lm(tparams, tcfg, tb["tokens"],
                                    patch_embeds=tb.get("patch_embeds"),
                                    encoder_frames=tb.get("encoder_frames"),
                                    q_chunk=8, kv_chunk=8)
    tol = 1e-3 if grau else 1e-4
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=tol, atol=tol)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    if jcfg.moe is not None:
        assert float(jaux) > 0
    jloss, jgrads = jax.value_and_grad(lambda p: jlm.lm_loss(
        p, jcfg, jb, q_chunk=8, kv_chunk=8))(jparams)
    tloss, tgrads = tsteps.make_loss_and_grads(
        tcfg, remat="full", q_chunk=8, kv_chunk=8)(tparams, tb)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = dict(tree_flatten(from_reference(jgrads, tcfg, device="cpu")))
    got = dict(tree_flatten(tgrads))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path].numpy().astype(np.float64)
        err = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= tol, (path, err)


def test_from_reference_carries_the_moe_subtree():
    """llama4-smoke: the reference's stacked MoE leaves (repeats, E, ...)
    unroll into one (E, ...) tree per repeat, leaf for leaf, and the
    port's own init_lm has the same layout."""
    jcfg, tcfg = _configs("llama4-maverick-400b-a17b", False)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    conv = from_reference(jparams, tcfg, device="cpu")
    jmoe = jparams["group0"]["l1"]["moe"]
    for r in range(len(conv["group0"])):
        moe = conv["group0"][r]["l1"]["moe"]
        assert set(moe) == set(jmoe)
        for k, v in moe.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jmoe[k])[r])
        assert "mlp" in conv["group0"][r]["l0"]
    mine = tlm.init_lm(tcfg, seed=0, dtype=torch.float32, device="cpu")
    shapes = lambda t: {k: shapes(v) for k, v in t.items()} if isinstance(  # noqa: E731
        t, dict) else [shapes(v) for v in t] if isinstance(t, list) else (
        tuple(t.shape))
    assert shapes(mine) == shapes(conv)
    w = mine["group0"][0]["l1"]["moe"]["w_gate"]
    assert float(w.abs().max()) <= 2 / np.sqrt(tcfg.moe.num_experts) + 1e-6
