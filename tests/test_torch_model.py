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


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma-7b"])
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
    conv = from_reference(jparams, tcfg)
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


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma-7b"])
@pytest.mark.parametrize("grau", [False, True])
def test_paged_prefill_and_decode_logits_match_reference(arch, grau):
    jcfg, tcfg = _configs(arch, grau)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = from_reference(jparams, tcfg)
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
