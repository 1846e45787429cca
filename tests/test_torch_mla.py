"""PyTorch port vs the JAX reference: Multi-head Latent Attention
(deepseek-v3) on the dense backend.

apply_mla (the expanded prefill form: v zero-padded to q's head_dim 48 at
smoke size, so on the card it runs the flash kernel's mma.sync path, and
its latent cache), decode_mla (the absorbed form over the latent cache) and
mla_decode_attention against the reference's; deepseek-smoke's bucketed
prefill then decode, and its engine streams. f32 on the CPU, within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401
from torch_dense_common import (assert_caches_close, model, serve,  # noqa: E402
                                t)

import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn.rope import apply_rope as japply_rope  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn.rope import rope_tables  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attn_params(layer=0):
    """The first layer's MLA parameters, reference and port."""
    jcfg, jp, tcfg, tp = model(ARCH)
    jattn_p = {k: v[layer] for k, v in jp["group0"]["l0"]["attn"].items()}
    return jcfg, jattn_p, tcfg, tp["group0"][layer]["l0"]["attn"]


def _rope(tcfg, positions):
    return rope_tables(t(positions), tcfg.mla.qk_rope_dim, tcfg.rope_theta)


@pytest.mark.parametrize("s", [1, 9, 24])
def test_apply_mla_and_its_cache_match_reference(s):
    jcfg, jp, tcfg, tp = _attn_params()
    x = np.random.default_rng(s).standard_normal((2, s, 128)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    jc = jattn.MLACache(jnp.zeros((2, 32, 32)), jnp.zeros((2, 32, 16)),
                        jnp.zeros((2,), jnp.int32))
    jo, jc = jblocks.apply_mla(jp, jnp.asarray(x), jcfg,
                               positions=jnp.asarray(pos), cache=jc,
                               q_chunk=8, kv_chunk=8)
    tc = tattn.MLACache(torch.zeros(2, 32, 32), torch.zeros(2, 32, 16),
                        torch.zeros(2, dtype=torch.int32))
    to, tc = tblocks.apply_mla(tp, t(x), tcfg, rope=_rope(tcfg, pos),
                               cache=tc, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert_caches_close(((jc,),), ((tc,),))


def test_mla_decode_attention_matches_reference():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q_abs, q_rope = f(3, 1, 4, 32), f(3, 1, 4, 16)
    ckv, k_rope = f(3, 20, 32), f(3, 20, 16)
    length = np.array([1, 7, 20], np.int32)
    jo = jattn.mla_decode_attention(
        jnp.asarray(q_abs), jnp.asarray(q_rope),
        jattn.MLACache(jnp.asarray(ckv), jnp.asarray(k_rope),
                       jnp.asarray(length)), scale=0.2)
    to = tattn.mla_decode_attention(
        t(q_abs), t(q_rope), tattn.MLACache(t(ckv), t(k_rope), t(length)),
        scale=0.2)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_decode_mla_matches_reference():
    """Three absorbed-form decode steps after a 5-token prefill: outputs,
    the latent cache and its lengths (written in place in the port)."""
    jcfg, jp, tcfg, tp = _attn_params()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    jc = jattn.MLACache(jnp.zeros((2, 16, 32)), jnp.zeros((2, 16, 16)),
                        jnp.zeros((2,), jnp.int32))
    _, jc = jblocks.apply_mla(jp, jnp.asarray(x[:, :5]), jcfg,
                              positions=jnp.asarray(pos), cache=jc)
    tc = tattn.MLACache(torch.zeros(2, 16, 32), torch.zeros(2, 16, 16),
                        torch.zeros(2, dtype=torch.int32))
    _, tc = tblocks.apply_mla(tp, t(x[:, :5]), tcfg, rope=_rope(tcfg, pos),
                              cache=tc)
    for i in range(5, 8):
        jo, jc = jblocks.decode_mla(jp, jnp.asarray(x[:, i:i + 1]), jcfg,
                                    cache=jc)
        tpos = tc.length[:, None].numpy()
        to, tc = tblocks.decode_mla(tp, t(x[:, i:i + 1]), tcfg,
                                    rope=_rope(tcfg, tpos), cache=tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        assert_caches_close(((jc,),), ((tc,),))


def test_rope_on_mla_width_matches_reference():
    """The port rotates MLA's q and k rope parts with tables built at the
    rope width (qk_rope_dim), as apply_rope does on them."""
    _, _, tcfg, _ = _attn_params()
    x = np.random.default_rng(1).standard_normal((2, 6, 4, 16)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(3, 9, dtype=np.int32), (2, 6))
    from repro_torch.nn.rope import rotate
    got = rotate(t(x), *_rope(tcfg, pos)).numpy()
    want = np.asarray(japply_rope(jnp.asarray(x), jnp.asarray(pos),
                                  tcfg.rope_theta))
    np.testing.assert_allclose(got, want, **TOL)


def test_deepseek_prefill_then_decode_matches_reference():
    """deepseek-smoke (one dense layer, two MoE layers at full capacity):
    bucket-padded prefill with true lengths 11 and 16, every cache leaf,
    then two decode steps."""
    jcfg, jp, tcfg, tp = model(ARCH)
    toks = np.random.default_rng(2).integers(
        2, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    tl = np.array([11, 16], np.int32)
    jlog, jc = jlm.prefill_step(
        jp, jcfg, jnp.asarray(toks),
        jlm.init_caches(jcfg, 2, 24, dtype=jnp.float32),
        true_length=jnp.asarray(tl))
    tlog, tc = tlm.prefill_step(
        tp, tcfg, t(toks),
        tlm.init_caches(tcfg, 2, 24, dtype=torch.float32, device="cpu"),
        true_length=t(tl))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for step in range(2):
        nxt = np.array([[3 + step], [7 + step]], np.int32)
        jd, jc = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        td, tc = tlm.decode_step(tp, tcfg, t(nxt), tc)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    # the prefill wrote 24-position buffers; bucket rows past 16 are zero
    jc = jlm.init_caches(jcfg, 2, 24, dtype=jnp.float32)
    _, jc = jlm.prefill_step(jp, jcfg, jnp.asarray(toks), jc,
                             true_length=jnp.asarray(tl))
    tc = tlm.init_caches(tcfg, 2, 24, dtype=torch.float32, device="cpu")
    _, tc = tlm.prefill_step(tp, tcfg, t(toks), tc, true_length=t(tl))
    assert_caches_close(jc, tc)


def test_deepseek_engine_streams_match_reference():
    """deepseek-smoke on the dense engine: greedy and sampled streams equal
    the reference's."""
    lens = [2, 9, 17, 40, 70]
    ref = serve("ref", ARCH, lens)
    assert serve("port", ARCH, lens) == ref
