"""PyTorch port vs the JAX reference: dense GQA flash attention.

`flash_attention_plain` (the flash kernel's plain version, which a CPU
tensor runs) against the reference's Pallas kernel in interpret mode and
its `chunked_attention`, over the reference kernel test's grid of head
layouts, causal and not: f32 at 3e-5 and bf16 inputs at 2e-2, the
reference tests' own tolerances. lse against a float64 logsumexp. The
port's gradient (`flash_attention_backward`, from the saved lse over tiles)
against `jax.grad` of the reference `chunked_attention` within a relative L2
of 1e-5 in f32, and through `torch.autograd.gradcheck` in float64. Ragged
lengths and queries after a prefix (q_offset) against the reference's
chunked scan, which takes both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.ref import flash_attention_plain  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402

TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, s_q, s_kv, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s_q, h, d)).astype(np.float32),
            rng.normal(size=(b, s_kv, kvh, d)).astype(np.float32),
            rng.normal(size=(b, s_kv, kvh, d)).astype(np.float32))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (6, 3)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_kernel_and_scan(h, kvh, causal):
    q, k, v = _inputs(h * 10 + kvh, 2, 256, 256, h, kvh, 32)
    got, lse = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    kern = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, blocks=(64, 64), interpret=True)
    scan = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, q_chunk=64,
                                   kv_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(scan), **TOL)
    # lse: the row logsumexp of the scaled, masked scores, in float64
    g = h // kvh
    s = np.einsum("bqkgd,bskd->bkgqs", q.astype(np.float64).reshape(
        2, 256, kvh, g, 32), k.astype(np.float64)) * 32 ** -0.5
    if causal:
        s = np.where(np.tril(np.ones((256, 256), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want.reshape(2, h, 256), **TOL)


def test_plain_bf16_matches_reference_kernel():
    q, k, v = _inputs(1, 1, 128, 128, 2, 2, 32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got, _ = tfa.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jflash(jq, jk, jv, blocks=(64, 64), interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("s_q,s_kv,q_offset,causal", [
    (100, 100, 0, True), (77, 77, 0, False), (30, 100, 70, True),
    (48, 200, 152, True)])
def test_ragged_and_q_offset_match_reference_scan(s_q, s_kv, q_offset,
                                                  causal):
    """Lengths that no power-of-two block divides and queries placed after
    a prefix, against the reference's chunked scan (its Pallas kernel
    asserts divisibility by its blocks and has no q_offset); the port's own
    chunked_attention (the plain scan on the CPU) agrees too."""
    q, k, v = _inputs(s_q + s_kv, 2, s_q, s_kv, 6, 2, 64)
    want = np.asarray(jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_chunk=32, kv_chunk=32, q_offset=q_offset))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got, _ = tfa.flash_attention(tq, tk, tv, causal=causal,
                                 q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    scan = tattn.chunked_attention(tq, tk, tv, causal=causal, q_chunk=32,
                                   kv_chunk=32, q_offset=q_offset)
    np.testing.assert_allclose(scan.numpy(), want, **TOL)


@pytest.mark.parametrize("q_offset,s_q", [(0, 256), (64, 192)])
def test_backward_matches_jax_grad_of_chunked_attention(q_offset, s_q):
    """dq, dk, dv of FlashAttention (the plain forward on the CPU, then
    flash_attention_backward from its lse) against jax.grad of the
    reference chunked_attention: b 2, 4 query heads over 2 KV heads, d 32,
    causal, f32, tiles of 64 (and ragged 48 x 40 tiles)."""
    q, k, v = _inputs(3 + q_offset, 2, s_q, 256, 4, 2, 32)
    do = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)

    def f(q, k, v):
        o = jattn.chunked_attention(q, k, v, causal=True, q_chunk=64,
                                    kv_chunk=64, q_offset=q_offset)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    for tiles in ((64, 64), (48, 40)):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        o = tfa.FlashAttention.apply(tq, tk, tv, True, None, q_offset,
                                     *tiles)
        got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
        for name, a, w in zip("qkv", got, want):
            assert _rel_l2(a.numpy(), w) <= 1e-5, (name, tiles)


def test_backward_gradcheck_float64():
    rng = np.random.default_rng(4)
    for causal, off, s_q in ((True, 0, 6), (True, 3, 5), (False, 0, 6)):
        args = [torch.from_numpy(rng.normal(size=shape)).requires_grad_()
                for shape in ((1, s_q, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32))]
        assert torch.autograd.gradcheck(
            lambda q, k, v: tfa.FlashAttention.apply(q, k, v, causal, None,
                                                     off, 4, 3), args)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="head_dim"):      # not in HEAD_DIMS
        tfa.flash_attention(q[..., :40], q[..., :40], q[..., :40])
    with pytest.raises(ValueError, match="one device"):
        tfa.flash_attention(q, q.to("meta"), q)
    with pytest.raises(ValueError, match="head layout"):
        tfa.flash_attention(torch.zeros((1, 8, 3, 64)), q, q)
    with pytest.raises(ValueError, match="q_offset"):
        tfa.flash_attention(q, q, q, q_offset=-1)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.chunked_attention(q, q, q, impl="sdpa")


@pytest.mark.parametrize("d", [16, 48, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dims_of_the_reference_archs_match_reference_kernel(d, causal):
    """head_dim 16 (glm4-smoke), 48 (deepseek-smoke) and 192 (deepseek-v3's
    MLA width), which the wrapper now takes: o against the reference's
    Pallas kernel in interpret mode at 3e-5, lse against a float64
    logsumexp at 3e-5; the dispatch rule names the kernel each runs on the
    card (bf16: wgmma at multiples of 64, mma.sync below; f32: FMA)."""
    q, k, v = _inputs(d + causal, 1, 128, 128, 4, 2, d)
    got, lse = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    kern = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, blocks=(64, 64), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
    s = np.einsum("bqkgd,bskd->bkgqs", q.astype(np.float64).reshape(
        1, 128, 2, 2, d), k.astype(np.float64)) * d ** -0.5
    if causal:
        s = np.where(np.tril(np.ones((128, 128), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want.reshape(1, 4, 128), **TOL)
    assert tfa.kernel_for(torch.float32, d) == "f32"
    assert tfa.kernel_for(torch.bfloat16, d) == ("wgmma" if d % 64 == 0
                                                 else "mma")


def test_launch_counter_does_not_move_on_the_cpu():
    q = torch.zeros((1, 8, 2, 32))
    n = tfa.flash_attention.launches
    tfa.flash_attention(q, q, q)
    tattn.chunked_attention(q, q, q)
    assert tfa.flash_attention.launches == n
