"""PyTorch port vs the JAX reference: paged decode and chunked-prefill
attention (the CUDA kernels' plain versions, which a CPU tensor runs, and
the port's oracles) against the reference's Pallas kernels in interpret mode
and its ref.py oracles.

Fragmented tables drawn in shuffled order, dead pool blocks poisoned with
1e4 (any read of them would dominate the softmax), ragged lengths and idle
slots; tolerance 3e-5, the reference's own kernel/oracle agreement. The
GRAU epilogue is held bit-exact on the same f32 attention output.

Quantized pools (kv_bits 8 and 4: int8 payloads with per-(block, head)
power-of-two exponents) dequantize exactly, so they are held at the f32
tolerance the card check uses for the kernels (2e-5, element by element),
their dead blocks poisoned with the largest payload at exponent 20.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.build import build_grau as jbuild_grau  # noqa: E402
from repro.core.folding import fold as jfold  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro_torch.core.build import build_grau as tbuild_grau  # noqa: E402
from repro_torch.core.folding import fold as tfold  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
# pytest puts tests/ on sys.path
from test_torch_epilogue import kernel_epilogue  # noqa: E402

BS = 8
TOL = dict(rtol=3e-5, atol=3e-5)
F32_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_table(rng, owned_lengths, nblocks, num_blocks):
    free = list(range(1, num_blocks))
    rng.shuffle(free)
    table = np.zeros((len(owned_lengths), nblocks), np.int32)
    for s, n in enumerate(owned_lengths):
        for j in range(max(1, -(-int(n) // BS))):
            table[s, j] = free.pop()
    return table


def poison_dead(rng, k, v, table, value):
    dead = np.array(sorted(set(range(k.shape[0])) - set(table.ravel())))
    k[dead] = value
    v[dead] = value


def decode_case(rng, *, slots, h, kvh, d, nblocks, num_blocks, lengths,
                poison=None):
    q = rng.normal(size=(slots, h, d)).astype(np.float32)
    k = rng.normal(size=(num_blocks, BS, kvh, d)).astype(np.float32)
    v = rng.normal(size=(num_blocks, BS, kvh, d)).astype(np.float32)
    # idle slots (length 0) keep a NULL row, as in the engine
    table = make_table(rng, [n if n else 0 for n in lengths], nblocks,
                       num_blocks)
    table[np.asarray(lengths) == 0] = 0
    if poison is not None:
        poison_dead(rng, k, v, table, poison)
    return q, k, v, table, np.asarray(lengths, np.int32)


def both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def silu_spec_pair(out_signed=True, act="silu", s_out=2**-4):
    kw = dict(mac_range=(-30000, 30000), segments=6, num_exponents=8,
              mode="apot", bias_mode="lsq")
    js = jbuild_grau(jfold(act, s_in=2**-10, s_out=s_out, out_bits=8,
                           out_signed=out_signed), **kw).spec
    ts = tbuild_grau(tfold(act, s_in=2**-10, s_out=s_out, out_bits=8,
                           out_signed=out_signed), **kw).spec
    return js, ts


@pytest.mark.parametrize("h,kvh", [(8, 2), (6, 3), (4, 4)])
@pytest.mark.parametrize("poison", [None, 1e4])
def test_decode_matches_reference_kernel_and_oracle(h, kvh, poison):
    rng = np.random.default_rng(h * 10 + kvh)
    case = decode_case(rng, slots=5, h=h, kvh=kvh, d=32, nblocks=4,
                       num_blocks=32, lengths=[5, 24, 0, 17, 32],
                       poison=poison)
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = both(*case)
    want = np.asarray(jpa.paged_attention(jq, jk, jv, jt, jl, interpret=True))
    want_ref = np.asarray(jref.paged_attention_ref(jq, jk, jv, jt, jl))
    got = tpa.paged_attention(tq, tk, tv, tt, tl).numpy()
    got_ref = tref.paged_attention_ref(tq, tk, tv, tt, tl).numpy()
    assert np.all(np.isfinite(got))               # idle slot stays finite
    np.testing.assert_allclose(got, want, **TOL)
    live = case[4] > 0
    np.testing.assert_allclose(got_ref[live], want_ref[live], **TOL)
    np.testing.assert_allclose(got[live], got_ref[live], **TOL)


@pytest.mark.parametrize("h,kvh", [(8, 2), (6, 3)])
def test_prefill_matches_reference_kernel_and_oracle(h, kvh):
    rng = np.random.default_rng(7 + h)
    b, chunk, nblocks, num_blocks = 3, 16, 6, 40
    q = rng.normal(size=(b, chunk, h, 32)).astype(np.float32)
    k = rng.normal(size=(num_blocks, BS, kvh, 32)).astype(np.float32)
    v = rng.normal(size=(num_blocks, BS, kvh, 32)).astype(np.float32)
    starts = np.array([0, 8, 32], np.int32)             # on the block grid
    table = make_table(rng, [s + chunk for s in starts], nblocks, num_blocks)
    poison_dead(rng, k, v, table, 1e4)
    (jq, jk, jv, jt, js), (tq, tk, tv, tt, tst) = both(q, k, v, table, starts)
    want = np.asarray(jpa.paged_prefill_attention(jq, jk, jv, jt, js,
                                                  interpret=True))
    want_ref = np.asarray(jref.paged_prefill_ref(jq, jk, jv, jt, js))
    got = tpa.paged_prefill_attention(tq, tk, tv, tt, tst).numpy()
    got_ref = tref.paged_prefill_ref(tq, tk, tv, tt, tst).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_ref, want_ref, **TOL)


@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("signed", [True, False])
def test_grau_epilogue_bit_exact_on_same_f32_output(mode, signed):
    """The fused epilogue's math equals the reference's on the same f32
    attention output; the port's fused path equals its own epilogue applied
    to its own f32 output."""
    rng = np.random.default_rng(11 + signed)
    js, ts = (silu_spec_pair() if signed else
              silu_spec_pair(False, act="relu", s_out=2**-5))
    if mode == "decode":
        case = decode_case(rng, slots=4, h=6, kvh=3, d=32, nblocks=4,
                           num_blocks=24, lengths=[5, 24, 1, 17])
        fn_j, fn_t = jpa.paged_attention, tpa.paged_attention
    else:
        q = rng.normal(size=(2, 16, 6, 32)).astype(np.float32)
        k = rng.normal(size=(30, BS, 3, 32)).astype(np.float32)
        v = rng.normal(size=(30, BS, 3, 32)).astype(np.float32)
        starts = np.array([0, 16], np.int32)
        case = (q, k, v, make_table(rng, [16, 32], 5, 30), starts)
        fn_j, fn_t = jpa.paged_prefill_attention, tpa.paged_prefill_attention
    (jq, jk, jv, jt, jx), (tq, tk, tv, tt, tx) = both(*case)
    s_in = 2**-10
    j_f32 = fn_j(jq, jk, jv, jt, jx, interpret=True)
    j_q = np.asarray(fn_j(jq, jk, jv, jt, jx, spec=js, s_in=s_in,
                          interpret=True))
    # same f32 output -> identical bus, reference epilogue vs port epilogue
    port_on_ref = tref.attn_output_quant(torch.from_numpy(np.array(j_f32)),
                                         ts, s_in)
    np.testing.assert_array_equal(port_on_ref.numpy(), j_q)
    t_f32 = fn_t(tq, tk, tv, tt, tx)
    t_q = fn_t(tq, tk, tv, tt, tx, spec=ts, s_in=s_in)
    assert t_q.dtype == (torch.int8 if signed else torch.uint8)
    np.testing.assert_array_equal(
        t_q.numpy(), tref.attn_output_quant(t_f32, ts, s_in).numpy())
    # across packages the f32 outputs differ by float rounding only
    diff = np.abs(t_q.numpy().astype(np.int32) - j_q.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff) < 0.01


def test_nn_paged_decode_kernel_vs_gather_through_sliced_table():
    """The model-facing dispatch agrees across impls through a bucket-
    sliced (non-contiguous) table, and matches the reference's dispatch."""
    rng = np.random.default_rng(5)
    q, k, v, table, lengths = decode_case(rng, slots=4, h=4, kvh=2, d=16,
                                          nblocks=6, num_blocks=32,
                                          lengths=[6, 20, 11, 2])
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = both(q, k, v, table, lengths)
    jst = jattn.PagedState(jt[:, :3], jl - 1)
    tst = tattn.PagedState(tt[:, :3], tl - 1)
    want = np.asarray(jattn.paged_decode_attention(
        jq[:, None], jattn.PagedKVCache(jk, jv), jst, impl="gather"))
    for impl in ("kernel", "gather"):
        got = tattn.paged_decode_attention(
            tq[:, None], tattn.PagedKVCache(tk, tv), tst, impl=impl).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError):
        tattn.paged_decode_attention(tq[:, None], tattn.PagedKVCache(tk, tv),
                                     tst, impl="nope")


def test_pool_writes_match_reference():
    """paged_update / paged_prefill_update land the same values in the same
    pool slots as the reference's functional updates."""
    rng = np.random.default_rng(9)
    nb, kvh, d = 12, 2, 8
    k = rng.normal(size=(nb, BS, kvh, d)).astype(np.float32)
    table = np.array([[3, 7, 0], [5, 0, 0]], np.int32)
    lengths = np.array([9, 3], np.int32)
    new = rng.normal(size=(2, 1, kvh, d)).astype(np.float32)
    jc = jattn.paged_update(jattn.PagedKVCache(jnp.asarray(k), jnp.asarray(k)),
                            jnp.asarray(new), jnp.asarray(new),
                            jattn.PagedState(jnp.asarray(table),
                                             jnp.asarray(lengths)))
    tc = tattn.PagedKVCache(torch.from_numpy(k.copy()),
                            torch.from_numpy(k.copy()))
    tattn.paged_update(tc, torch.from_numpy(new), torch.from_numpy(new),
                       tattn.PagedState(torch.from_numpy(table),
                                        torch.from_numpy(lengths)))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    chunk = rng.normal(size=(1, 16, kvh, d)).astype(np.float32)
    row, start = np.array([[4, 9, 2, 0]], np.int32), np.array([8], np.int32)
    jc = jattn.paged_prefill_update(
        jattn.PagedKVCache(jnp.asarray(k), jnp.asarray(k)),
        jnp.asarray(chunk), jnp.asarray(chunk),
        jattn.PagedState(jnp.asarray(row), jnp.asarray(start)))
    tc = tattn.PagedKVCache(torch.from_numpy(k.copy()),
                            torch.from_numpy(k.copy()))
    tattn.paged_prefill_update(tc, torch.from_numpy(chunk),
                               torch.from_numpy(chunk),
                               tattn.PagedState(torch.from_numpy(row),
                                                torch.from_numpy(start)))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


def test_wrappers_reject_unported_and_malformed_inputs():
    rng = np.random.default_rng(1)
    q, k, v, table, lengths = decode_case(rng, slots=2, h=4, kvh=2, d=16,
                                          nblocks=2, num_blocks=8,
                                          lengths=[3, 9])
    _, (tq, tk, tv, tt, tl) = both(q, k, v, table, lengths)
    # widths other than 16/8/4 are refused; 8/4 need int8 pools + exponents
    with pytest.raises(ValueError, match="kv_bits"):
        tpa.paged_attention(tq, tk, tv, tt, tl, kv_bits=6)
    with pytest.raises(ValueError, match="int8"):
        tpa.paged_attention(tq, tk, tv, tt, tl, kv_bits=8)
    qk = torch.zeros((8, BS, 2, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="k_exp"):
        tpa.paged_attention(tq, qk, qk, tt, tl, kv_bits=8)
    e = torch.zeros((8, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="head layout"):
        tpa.paged_attention(tq, qk, qk, tt, tl, k_exp=e, v_exp=e, kv_bits=4)
    with pytest.raises(ValueError, match="exponent planes"):
        tpa.paged_attention(tq, tk, tv, tt, tl, k_exp=e, v_exp=e)
    with pytest.raises(ValueError):
        tpa.paged_attention(tq, tk.double(), tv, tt, tl)
    with pytest.raises(ValueError):
        tpa.paged_attention(tq, tk, tv, tt.long(), tl)
    with pytest.raises(ValueError):
        tpa.paged_prefill_attention(tq, tk, tv, tt, tl)


# ---------------------------------------------------------------------------
# Quantized pools (kv_bits 8 / 4)
# ---------------------------------------------------------------------------

def quant_pools(rng, num_blocks, kvh, d, bits, table=None):
    """Random packed pools and exponents; blocks outside `table` are
    poisoned with the largest payload at a large exponent."""
    hdp = d // 2 if bits == 4 else d
    k = rng.integers(-128, 128, size=(num_blocks, BS, kvh, hdp)).astype(
        np.int8)
    v = rng.integers(-128, 128, size=(num_blocks, BS, kvh, hdp)).astype(
        np.int8)
    ke = rng.integers(-9, -4, size=(num_blocks, kvh)).astype(np.int8)
    ve = rng.integers(-9, -4, size=(num_blocks, kvh)).astype(np.int8)
    if table is not None:
        dead = np.array(sorted(set(range(num_blocks)) - set(table.ravel())))
        k[dead] = v[dead] = 0x77                 # +7 in both nibbles / 119
        ke[dead] = ve[dead] = 20
    return k, v, ke, ve


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("h,kvh", [(8, 2), (6, 3)])
def test_quant_decode_matches_reference_kernel_and_oracle(bits, h, kvh):
    rng = np.random.default_rng(bits * 7 + h)
    lengths = np.array([5, 24, 0, 17, 32], np.int32)
    table = make_table(rng, list(lengths), 4, 32)
    table[lengths == 0] = 0
    k, v, ke, ve = quant_pools(rng, 32, kvh, 32, bits, table)
    q = rng.normal(size=(5, h, 32)).astype(np.float32)
    (jq, jk, jv, jke, jve, jt, jl), (tq, tk, tv, tke, tve, tt, tl) = both(
        q, k, v, ke, ve, table, lengths)
    want = np.asarray(jpa.paged_attention(jq, jk, jv, jt, jl, k_exp=jke,
                                          v_exp=jve, kv_bits=bits,
                                          interpret=True))
    want_ref = np.asarray(jref.paged_attention_ref(
        jq, jk, jv, jt, jl, k_exp=jke, v_exp=jve, kv_bits=bits))
    got = tpa.paged_attention(tq, tk, tv, tt, tl, k_exp=tke, v_exp=tve,
                              kv_bits=bits).numpy()
    got_ref = tref.paged_attention_ref(tq, tk, tv, tt, tl, k_exp=tke,
                                       v_exp=tve, kv_bits=bits).numpy()
    assert np.all(np.isfinite(got))               # idle slot stays finite
    np.testing.assert_allclose(got, want, **F32_TOL)
    live = lengths > 0
    np.testing.assert_allclose(got_ref[live], want_ref[live], **F32_TOL)
    np.testing.assert_allclose(got[live], got_ref[live], **F32_TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_prefill_matches_reference_kernel_and_oracle(bits):
    rng = np.random.default_rng(30 + bits)
    b, chunk, h, kvh, nblocks, num_blocks = 3, 16, 6, 3, 6, 40
    starts = np.array([0, 8, 32], np.int32)
    table = make_table(rng, [s + chunk for s in starts], nblocks, num_blocks)
    k, v, ke, ve = quant_pools(rng, num_blocks, kvh, 32, bits, table)
    q = rng.normal(size=(b, chunk, h, 32)).astype(np.float32)
    (jq, jk, jv, jke, jve, jt, js), (tq, tk, tv, tke, tve, tt, tst) = both(
        q, k, v, ke, ve, table, starts)
    kw_j = dict(k_exp=jke, v_exp=jve, kv_bits=bits)
    kw_t = dict(k_exp=tke, v_exp=tve, kv_bits=bits)
    want = np.asarray(jpa.paged_prefill_attention(jq, jk, jv, jt, js,
                                                  interpret=True, **kw_j))
    want_ref = np.asarray(jref.paged_prefill_ref(jq, jk, jv, jt, js, **kw_j))
    got = tpa.paged_prefill_attention(tq, tk, tv, tt, tst, **kw_t).numpy()
    got_ref = tref.paged_prefill_ref(tq, tk, tv, tt, tst, **kw_t).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got_ref, want_ref, **F32_TOL)


@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_grau_epilogue_bit_exact_on_same_f32_output(mode, bits):
    rng = np.random.default_rng(40 + bits)
    js, ts = silu_spec_pair()
    if mode == "decode":
        lengths = np.array([5, 24, 1, 17], np.int32)
        table = make_table(rng, list(lengths), 4, 24)
        q = rng.normal(size=(4, 6, 32)).astype(np.float32)
        x = lengths
        fn_j, fn_t = jpa.paged_attention, tpa.paged_attention
    else:
        x = np.array([0, 16], np.int32)
        table = make_table(rng, [16, 32], 5, 24)
        q = rng.normal(size=(2, 16, 6, 32)).astype(np.float32)
        fn_j, fn_t = jpa.paged_prefill_attention, tpa.paged_prefill_attention
    k, v, ke, ve = quant_pools(rng, 24, 3, 32, bits)
    (jq, jk, jv, jke, jve, jt, jx), (tq, tk, tv, tke, tve, tt, tx) = both(
        q, k, v, ke, ve, table, x)
    kw_j = dict(k_exp=jke, v_exp=jve, kv_bits=bits)
    kw_t = dict(k_exp=tke, v_exp=tve, kv_bits=bits)
    s_in = 2**-10
    j_f32 = fn_j(jq, jk, jv, jt, jx, interpret=True, **kw_j)
    j_q = np.asarray(fn_j(jq, jk, jv, jt, jx, spec=js, s_in=s_in,
                          interpret=True, **kw_j))
    port_on_ref = tref.attn_output_quant(torch.from_numpy(np.array(j_f32)),
                                         ts, s_in)
    np.testing.assert_array_equal(port_on_ref.numpy(), j_q)
    t_f32 = fn_t(tq, tk, tv, tt, tx, **kw_t)
    t_q = fn_t(tq, tk, tv, tt, tx, spec=ts, s_in=s_in, **kw_t)
    np.testing.assert_array_equal(
        t_q.numpy(), tref.attn_output_quant(t_f32, ts, s_in).numpy())
    diff = np.abs(t_q.numpy().astype(np.int32) - j_q.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff) < 0.01


@pytest.mark.parametrize("bits", [8, 4])
def test_nn_quant_paths_match_reference(bits):
    """The model-facing dispatch on quantized pools: kernel and gather
    paths through a bucket-sliced table, decode and prefill, against the
    reference's gather path."""
    rng = np.random.default_rng(50 + bits)
    lengths = np.array([6, 20, 11, 2], np.int32)
    table = make_table(rng, list(lengths), 6, 32)
    k, v, ke, ve = quant_pools(rng, 32, 2, 16, bits, table)
    q = rng.normal(size=(4, 1, 4, 16)).astype(np.float32)
    (jq, jk, jv, jke, jve, jt, jl), (tq, tk, tv, tke, tve, tt, tl) = both(
        q, k, v, ke, ve, table, lengths)
    jc = jattn.QuantPagedKVCache(jk, jv, jke, jve, bits=bits)
    tc = tattn.QuantPagedKVCache(tk, tv, tke, tve, bits=bits)
    jst = jattn.PagedState(jt[:, :3], jl - 1)
    tst = tattn.PagedState(tt[:, :3], tl - 1)
    want = np.asarray(jattn.paged_decode_attention(jq, jc, jst,
                                                   impl="gather"))
    for impl in ("kernel", "gather"):
        got = tattn.paged_decode_attention(tq, tc, tst, impl=impl).numpy()
        np.testing.assert_allclose(got, want, **F32_TOL)
    qp = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    start = np.array([8, 0], np.int32)
    jst = jattn.PagedState(jt[:2, :3], jnp.asarray(start))
    tst = tattn.PagedState(tt[:2, :3], torch.from_numpy(start))
    want = np.asarray(jattn.paged_prefill_attention(
        jnp.asarray(qp), jc, jst, impl="gather"))
    for impl in ("kernel", "gather"):
        got = tattn.paged_prefill_attention(torch.from_numpy(qp), tc, tst,
                                            impl=impl).numpy()
        np.testing.assert_allclose(got, want, **F32_TOL)


# ---------------------------------------------------------------------------
# The bf16 prefill kernel's split over the sequence: plan, parts, combine
# ---------------------------------------------------------------------------

def emulate_prefill_parts(q, k_pool, v_pool, table, start, parts, bpp, *,
                          k_exp=None, v_exp=None, kv_bits=16, tile=64):
    """csrc/paged_prefill.cu's decomposition in plain torch (tests only).
    Part p covers table blocks [p * bpp, (p + 1) * bpp) cut to the live
    blocks max(cdiv(start + C, bs), 1); inside it an online softmax over
    `tile`-position tiles from m = NEG_INF, l = 0, o = 0, with NEG_INF on
    positions past a row's horizon, gives the part's (o, m, l). The live
    parts are then combined in part order: m = max m_p, l = sum l_p
    e^(m_p - m), o = sum o_p e^(m_p - m), out = o / max(l, 1e-30)."""
    b, chunk, h, d = q.shape
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    g, width, rows = h // kvh, table.shape[1], chunk * (h // kvh)
    scale = d ** -0.5
    qr = (q.reshape(b, chunk, kvh, g, d).permute(0, 2, 1, 3, 4)
          .reshape(b, kvh, rows, d).float())
    load = tpa._block_loader(k_pool, v_pool, k_exp, v_exp, kv_bits)
    out = torch.empty((b, kvh, rows, d))
    for bi in range(b):
        s0 = int(start[bi])
        live = min(max(-(-(s0 + chunk) // bs), 1), width)
        horizon = s0 + torch.arange(rows) // g
        got = []
        for p in range(parts):
            lo, hi = p * bpp, min((p + 1) * bpp, live)
            if lo >= hi:
                break
            kk, vv = load(table[bi, lo:hi].long())
            kk, vv = kk.reshape(-1, kvh, d), vv.reshape(-1, kvh, d)
            pos = torch.arange(lo * bs, hi * bs)
            m = torch.full((kvh, rows, 1), tref.NEG_INF)
            l = torch.zeros((kvh, rows, 1))
            o = torch.zeros((kvh, rows, d))
            for t0 in range(0, len(pos), tile):
                lg = torch.einsum("krd,tkd->krt", qr[bi],
                                  kk[t0:t0 + tile]) * scale
                seen = pos[None, None, t0:t0 + tile] <= horizon[None, :, None]
                lg = torch.where(seen, lg, tref.NEG_INF)
                m_new = torch.maximum(m, lg.amax(-1, keepdim=True))
                e = torch.exp(lg - m_new)
                alpha = torch.exp(m - m_new)
                l = l * alpha + e.sum(-1, keepdim=True)
                o = o * alpha + torch.einsum("krt,tkd->krd", e,
                                             vv[t0:t0 + tile])
                m = m_new
            got.append((o, m, l))
        m_all = got[0][1]
        for _, m, _ in got[1:]:
            m_all = torch.maximum(m_all, m)
        l_all, o_all = 0.0, 0.0
        for o, m, l in got:
            f = torch.exp(m - m_all)
            l_all = l_all + l * f
            o_all = o_all + o * f
        out[bi] = o_all / torch.clamp(l_all, min=1e-30)
    return (out.reshape(b, kvh, chunk, g, d).permute(0, 2, 1, 3, 4)
            .reshape(b, chunk, h, d))


@pytest.mark.parametrize("batch,kvh,rows,width,bs", [
    (1, 8, 96, 64, 16),       # llama3.2-3b: one 32-token chunk at 992
    (8, 8, 96, 128, 16), (1, 2, 96, 70, 16), (1, 8, 96, 2, 16),
    (3, 3, 32, 6, 8), (1, 8, 300, 64, 16), (2, 2, 96, 33, 16)])
def test_prefill_plan_covers_whole_table_blocks(batch, kvh, rows, width, bs):
    """Parts are runs of whole table blocks covering the table width once
    (the last may be shorter, never empty), each of at least 64 positions
    where the table has them; the main shape gives more than one part."""
    parts, bpp = tpa.prefill_plan(batch, kvh, rows, width, bs)
    assert bpp >= 1 and (parts - 1) * bpp < width <= parts * bpp
    assert bpp * bs >= min(tpa.MIN_PART_POSITIONS, width * bs)
    groups = -(-rows // tpa.GROUP_ROWS)
    most = max(1, width * bs // tpa.MIN_PART_POSITIONS)
    assert (batch * kvh * groups * parts >= kbuild.H100_SMS
            or bpp == -(-width // most))         # as short as parts may be
    if (batch, kvh, rows, width, bs) == (1, 8, 96, 64, 16):
        assert parts > 1


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_prefill_parts_match_plain_and_reference_kernel(bits):
    """Per-part (o, m, l) combined in part order equal the plain version
    (within 2e-5) and the reference's Pallas kernel in interpret mode, for
    one part and for parts of 1, 2 and 3 table blocks: start 0 (rows whose
    horizon ends in an earlier part than the live range's last), a start
    mid-prompt, and a table wider than the live range (dead blocks
    poisoned); the fused epilogue's arithmetic on the combined output is
    attn_output_quant's, bit for bit."""
    rng = np.random.default_rng(70 + bits)
    b, chunk, h, kvh, d, width, num_blocks = 3, 16, 6, 3, 32, 8, 40
    starts = np.array([0, 8, 40], np.int32)      # live blocks 2, 3, 7 of 8
    table = make_table(rng, [s + chunk for s in starts], width, num_blocks)
    if bits == 16:
        k = rng.normal(size=(num_blocks, BS, kvh, d)).astype(np.float32)
        v = rng.normal(size=(num_blocks, BS, kvh, d)).astype(np.float32)
        poison_dead(rng, k, v, table, 1e4)
        arrays, tol = (k, v), TOL
    else:
        arrays, tol = quant_pools(rng, num_blocks, kvh, d, bits, table), \
            F32_TOL
    q = rng.normal(size=(b, chunk, h, d)).astype(np.float32)
    jarr, tarr = both(q, *arrays, table, starts)
    jq, jk, jv, jt, js = jarr[0], jarr[1], jarr[2], jarr[-2], jarr[-1]
    tq, tk, tv, tt, tst = tarr[0], tarr[1], tarr[2], tarr[-2], tarr[-1]
    kw_j, kw_t = {}, {}
    if bits < 16:
        kw_j = dict(k_exp=jarr[3], v_exp=jarr[4], kv_bits=bits)
        kw_t = dict(k_exp=tarr[3], v_exp=tarr[4], kv_bits=bits)
    want = np.asarray(jpa.paged_prefill_attention(jq, jk, jv, jt, js,
                                                  interpret=True, **kw_j))
    plain = tpa.paged_prefill_plain(tq, tk, tv, tt, tst,
                                    out_dtype=torch.float32, **kw_t).numpy()
    for bpp in (width, 1, 2, 3):
        got = emulate_prefill_parts(tq, tk, tv, tt, tst, -(-width // bpp),
                                    bpp, **kw_t)
        np.testing.assert_allclose(got.numpy(), plain, **F32_TOL)
        np.testing.assert_allclose(got.numpy(), want, **tol)
    _, ts = silu_spec_pair()
    for s_in in (2**-10, 0.003):
        np.testing.assert_array_equal(
            kernel_epilogue(got, ts, s_in).numpy(),
            tref.attn_output_quant(got, ts, s_in).numpy())


# ---------------------------------------------------------------------------
# The bf16 decode kernel's split over the sequence (csrc/paged_prefill.cu,
# attend_kernel with 4 position warps)
# ---------------------------------------------------------------------------

def emulate_decode_parts(q, k_pool, v_pool, table, lengths, parts, bpp, *,
                         k_exp=None, v_exp=None, kv_bits=16, tile=64,
                         warps=4):
    """The split decode's decomposition in plain torch (tests only). Part p
    covers table blocks [p * bpp, (p + 1) * bpp) cut to the live blocks
    max(cdiv(len, bs), 1); inside it `tile`-position tiles, of which warp w
    takes positions [w * tile / warps, (w + 1) * tile / warps): each warp an
    online softmax from m = NEG_INF, l = 0, o = 0 over its positions in tile
    order, NEG_INF past the slot's length and -inf past the part's live
    end. The warps' (o, m, l) are merged in warp order, then the live parts
    in part order, both as m = max m_i, l = sum l_i e^(m_i - m), o = sum o_i
    e^(m_i - m); out = o / max(l, 1e-30)."""
    slots, h, d = q.shape
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    g, width = h // kvh, table.shape[1]
    scale = d ** -0.5
    qr = q.reshape(slots, kvh, g, d).float()
    load = tpa._block_loader(k_pool, v_pool, k_exp, v_exp, kv_bits)
    step = tile // warps

    def merge(items):
        m_all = items[0][1]
        for _, m, _ in items[1:]:
            m_all = torch.maximum(m_all, m)
        l_all, o_all = 0.0, 0.0
        for o, m, l in items:
            f = torch.exp(m - m_all)
            l_all = l_all + l * f
            o_all = o_all + o * f
        return o_all, m_all, l_all

    out = torch.empty((slots, kvh, g, d))
    for b in range(slots):
        n = int(lengths[b])
        live = min(max(-(-n // bs), 1), width)
        got = []
        for p in range(parts):
            lo, hi = p * bpp, min((p + 1) * bpp, live)
            if lo >= hi:
                break
            kk, vv = load(table[b, lo:hi].long())
            kk, vv = kk.reshape(-1, kvh, d), vv.reshape(-1, kvh, d)
            npos = kk.shape[0]
            per_warp = []
            for w in range(warps):
                m = torch.full((kvh, g, 1), tref.NEG_INF)
                l = torch.zeros((kvh, g, 1))
                o = torch.zeros((kvh, g, d))
                for t0 in range(0, npos, tile):
                    idx = torch.arange(t0 + w * step, t0 + (w + 1) * step)
                    dead = idx >= npos
                    idx = idx.clamp(max=npos - 1)
                    lg = torch.einsum("kgd,tkd->kgt", qr[b], kk[idx]) * scale
                    lg = torch.where((lo * bs + idx < n)[None, None], lg,
                                     tref.NEG_INF)
                    lg = torch.where(dead[None, None], float("-inf"), lg)
                    m_new = torch.maximum(m, lg.amax(-1, keepdim=True))
                    e = torch.exp(lg - m_new)
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + e.sum(-1, keepdim=True)
                    o = o * alpha + torch.einsum("kgt,tkd->kgd", e, vv[idx])
                    m = m_new
                per_warp.append((o, m, l))
            got.append(merge(per_warp))
        o, _, l = merge(got)
        out[b] = o / torch.clamp(l, min=1e-30)
    return out.reshape(slots, h, d)


@pytest.mark.parametrize("batch,kvh,width,bs", [
    (8, 8, 128, 16),          # llama3.2-3b: 8 slots ragged to 2048, page 16
    (1, 8, 128, 16), (8, 8, 16, 16), (4, 2, 6, 8), (2, 2, 33, 16),
    (8, 8, 128, 128), (3, 1, 1, 16), (8, 4, 70, 24)])
def test_decode_plan_covers_whole_table_blocks(batch, kvh, width, bs):
    """Parts are runs of whole table blocks covering the table width once
    (the last may be shorter, never empty), part 0 starting at block 0;
    each part holds whole 64-position tiles where the block size divides 64
    and at least 64 positions where the table has them; at the main shape
    the grid holds at least 2 blocks an SM (4 planned)."""
    parts, bpp = tpa.decode_plan(batch, kvh, width, width, bs)
    assert bpp >= 1 and (parts - 1) * bpp < width <= parts * bpp
    starts = [p * bpp for p in range(parts)]
    assert starts[0] == 0 and all(s < width for s in starts)
    assert bpp * bs >= min(tpa.MIN_PART_POSITIONS, width * bs)
    if tpa.MIN_PART_POSITIONS % bs == 0 and bpp < width:
        assert bpp * bs % tpa.MIN_PART_POSITIONS == 0
    most = max(1, width * bs // tpa.MIN_PART_POSITIONS)
    want = -(-2 * kbuild.H100_SMS // (batch * kvh))
    assert batch * kvh * parts >= min(2 * kbuild.H100_SMS,
                                      batch * kvh * max(1, min(most, want)
                                                        // 2))
    if (batch, kvh, width, bs) == (8, 8, 128, 16):
        assert (parts, bpp) == (8, 16)
        assert batch * kvh * parts >= 2 * kbuild.H100_SMS


@pytest.mark.parametrize("batch,kvh,cap,bs", [
    (8, 8, 128, 16),          # llama3.2-3b: 8 slots, max_seq 2048, page 16
    (8, 2, 128, 16),          # glm4-9b: 2 KV heads
    (8, 40, 128, 16),         # qwen1.5-32b: 40 KV heads
    (1, 8, 128, 16), (4, 2, 6, 8), (2, 2, 33, 16), (8, 4, 70, 24)])
def test_decode_plan_from_capacity_is_the_same_in_every_bucket(batch, kvh,
                                                               cap, bs):
    """Planned from the table's capacity (its row stride), every decode
    bucket of the ladder cuts the table at the same part boundaries (the
    same blocks a part), so a slot's live parts — the only ones the combine
    reads — are the same in every bucket that covers them; the engine's
    row stride (the capacity plus a chunk's blocks) plans as the capacity
    does at the main shape (the timed one: 8 parts of 16 blocks)."""
    from repro_torch.serve import kv_cache as tkvc
    full = tpa.decode_plan(batch, kvh, cap, cap, bs)
    for w in tkvc.decode_block_buckets(cap):
        parts, bpp = tpa.decode_plan(batch, kvh, w, cap, bs)
        assert bpp == full[1] and parts == -(-w // bpp)
    if (batch, kvh, cap, bs) == (8, 8, 128, 16):
        assert full == (8, 16)
        assert tpa.decode_plan(batch, kvh, cap, cap + 32 // bs, bs) == full


@pytest.mark.parametrize("bits", [16, 4])
def test_decode_parts_same_bits_in_every_bucket(bits):
    """The split decode emulated at a 16-block bucket and at the whole
    64-block table (8-position blocks, 8 SMs), each planned from the
    table's capacity (64, its row stride): one part of 16 blocks covers
    every live length (<= 128 positions) in both, and the outputs are equal
    bit for bit. Planned from the 16-block width alone, the same slots
    would split at 64 positions: the dependence on the bucket that
    planning from the row stride removes."""
    rng = np.random.default_rng(70 + bits)
    slots, h, kvh, d, cap = 4, 6, 2, 32, 64
    num_blocks = slots * cap + 1
    lengths = np.array([1, 40, 100, 128], np.int32)
    table = make_table(rng, list(lengths), cap, num_blocks)
    if bits == 16:
        k = rng.normal(size=(num_blocks, BS, kvh, d)).astype(np.float32)
        v = rng.normal(size=(num_blocks, BS, kvh, d)).astype(np.float32)
        arrays = (k, v)
    else:
        arrays = quant_pools(rng, num_blocks, kvh, d, bits, table)
    q = rng.normal(size=(slots, h, d)).astype(np.float32)
    _, tarr = both(q, *arrays, table, lengths)
    tq, tk, tv, tt, tl = tarr[0], tarr[1], tarr[2], tarr[-2], tarr[-1]
    kw = dict(k_exp=tarr[3], v_exp=tarr[4], kv_bits=bits) if bits < 16 else {}
    outs = []
    for w in (16, cap):
        parts, bpp = tpa.decode_plan(slots, kvh, w, cap, BS, sms=8)
        assert bpp == 16
        outs.append(emulate_decode_parts(tq, tk, tv, tt[:, :w], tl, parts,
                                         bpp, tile=16, **kw))
    assert tpa.decode_plan(slots, kvh, 16, 16, BS, sms=8)[1] == 8
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_decode_parts_match_plain_and_reference_kernel(bits):
    """The split decode emulated — per-warp (o, m, l) merged in warp order,
    per-part merged in part order — equals the plain version (within 2e-5)
    and the reference's Pallas kernel in interpret mode, on 16-, 8- and
    4-bit pools, for one part and parts of 1, 2 and 3 table blocks: lengths
    at part boundaries (16, 17, 24 with 8-position blocks), an idle slot,
    length 1 and a full table, dead blocks poisoned; the fused epilogue's
    arithmetic on the combined output is attn_output_quant's, bit for
    bit."""
    rng = np.random.default_rng(90 + bits)
    slots, h, kvh, d, width, num_blocks = 7, 6, 2, 32, 8, 64
    lengths = np.array([16, 17, 0, 24, 1, width * BS, 41], np.int32)
    table = make_table(rng, [n if n else 0 for n in lengths], width,
                       num_blocks)
    table[lengths == 0] = 0
    if bits == 16:
        k = rng.normal(size=(num_blocks, BS, kvh, d)).astype(np.float32)
        v = rng.normal(size=(num_blocks, BS, kvh, d)).astype(np.float32)
        poison_dead(rng, k, v, table, 1e4)
        arrays, tol = (k, v), TOL
    else:
        arrays, tol = quant_pools(rng, num_blocks, kvh, d, bits, table), \
            F32_TOL
    q = rng.normal(size=(slots, h, d)).astype(np.float32)
    jarr, tarr = both(q, *arrays, table, lengths)
    jq, jk, jv, jt, jl = jarr[0], jarr[1], jarr[2], jarr[-2], jarr[-1]
    tq, tk, tv, tt, tl = tarr[0], tarr[1], tarr[2], tarr[-2], tarr[-1]
    kw_j, kw_t = {}, {}
    if bits < 16:
        kw_j = dict(k_exp=jarr[3], v_exp=jarr[4], kv_bits=bits)
        kw_t = dict(k_exp=tarr[3], v_exp=tarr[4], kv_bits=bits)
    want = np.asarray(jpa.paged_attention(jq, jk, jv, jt, jl, interpret=True,
                                          **kw_j))
    plain = tpa.paged_attention_plain(tq, tk, tv, tt, tl,
                                      out_dtype=torch.float32, **kw_t).numpy()
    for bpp in (width, 1, 2, 3):
        got = emulate_decode_parts(tq, tk, tv, tt, tl, -(-width // bpp), bpp,
                                   tile=16, **kw_t)
        assert np.all(np.isfinite(got.numpy()))      # the idle slot too
        np.testing.assert_allclose(got.numpy(), plain, **F32_TOL)
        np.testing.assert_allclose(got.numpy(), want, **tol)
    _, ts = silu_spec_pair()
    for s_in in (2**-10, 0.003):
        np.testing.assert_array_equal(
            kernel_epilogue(got, ts, s_in).numpy(),
            tref.attn_output_quant(got, ts, s_in).numpy())


@pytest.mark.parametrize("d", [16, 48])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_head_dims_16_and_48_match_reference_kernels(d, bits):
    """head_dim 16 (glm4-smoke) and 48 (deepseek-smoke), where a 4-bit
    pool row is 8 and 24 bytes (the kernels copy it in 8-byte pieces):
    decode and prefill against the reference's Pallas kernels in interpret
    mode, 16-bit pools at 3e-5 and quantized pools at 2e-5."""
    rng = np.random.default_rng(d * 3 + bits)
    h, kvh, width, num_blocks = 6, 2, 6, 40
    lengths = np.array([5, 24, 0, 17, width * BS], np.int32)
    table = make_table(rng, [n if n else 0 for n in lengths], width,
                       num_blocks)
    table[lengths == 0] = 0
    if bits == 16:
        k = rng.normal(size=(num_blocks, BS, kvh, d)).astype(np.float32)
        v = rng.normal(size=(num_blocks, BS, kvh, d)).astype(np.float32)
        poison_dead(rng, k, v, table, 1e4)
        arrays, tol = (k, v), TOL
    else:
        arrays, tol = quant_pools(rng, num_blocks, kvh, d, bits, table), \
            F32_TOL
    q = rng.normal(size=(5, h, d)).astype(np.float32)
    qp = rng.normal(size=(2, 16, h, d)).astype(np.float32)
    starts = np.array([0, 8], np.int32)
    jarr, tarr = both(q, qp, *arrays, table, lengths, starts)
    kw_j, kw_t = {}, {}
    if bits < 16:
        kw_j = dict(k_exp=jarr[4], v_exp=jarr[5], kv_bits=bits)
        kw_t = dict(k_exp=tarr[4], v_exp=tarr[5], kv_bits=bits)
    jk, jv, tk, tv = jarr[2], jarr[3], tarr[2], tarr[3]
    jt, tt = jarr[-3], tarr[-3]
    want = np.asarray(jpa.paged_attention(jarr[0], jk, jv, jt, jarr[-2],
                                          interpret=True, **kw_j))
    got = tpa.paged_attention(tarr[0], tk, tv, tt, tarr[-2], **kw_t).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **tol)
    want = np.asarray(jpa.paged_prefill_attention(
        jarr[1], jk, jv, jt[:2], jarr[-1], interpret=True, **kw_j))
    got = tpa.paged_prefill_attention(tarr[1], tk, tv, tt[:2].contiguous(),
                                      tarr[-1], **kw_t).numpy()
    np.testing.assert_allclose(got, want, **tol)
