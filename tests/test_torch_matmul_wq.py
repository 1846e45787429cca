"""PyTorch port vs the JAX reference: the weight-quantized matrix product.

`matmul_wq` on a CPU tensor runs the CUDA kernel's plain version
(`matmul_wq_plain`, the same per-tile f32 accumulation); it is held against
the reference's Pallas kernel in interpret mode (small tiles, as the
reference's own tests run it) and the reference's oracle. Tolerance, element
by element: |got - want| <= 1e-5 * sum_k |x_k| |w_kn|, since both sum the
same exact products (every dequantized weight is exact in f32) in another
order. The fused GRAU epilogue is bit-exact on a shared f32 accumulator.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.build import build_grau as jbuild_grau  # noqa: E402
from repro.core.folding import fold as jfold  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.quant import weights as jwq  # noqa: E402
from repro_torch.core.build import build_grau as tbuild_grau  # noqa: E402
from repro_torch.core.folding import fold as tfold  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import matmul_wq as tmm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.quant import weights as twq  # noqa: E402
# pytest puts tests/ on sys.path
from test_torch_epilogue import kernel_epilogue  # noqa: E402

TILES = (8, 16)          # the reference kernel's blocks in interpret mode
REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, m, k, n, bits, xscale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * xscale).astype(np.float32)
    w = (rng.normal(size=(k, n))
         * np.exp2(rng.integers(-3, 3, size=(1, n)))).astype(np.float32)
    jw = jwq.pack_tensor(jnp.asarray(w), bits, -2)
    tw = twq.pack_tensor(_t(w), bits, -2)
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.e.numpy(), np.asarray(jw.e))
    return x, jw, tw


def _bound(x, tw):
    """1e-5 * sum_k |x_mk| |w_kn| for every output element."""
    return REL * (np.abs(x).astype(np.float64)
                  @ np.abs(twq.dense(tw).numpy()).astype(np.float64))


def _spec_pair():
    kw = dict(mac_range=(-30000, 30000), segments=6, num_exponents=8,
              mode="apot", bias_mode="lsq")
    fk = dict(s_in=2**-10, s_out=2**-4, out_bits=8)
    return (jbuild_grau(jfold("silu", **fk), **kw).spec,
            tbuild_grau(tfold("silu", **fk), **kw).spec)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 8, 32])
def test_plain_matches_reference_kernel_and_oracle(bits, m):
    k, n = 1024, 48                       # two 512-wide k-tiles
    x, jw, tw = _case(100 * bits + m, m, k, n, bits)
    want = np.asarray(jops.matmul_wq(jnp.asarray(x), jw, tiles=TILES,
                                     interpret=True))
    want_ref = np.asarray(jref.matmul_wq_ref(jnp.asarray(x), jw))
    got = tmm.matmul_wq(_t(x), tw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    bound = _bound(x, tw)
    assert (np.abs(got.numpy() - want) <= bound).all()
    assert (np.abs(got.numpy() - want_ref) <= bound).all()
    # the port's oracle is the reference's oracle on the same bytes
    got_ref = tref.matmul_wq_ref(_t(x), tw).numpy()
    assert (np.abs(got_ref - want_ref) <= bound).all()
    # and the plain version on the raw operands is the wrapper's result
    assert torch.equal(got, tmm.matmul_wq_plain(_t(x), tw.q, tw.e, bits=bits,
                                                kdim=k))


@pytest.mark.parametrize("bits", [8, 4])
def test_small_tiles_and_any_rank(bits):
    """A K that splits into many tiles (1536 -> 3 x 512), a tile narrower
    than 512 (K = 96), and a 3-D activation like the MLP's (b, s, K)."""
    for k, n in ((1536, 32), (96, 16)):
        x, jw, tw = _case(k + bits, 6, k, n, bits)
        want = np.asarray(jref.matmul_wq_ref(jnp.asarray(x), jw))
        got = tmm.matmul_wq(_t(x).reshape(2, 3, k), tw)
        assert got.shape == (2, 3, n)
        assert (np.abs(got.reshape(6, n).numpy() - want)
                <= _bound(x, tw)).all()


@pytest.mark.parametrize("bits", [8, 4])
def test_grau_epilogue_bit_exact_on_shared_accumulator(bits):
    """The reference kernel's own f32 accumulator through the port's
    epilogue gives exactly the reference's fused bus; the port's fused
    plain path equals its epilogue on its own accumulator. End to end (each
    package's own sum), the buses agree except where the two sums straddle
    a rounding boundary."""
    js, ts = _spec_pair()
    x, jw, tw = _case(7 + bits, 16, 512, 32, bits, xscale=4.0)
    s_in = 2**-8
    acc_j = jops.matmul_wq(jnp.asarray(x), jw, tiles=TILES, interpret=True)
    fused_j = np.asarray(jops.matmul_wq(jnp.asarray(x), jw, js, s_in=s_in,
                                        tiles=TILES, interpret=True))
    port_on_ref = tref.attn_output_quant(_t(acc_j), ts, s_in)
    np.testing.assert_array_equal(port_on_ref.numpy(), fused_j)
    np.testing.assert_array_equal(
        tref.matmul_wq_ref(_t(x), tw, ts, s_in=s_in).numpy(),
        np.asarray(jref.matmul_wq_ref(jnp.asarray(x), jw, js, s_in=s_in)))
    fused_t = tmm.matmul_wq(_t(x), tw, ts, s_in=s_in)
    assert fused_t.dtype == torch.int8
    acc_t = tmm.matmul_wq(_t(x), tw)
    np.testing.assert_array_equal(
        fused_t.numpy(), tref.attn_output_quant(acc_t, ts, s_in).numpy())
    diff = np.abs(fused_t.numpy().astype(np.int32) - fused_j.astype(np.int32))
    agree = float((diff == 0).mean())
    assert diff.max() <= 1 and agree >= 0.99, agree


def test_weights_matmul_routes_like_reference():
    """weights.matmul: a raw tensor is x @ w; a 2-D weight packed along -2
    takes the matmul_wq path (its plain version on the CPU); any other
    packed tensor goes through dense."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(64, 16)).astype(np.float32)
    assert torch.equal(twq.matmul(_t(x), _t(w)), _t(x) @ _t(w))
    qw = twq.pack_tensor(_t(w), 8, -2)
    before = tmm.matmul_wq.launches
    np.testing.assert_array_equal(twq.matmul(_t(x), qw).numpy(),
                                  tmm.matmul_wq(_t(x), qw).numpy())
    assert tmm.matmul_wq.launches == before      # CPU: no kernel launch
    jw = jwq.pack_tensor(jnp.asarray(w), 8, -2)
    with jwq.use_impl("dense"):
        want = np.asarray(jwq.matmul(jnp.asarray(x), jw))
    assert (np.abs(twq.matmul(_t(x), qw).numpy() - want)
            <= _bound(x, qw)).all()
    # packed along the output axis (an embed-like layout): the dense
    # fallback, in both packages
    q1 = twq.pack_tensor(_t(w), 4, -1)
    j1 = jwq.pack_tensor(jnp.asarray(w), 4, -1)
    got = twq.matmul(_t(x), q1)
    np.testing.assert_array_equal(got.numpy(),
                                  (_t(x) @ twq.dense(q1)).numpy())
    with jwq.use_impl("kernel_interpret"):
        want = np.asarray(jwq.matmul(jnp.asarray(x), j1))
    assert (np.abs(got.numpy() - want) <= _bound(x, q1)).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(64, 16)).astype(np.float32)
    qw = twq.pack_tensor(_t(w), 4, -2)
    x = _t(rng.normal(size=(2, 64)).astype(np.float32))
    with pytest.raises(ValueError, match="K=32"):
        tmm.matmul_wq(x[:, :32], qw)
    with pytest.raises(ValueError, match="dtype"):
        tmm.matmul_wq(x.double(), qw)
    with pytest.raises(ValueError, match="axis"):
        tmm.matmul_wq(x, twq.pack_tensor(_t(w), 8, -1))
    with pytest.raises(ValueError, match="payload shape"):
        tmm._check(x, qw.q[:16], qw.e, 4, 64)
    with pytest.raises(ValueError, match="bits"):
        tmm._check(x, qw.q, qw.e, 16, 64)


@pytest.mark.parametrize("bits", [8, 4])
def test_ops_user_wrapper(bits):
    """kernels.ops.matmul_wq, the user-facing wrapper (as the reference's
    ops.matmul_wq): x of any rank, with and without the GRAU epilogue, is
    the kernel wrapper's result; without the epilogue it is the reference
    wrapper's within the stated bound."""
    from repro_torch.kernels import ops as tops
    _, tspec = _spec_pair()
    x, jw, tw = _case(50 + bits, 6, 1024, 48, bits)
    got = tops.matmul_wq(_t(x).reshape(2, 3, 1024), tw)
    assert got.shape == (2, 3, 48)
    want = np.asarray(jops.matmul_wq(jnp.asarray(x), jw, tiles=TILES,
                                     interpret=True))
    assert (np.abs(got.reshape(6, 48).numpy() - want) <= _bound(x, tw)).all()
    fused = tops.matmul_wq(_t(x), tw, tspec, s_in=0.01)
    assert torch.equal(fused, tmm.matmul_wq(_t(x), tw, tspec, s_in=0.01))
    assert fused.dtype == torch.int8


# ---------------------------------------------------------------------------
# The kernel's split over K: part plan, per-part sums, fixed-order reduction
# ---------------------------------------------------------------------------

MLP = {"w_gate": (3072, 8192), "w_down": (8192, 3072)}   # llama3.2-3b


def _emulate_parts(x, tw, parts, tpp):
    """csrc/matmul_wq.cu's decomposition in plain torch (tests only): part
    p sums x_tile @ (q_tile * 2^e_tile) in f32 over its run of pack tiles
    [p * tpp, (p + 1) * tpp); the partial sums are then added in part
    order."""
    from repro_torch.quant.pot import dequantize_pot, unpack_int4
    kt = tw.e.shape[0]
    tile, tp = tw.kdim // kt, tw.q.shape[0] // kt
    partials = []
    for p in range(parts):
        acc = torch.zeros((x.shape[0], tw.e.shape[1]), dtype=torch.float32)
        for i in range(p * tpp, min((p + 1) * tpp, kt)):
            qt = tw.q[i * tp:(i + 1) * tp]
            if tw.bits == 4:
                qt = unpack_int4(qt.t()).t()
            acc += x[:, i * tile:(i + 1) * tile] @ dequantize_pot(qt, tw.e[i])
        partials.append(acc)
    out = partials[0]
    for acc in partials[1:]:
        out = out + acc
    return out


@pytest.mark.parametrize("m", [1, 8, 32, 70])
def test_plan_parts_cover_whole_pack_tiles(m):
    """Parts are runs of whole pack tiles that cover K exactly once (the
    last may be shorter, never empty); at the MLP shapes the split gives
    more than one part and a grid of at least two blocks per SM."""
    for k, n in (*MLP.values(), (1536, 64), (96, 16), (1024, 48), (512, 80)):
        tile = twq.effective_tile(k)
        kt = k // tile
        parts, tpp = tmm.plan_parts(m, n, k, tile)
        assert tpp >= 1 and 1 <= parts <= kt
        assert (parts - 1) * tpp < kt <= parts * tpp
    for k, n in MLP.values():
        parts, _ = tmm.plan_parts(m, n, k, 512)
        blocks = -(-n // tmm.BLOCK_N) * -(-m // tmm.row_tile(m)) * parts
        assert parts > 1 and blocks >= 2 * kbuild.H100_SMS


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [8, 32])
def test_part_sums_match_plain_and_reference_kernel(bits, m):
    """Per-part sums added in part order equal the plain version and the
    reference's Pallas kernel (interpret mode) within 1e-5 sum|x||w|, for
    one part, one tile a part, and uneven runs (4 tiles as 2 + 2 and 3 +
    1); the fused epilogue's arithmetic on that sum is attn_output_quant's,
    bit for bit."""
    k, n = 2048, 48                                 # four 512-wide k-tiles
    x, jw, tw = _case(300 + 10 * bits + m, m, k, n, bits, xscale=2.0)
    want = np.asarray(jops.matmul_wq(jnp.asarray(x), jw, tiles=TILES,
                                     interpret=True))
    plain = tmm.matmul_wq_plain(_t(x), tw.q, tw.e, bits=bits, kdim=k).numpy()
    bound = _bound(x, tw)
    for tpp in (4, 1, 2, 3):
        got = _emulate_parts(_t(x), tw, -(-4 // tpp), tpp).numpy()
        assert (np.abs(got - plain) <= bound).all(), tpp
        assert (np.abs(got - want) <= bound).all(), tpp
    _, ts = _spec_pair()
    acc = _emulate_parts(_t(x), tw, 4, 1)
    for s_in in (2**-8, 0.01):
        np.testing.assert_array_equal(
            kernel_epilogue(acc, ts, s_in).numpy(),
            tref.attn_output_quant(acc, ts, s_in).numpy())


def test_out_dtype_reads_the_f32_sum_behind_a_bf16_product():
    """out_dtype=float32 on bf16 activations gives the f32 sum that the
    bf16 output rounds (and that the fused epilogue quantizes)."""
    x, _, tw = _case(21, 8, 1024, 32, 4)
    xb = _t(x).to(torch.bfloat16)
    f32 = tmm.matmul_wq(xb, tw, out_dtype=torch.float32)
    assert f32.dtype == torch.float32
    assert torch.equal(tmm.matmul_wq(xb, tw), f32.to(torch.bfloat16))
    _, ts = _spec_pair()
    assert torch.equal(tmm.matmul_wq(xb, tw, ts, s_in=0.01),
                       tref.attn_output_quant(f32, ts, 0.01))
    with pytest.raises(ValueError, match="out_dtype"):
        tmm.matmul_wq(xb, tw, out_dtype=torch.float16)
