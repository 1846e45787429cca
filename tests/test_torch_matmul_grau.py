"""PyTorch port vs the JAX reference: the fused int8 matmul + GRAU epilogue.

On a CPU tensor `ops.matmul_grau` runs the CUDA kernel's plain version
(`matmul_grau_plain`: the product in float64, exact for int8 operands,
wrapped to int32, then the plain datapath). It is held bit for bit against
the reference's Pallas kernel in interpret mode (small tiles, as the
reference's own tests run it) and the reference's oracle, at the shapes of
the reference's kernel tests, for fitted signed and unsigned register files
and random ones. The same numpy inputs and register files go to both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.build import build_grau as jbuild_grau  # noqa: E402
from repro.core.folding import fold as jfold  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.pwlf.spec import make_spec as jmake_spec  # noqa: E402
from repro_torch.core.build import build_grau as tbuild_grau  # noqa: E402
from repro_torch.core.folding import fold as tfold  # noqa: E402
from repro_torch.kernels import matmul_grau as tmg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.pwlf.spec import make_spec as tmake_spec  # noqa: E402

_FITTED = {}
_JREF = jax.jit(jref.matmul_grau_ref)     # the oracle, compiled once a shape


def _fitted(act, signed):
    """The reference tests' fitted units (mac range +/-30000, APoT, 6
    segments, 8 exponents), built by each package from the same fold; a
    ReLU on the unsigned (uint8) bus as well."""
    key = (act, signed)
    if key not in _FITTED:
        kw = dict(s_in=2 ** -10, s_out=2 ** -4, out_bits=8,
                  out_signed=signed)
        bkw = dict(mac_range=(-30000, 30000), segments=6, num_exponents=8,
                   mode="apot", bias_mode="lsq")
        _FITTED[key] = (jbuild_grau(jfold(act, **kw), **bkw).spec,
                        tbuild_grau(tfold(act, **kw), **bkw).spec)
    return _FITTED[key]


def _random(rng):
    """One random register file (pre-shifts both ways, up to 36 + 8), as
    (reference spec, port spec)."""
    segments, ne = int(rng.integers(1, 9)), int(rng.integers(1, 9))
    bps = (np.sort(rng.choice(np.arange(-(1 << 22), 1 << 22),
                              size=segments - 1, replace=False))
           if segments > 1 else np.empty((0,), np.int64))
    arrays = (bps, rng.integers(0, 2, size=(segments, ne)),
              rng.choice([-1, 1], size=segments),
              rng.integers(-100, 101, size=segments))
    kw = dict(pre_shift=int(rng.integers(-3, 37)), num_exponents=ne,
              out_bits=int(rng.choice([2, 4, 8])),
              out_signed=bool(rng.integers(0, 2)))
    return jmake_spec(*arrays, **kw), tmake_spec(*arrays, **kw)


def _operands(rng, xshape, k, n):
    x = rng.integers(-128, 128, size=xshape).astype(np.int8)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    x.reshape(-1)[:1], w.reshape(-1)[:2] = -128, -128
    return x, w


def _check(x, w, jspec, tspec, tiles):
    """port wrapper == port plain == port oracle == reference kernel
    (interpret) == reference oracle, byte for byte and type for type."""
    k, n = w.shape
    got = tops.matmul_grau(torch.from_numpy(x), torch.from_numpy(w), tspec)
    want = np.asarray(jops.matmul_grau(jnp.asarray(x), jnp.asarray(w), jspec,
                                       tiles=tiles, interpret=True))
    oracle = np.asarray(_JREF(jnp.asarray(x.reshape(-1, k)), jnp.asarray(w),
                              jspec)).reshape(want.shape)
    assert got.numpy().dtype == want.dtype == oracle.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, oracle)
    x2 = torch.from_numpy(x.reshape(-1, k))
    plain = tmg.matmul_grau_plain(
        x2, torch.from_numpy(w), tspec.packed("cpu"),
        num_exponents=tspec.num_exponents, qmin=tspec.qmin, qmax=tspec.qmax)
    np.testing.assert_array_equal(plain.numpy().reshape(want.shape), want)
    np.testing.assert_array_equal(
        tref.matmul_grau_ref(x2, torch.from_numpy(w), tspec).numpy()
        .reshape(want.shape), want)


@pytest.mark.parametrize("m,k,n,act,signed", [
    (128, 128, 128, "silu", True), (130, 260, 300, "silu", True),
    (64, 512, 64, "silu", True), (256, 384, 256, "silu", True),
    (128, 128, 128, "relu", False), (130, 260, 300, "relu", False)])
def test_matmul_grau_matches_reference_kernel(m, k, n, act, signed):
    """The shapes of the reference's fused-kernel sweep (ragged M, N and K
    included: 130 x 260 x 300), on the signed bus, and two of them on the
    unsigned (uint8) bus."""
    jspec, tspec = _fitted(act, signed)
    x, w = _operands(np.random.default_rng(m + k + n), (m, k), k, n)
    _check(x, w, jspec, tspec, (128, 128, 128))


@pytest.mark.parametrize("xshape", [(2, 17, 128), (128,)])
def test_matmul_grau_batched_and_vector_inputs(xshape):
    """x of any rank: the (2, 17, 128) x (128, 96) batched case and a 1-D
    row; the output keeps x's leading axes."""
    jspec, tspec = _fitted("silu", True)
    x, w = _operands(np.random.default_rng(3), xshape, 128, 96)
    got = tops.matmul_grau(torch.from_numpy(x), torch.from_numpy(w), tspec)
    assert tuple(got.shape) == xshape[:-1] + (96,)
    _check(x, w, jspec, tspec, (64, 64, 64))


@pytest.mark.parametrize("case", range(10))
def test_matmul_grau_random_specs_and_shapes(case):
    """The reference's seeded differential cases: random M, K, N in 1..96
    and random register files (2/4/8-bit buses, both signs)."""
    rng = np.random.default_rng(2000 + case)
    jspec, tspec = _random(rng)
    m, k, n = (int(rng.integers(1, 97)) for _ in range(3))
    x, w = _operands(rng, (m, k), k, n)
    _check(x, w, jspec, tspec, (64, 64, 64))


def test_plain_version_wraps_int32_like_the_reference():
    """A sum past 2^31 wraps modulo 2^32 in the plain version, as the
    reference's int32 dot does (K = 2^17 + 1 products of -128 x -128)."""
    k = (1 << 17) + 1
    x = torch.full((1, k), -128, dtype=torch.int8)
    w = torch.full((k, 2), -128, dtype=torch.int8)
    acc = tref.wrap_int32((x.double() @ w.double()).long())
    assert int(acc[0, 0]) == 16384 * k - (1 << 32)
    _, tspec = _fitted("silu", True)
    plain = tmg.matmul_grau_plain(x, w, tspec.packed("cpu"),
                                  num_exponents=tspec.num_exponents,
                                  qmin=tspec.qmin, qmax=tspec.qmax)
    np.testing.assert_array_equal(plain.numpy(),
                                  tref.matmul_grau_ref(x, w, tspec).numpy())


def test_matmul_grau_wrapper_errors():
    _, tspec = _fitted("silu", True)
    x = torch.zeros((4, 32), dtype=torch.int8)
    w = torch.zeros((32, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        tops.matmul_grau(x.to(torch.int32), w, tspec)
    with pytest.raises(ValueError, match="int8"):
        tops.matmul_grau(x, w.float(), tspec)
    with pytest.raises(ValueError, match="K mismatch"):
        tops.matmul_grau(x, w[:16], tspec)
    with pytest.raises(ValueError, match="one device"):
        tops.matmul_grau(x, w.to("meta"), tspec)
    with pytest.raises(ValueError, match="register file"):
        tmg.matmul_grau(x, w, torch.zeros(31, dtype=torch.int32),
                        num_exponents=1, qmin=-128, qmax=127)


def test_matmul_grau_counts_only_kernel_launches():
    """A CPU tensor runs the plain version and is not counted."""
    from repro_torch import kernels
    _, tspec = _fitted("silu", True)
    kernels.reset_launches()
    tops.matmul_grau(torch.zeros((2, 32), dtype=torch.int8),
                     torch.zeros((32, 8), dtype=torch.int8), tspec)
    assert kernels.launch_counts()["matmul_grau"] == 0


# ---------------------------------------------------------------------------
# the kernel's plan and its split-K, swapped-operand arithmetic, emulated
# ---------------------------------------------------------------------------

MLP_ROWS32 = [(32, 3072, 8192), (32, 8192, 3072), (1, 8192, 3072),
              (8, 3072, 8192)]


@pytest.mark.parametrize("m,k,n", MLP_ROWS32 + [
    (128, 256, 128), (2048, 3072, 8192), (2048, 8192, 3072), (1, 200, 128),
    (33, 260, 96), (300, 2048, 136), (5, 0, 7), (4096, 128, 64)])
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_plan_parts_cover_k_exactly(m, k, n, sms):
    """The parts are runs of whole 128-k steps that cover K once: every part
    non-empty, the last possibly shorter; the row tile is one the kernel is
    built for; a plan is a function of the shapes and the SM count alone."""
    bm, parts, spp = tmg.plan(m, n, k, sms)
    steps = max(1, -(-k // tmg.STEP_K))
    assert bm in (32, 128) and parts >= 1 and spp >= 1
    assert (parts - 1) * spp < steps <= parts * spp
    covered = [s for p in range(parts)
               for s in range(p * spp, min(steps, (p + 1) * spp))]
    assert covered == list(range(steps))
    tmg.plan.cache_clear()
    assert tmg.plan(m, n, k, sms) == (bm, parts, spp)


@pytest.mark.parametrize("m,k,n", MLP_ROWS32)
def test_plan_gives_every_sm_a_block_at_32_rows(m, k, n):
    """At the MLP widths with 32 rows or fewer the output tiles are fewer
    than the SMs; splitting K gives every SM at least one block (on an H100
    and on a 114-SM part), no part shorter than MIN_PART_STEPS but the
    last, and no row tile wider than 32."""
    for sms in (132, 114):
        bm, parts, spp = tmg.plan(m, n, k, sms)
        blocks = -(-n // tmg.BLOCK_N) * -(-m // bm) * parts
        assert bm == 32 and parts > 1 and blocks >= sms
        assert spp >= tmg.MIN_PART_STEPS


def _split_swap_emulation(x, w, regs, spec, plan, rng):
    """The kernel's arithmetic in torch: each K part's int32 partial sums of
    the swapped product out^T = w^T x^T (exact in int64, wrapped to int32),
    combined in a shuffled part order modulo 2^32, transposed back, then the
    plain datapath."""
    bm, parts, spp = plan
    k = x.shape[1]
    step = tmg.STEP_K
    partial = []
    for p in range(parts):
        k0, k1 = p * spp * step, min(k, (p + 1) * spp * step)
        pt = w[k0:k1].long().t() @ x[:, k0:k1].long().t()        # (N, M)
        partial.append(tref.wrap_int32(pt).long())
    acc = torch.zeros_like(partial[0])
    for p in rng.permutation(parts):
        acc = tref.wrap_int32(acc + partial[p]).long()
    return tmg.grau_plain(acc.t().contiguous().to(torch.int32), regs,
                          num_exponents=spec.num_exponents, qmin=spec.qmin,
                          qmax=spec.qmax).to(tmg.out_dtype(spec.qmin))


@pytest.mark.parametrize("m,k,n,act,signed", [
    (33, 1100, 96, "silu", True), (70, 1300, 200, "relu", False),
    (5, 600, 130, "silu", True), (1, 520, 257, "relu", False)])
def test_split_k_and_swapped_operands_match_reference_kernel(m, k, n, act,
                                                             signed):
    """Ragged M, K and N whose plan splits K into 2-3 parts: the emulated
    split and operand swap equal the reference's Pallas kernel (interpret
    mode) and the port's plain version byte for byte, on both buses."""
    jspec, tspec = _fitted(act, signed)
    rng = np.random.default_rng(m * 31 + k + n)
    x, w = _operands(rng, (m, k), k, n)
    plan = tmg.plan(m, n, k)
    assert plan[1] > 1
    got = _split_swap_emulation(torch.from_numpy(x), torch.from_numpy(w),
                                tspec.packed("cpu"), tspec, plan, rng)
    want = np.asarray(jops.matmul_grau(jnp.asarray(x), jnp.asarray(w), jspec,
                                       tiles=(64, 128, 256), interpret=True))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.matmul_grau(torch.from_numpy(x), torch.from_numpy(w),
                         tspec).numpy(), want)


def test_split_combine_wraps_modulo_2_32_in_any_order():
    """Per-part int32 partial sums near the int32 edges, combined in every
    order of a shuffle, give the int32 wrap of their exact total, which is
    what the reference's int32 dot gives for the whole sum."""
    rng = np.random.default_rng(11)
    parts = rng.integers(-(1 << 31), 1 << 31, size=(7, 64), dtype=np.int64)
    parts[:, 0], parts[:, 1], parts[:, 2] = (1 << 31) - 1, -(1 << 31), -1
    want = tref.wrap_int32(torch.from_numpy(parts.sum(0)))
    for _ in range(5):
        acc = torch.zeros(64, dtype=torch.int64)
        for p in rng.permutation(len(parts)):
            acc = tref.wrap_int32(acc + torch.from_numpy(parts[p])).long()
        assert torch.equal(acc.to(torch.int32), want)
