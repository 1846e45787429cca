"""PyTorch port vs the JAX reference: GRAU fitting, the integer datapath, the
standalone unit's CPU path and the float -> int32 epilogue cast.

Inputs are made with numpy from a seed and fed to both packages; every
integer result must match bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import grau as jgrau  # noqa: E402
from repro.core.build import build_grau as jbuild_grau  # noqa: E402
from repro.core.folding import fold as jfold  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.pwlf.spec import make_spec as jmake_spec  # noqa: E402
from repro_torch.core import grau as tgrau  # noqa: E402
from repro_torch.core.build import build_grau as tbuild_grau  # noqa: E402
from repro_torch.core.folding import fold as tfold  # noqa: E402
from repro_torch.kernels import grau as tgrau_kernel  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.nn.common import build_lm_grau  # noqa: E402
from repro_torch.pwlf.spec import make_spec as tmake_spec  # noqa: E402

I32 = np.iinfo(np.int32)
SPEC_FIELDS = ("breakpoints", "enc", "sign", "bias", "pre_shift")
STATIC_FIELDS = ("num_segments", "num_exponents", "out_bits", "out_signed")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_spec(js, ts):
    for f in STATIC_FIELDS:
        assert getattr(js, f) == getattr(ts, f), f
    for f in SPEC_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy(), err_msg=f)


def random_specs(rng, *, out_signed=None, pre_lo=-2, pre_hi=9):
    """The same random register file in both packages."""
    segments = int(rng.integers(1, 9))
    num_exponents = int(rng.integers(1, 9))
    out_bits = int(rng.choice([2, 4, 8]))
    signed = bool(rng.integers(0, 2)) if out_signed is None else out_signed
    bps = (np.sort(rng.choice(np.arange(-(1 << 20), 1 << 20),
                              size=segments - 1, replace=False))
           if segments > 1 else np.empty((0,), np.int64))
    kw = dict(breakpoints=bps,
              enc=rng.integers(0, 2, size=(segments, num_exponents)),
              sign=rng.choice([-1, 1], size=segments),
              bias=rng.integers(-100, 101, size=segments),
              pre_shift=int(rng.integers(pre_lo, pre_hi)),
              num_exponents=num_exponents, out_bits=out_bits,
              out_signed=signed)
    return jmake_spec(**kw), tmake_spec(**kw)


def int_inputs(rng, shape, bound=1 << 20):
    x = rng.integers(-bound, bound, size=shape, dtype=np.int64)
    flat = x.reshape(-1)
    edges = [I32.min, I32.min + 1, -1, 0, 1, I32.max - 1, I32.max]
    flat[:len(edges)] = edges
    return x.astype(np.int32)


@pytest.mark.parametrize("act,s_out,segments", [
    ("silu", 2**-4, 6), ("silu", 2**-4, 8), ("gelu", 2**-4, 6),
    ("gelu", 2**-4, 8), ("tanh", 2**-7, 6), ("tanh", 2**-7, 8)])
def test_build_grau_matches_reference_on_golden_fits(act, s_out, segments):
    kw = dict(mac_range=(-30000, 30000), segments=segments, num_exponents=8,
              mode="apot", bias_mode="lsq")
    jr = jbuild_grau(jfold(act, s_in=2**-10, s_out=s_out, out_bits=8), **kw)
    tr = tbuild_grau(tfold(act, s_in=2**-10, s_out=s_out, out_bits=8), **kw)
    _same_spec(jr.spec, tr.spec)
    assert jr.window == tr.window
    assert jr.int_rms == tr.int_rms and jr.int_max_abs == tr.int_max_abs


@pytest.mark.parametrize("seed", range(8))
def test_grau_apply_int_bit_exact_random_specs(seed):
    rng = np.random.default_rng(seed)
    js, ts = random_specs(rng)
    x = int_inputs(rng, (64, 33))
    want = np.asarray(jgrau.grau_apply_int(jnp.asarray(x), js))
    got = tgrau.grau_apply_int(torch.from_numpy(x), ts).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_shift_counts_31_to_40_and_int32_edges(seed):
    """pre_shift near 32 drives right-shift counts 31..40 (sign fill) and
    large x with left shifts wraps int32; both packages must agree."""
    rng = np.random.default_rng(100 + seed)
    js, ts = random_specs(rng, pre_lo=28, pre_hi=34)
    x = int_inputs(rng, (16, 40), bound=1 << 31)
    want = np.asarray(jgrau.grau_apply_int(jnp.asarray(x), js))
    got = tgrau.grau_apply_int(torch.from_numpy(x), ts).numpy()
    np.testing.assert_array_equal(got, want)
    js2, ts2 = random_specs(rng, pre_lo=-40, pre_hi=-28)   # left shifts >= 28
    want = np.asarray(jgrau.grau_apply_int(jnp.asarray(x), js2))
    got = tgrau.grau_apply_int(torch.from_numpy(x), ts2).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,signed", [(0, True), (1, False), (2, True),
                                         (3, False)])
def test_ops_grau_matches_reference_kernel(seed, signed):
    """The port's unit (plain path on a CPU tensor) against the reference's
    Pallas kernel in interpret mode, int8 and uint8 buses."""
    rng = np.random.default_rng(200 + seed)
    js, ts = random_specs(rng, out_signed=signed, pre_lo=-3, pre_hi=36)
    x = int_inputs(rng, (3, 5, 37), bound=1 << 31)
    want = np.asarray(jops.grau(jnp.asarray(x), js, interpret=True))
    got = tops.grau(torch.from_numpy(x), ts)
    assert got.dtype == (torch.int8 if signed else torch.uint8)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.grau_ref(torch.from_numpy(x), ts).numpy(),
                                  want)


def test_grau_plain_on_packed_registers_matches_spec_path():
    rng = np.random.default_rng(7)
    for _ in range(6):
        _, ts = random_specs(rng, pre_lo=-36, pre_hi=36)
        x = torch.from_numpy(int_inputs(rng, (8, 21), bound=1 << 31))
        got = tgrau_kernel.grau_plain(
            x, ts.packed("cpu"), num_exponents=ts.num_exponents,
            qmin=ts.qmin, qmax=ts.qmax)
        np.testing.assert_array_equal(got.numpy(),
                                      tgrau.grau_apply_int(x, ts).numpy())


def test_unit_rejects_wrong_inputs():
    _, ts = random_specs(np.random.default_rng(0))
    regs = ts.packed("cpu")
    kw = dict(num_exponents=ts.num_exponents, qmin=ts.qmin, qmax=ts.qmax)
    with pytest.raises(ValueError):
        tgrau_kernel.grau_unit(torch.zeros(4, 4, dtype=torch.int64), regs,
                               **kw)
    with pytest.raises(ValueError):
        tgrau_kernel.grau_unit(torch.zeros(4, dtype=torch.int32), regs, **kw)


def test_float_to_int_saturation_matches_reference():
    """round-half-even, +-3e9 saturate, NaN -> 0: the epilogue's cast into
    the MAC domain must match the reference's round().astype(int32)."""
    vals = np.array([3e9, -3e9, np.nan, np.inf, -np.inf, 2.5, 3.5, -2.5,
                     0.49999997, 2147483520.0, -2147483648.0, 1e-3],
                    np.float32)
    want = np.asarray(jnp.round(jnp.asarray(vals)).astype(jnp.int32))
    got = tref.round_to_int32(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    g = build_lm_grau("identity")
    jg_spec = jmake_spec(
        breakpoints=np.asarray(g.spec.breakpoints)[:g.spec.num_segments - 1],
        enc=np.asarray(g.spec.enc)[:g.spec.num_segments,
                                   :g.spec.num_exponents],
        sign=np.asarray(g.spec.sign)[:g.spec.num_segments],
        bias=np.asarray(g.spec.bias)[:g.spec.num_segments],
        pre_shift=int(g.spec.pre_shift), num_exponents=g.spec.num_exponents,
        out_bits=g.spec.out_bits, out_signed=g.spec.out_signed)
    o = vals * np.float32(g.s_in)
    want = np.asarray(jref.attn_output_quant(jnp.asarray(o), jg_spec, g.s_in))
    got = tref.attn_output_quant(torch.from_numpy(o), g.spec, g.s_in).numpy()
    np.testing.assert_array_equal(got, want)


def test_surrogate_forward_and_ste_match_reference():
    import jax
    from repro.nn.common import build_lm_grau as jbuild_lm_grau
    jg, tg = jbuild_lm_grau("silu"), build_lm_grau("silu")
    _same_spec(jg.spec, tg.spec)
    z = np.random.default_rng(3).normal(scale=4.0, size=(256,)).astype(
        np.float32)
    want = np.asarray(jg(jnp.asarray(z)))
    want_grad = np.asarray(jax.grad(lambda v: jnp.sum(jg(v)))(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    out = tg(zt)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), want_grad, rtol=1e-6,
                               atol=1e-7)
