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


# ---------------------------------------------------------------------------
# the kernels' fired-stage datapath (csrc/grau_datapath.cuh), emulated
# ---------------------------------------------------------------------------

def _wrap32(v):
    """int64 -> the int32 value of its low 32 bits (still int64)."""
    return torch.remainder(v + (1 << 31), 1 << 32) - (1 << 31)


def _fired_stage_datapath(x, regs, *, num_exponents, qmin, qmax, warp=128):
    """csrc/grau_datapath.cuh's grau_eval4 as torch: enc[seg] masked to its
    low num_exponents bits; the stages visited are the union of the fired
    bits over a warp's `warp` elements (32 lanes x 4), lowest first, each
    element adding its own fired stages' shift terms (counts >= 32
    sign-fill to the right and give 0 to the left); int32 wrap-around.
    Returns (clamped int32 as int64, most stages a warp visited)."""
    from repro_torch.pwlf.spec import (MAX_SEGMENTS, REG_BIAS, REG_BP,
                                       REG_ENC, REG_PRE, REG_SIGN)
    x64, r = x.reshape(-1).long(), regs.long()
    seg = (x64[..., None] > r[REG_BP:REG_BP + MAX_SEGMENTS - 1]).sum(-1)
    bits = r[REG_ENC:REG_ENC + MAX_SEGMENTS][seg] & ((1 << num_exponents) - 1)
    pre = int(r[REG_PRE])
    pad = -x64.numel() % warp
    acc = torch.zeros_like(x64)
    visited = torch.zeros(-(-x64.numel() // warp), dtype=torch.int64)
    for k in range(32):
        fire = ((bits >> k) & 1) != 0
        in_warp = torch.cat([fire, fire.new_zeros(pad)]).view(-1, warp).any(1)
        if not bool(in_warp.any()):
            continue
        visited += in_warp.long()
        s = pre + k
        term = (x64 >> min(s, 31) if s >= 0 else
                torch.zeros_like(x64) if -s >= 32 else _wrap32(x64 << -s))
        acc = torch.where(fire, _wrap32(acc + term), acc)
    y = _wrap32(r[REG_SIGN:REG_SIGN + MAX_SEGMENTS][seg] * acc
                + r[REG_BIAS:REG_BIAS + MAX_SEGMENTS][seg])
    return y.clamp(qmin, qmax).reshape(x.shape), int(visited.max())


@pytest.mark.parametrize("seed,pre", [(0, (28, 34)), (1, (-40, -28)),
                                      (2, (-3, 36)), (3, (28, 34))])
def test_fired_stage_loop_matches_plain_and_reference_kernel(seed, pre):
    """The kernels' datapath visits only the stages that fire. Emulated with
    enc words carrying stray bits above num_exponents (bit 31 included,
    which the mask drops) and shift counts 31-40 both ways, it equals
    grau_plain on the clean register file and the reference's grau_pallas
    (interpret mode) on the same stray-bit words, byte for byte; a warp
    visits no stage that no segment of the unit fires."""
    from repro.kernels.grau import grau_pallas
    from repro_torch.pwlf.spec import MAX_SEGMENTS, REG_ENC
    rng = np.random.default_rng(300 + seed)
    for _ in range(3):
        js, ts = random_specs(rng, pre_lo=pre[0], pre_hi=pre[1])
        ne = ts.num_exponents
        x = torch.from_numpy(int_inputs(rng, (24, 37), bound=1 << 31))
        clean = ts.packed("cpu")
        dirty = clean.clone()
        stray = rng.integers(1, 1 << (31 - ne), size=MAX_SEGMENTS) << ne
        stray[0] |= 1 << (31 - ne)          # the sign bit of word 0
        dirty[REG_ENC:REG_ENC + MAX_SEGMENTS] |= torch.from_numpy(
            (stray.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
            .view(np.int32))
        kw = dict(num_exponents=ne, qmin=ts.qmin, qmax=ts.qmax)
        got, passes = _fired_stage_datapath(x, dirty, **kw)
        want = tgrau_kernel.grau_plain(x, clean, **kw)
        np.testing.assert_array_equal(got.numpy(), want.long().numpy())
        union = 0
        for e in clean[REG_ENC:REG_ENC + MAX_SEGMENTS].numpy():
            union |= int(e) & 0xFFFFFFFF
        assert passes <= bin(union).count("1") <= ne
        d = dirty.numpy()
        ref = np.asarray(grau_pallas(
            jnp.asarray(x.numpy()), jnp.asarray(d[0:7]),
            jnp.asarray(d[REG_ENC:REG_ENC + MAX_SEGMENTS]),
            jnp.asarray(d[15:23]), jnp.asarray(d[23:31]), jnp.asarray(d[31]),
            num_exponents=ne, qmin=ts.qmin, qmax=ts.qmax, block=(8, 128),
            interpret=True))
        np.testing.assert_array_equal(
            got.numpy().astype(np.int64), ref.astype(np.int64))


def test_fired_stage_loop_on_fitted_units_runs_few_passes():
    """On the fitted APoT units of the quickstart and the LM (6 segments, 8
    exponents) a segment fires 0-4 of the 8 stages and all segments
    together 7 and 5 of them: a warp visits at most those, where the
    reference's pipeline tests all 8; a warp whose elements all fall in
    segments that fire nothing (beyond the fitted MAC range) visits none."""
    from repro_torch.pwlf.spec import MAX_SEGMENTS, REG_ENC
    js = jbuild_grau(jfold("silu", s_in=2 ** -10, s_out=2 ** -4, out_bits=8),
                     mac_range=(-30000, 30000), segments=6, num_exponents=8,
                     mode="apot", bias_mode="lsq").spec
    ts = tbuild_grau(tfold("silu", s_in=2 ** -10, s_out=2 ** -4, out_bits=8),
                     mac_range=(-30000, 30000), segments=6, num_exponents=8,
                     mode="apot", bias_mode="lsq").spec
    for spec in (ts, build_lm_grau("silu").spec):
        regs = spec.packed("cpu")
        x = torch.from_numpy(int_inputs(np.random.default_rng(9), (64, 64),
                                        bound=1 << 17))
        kw = dict(num_exponents=spec.num_exponents, qmin=spec.qmin,
                  qmax=spec.qmax)
        got, passes = _fired_stage_datapath(x, regs, **kw)
        np.testing.assert_array_equal(
            got.numpy(), tgrau_kernel.grau_plain(x, regs, **kw).long().numpy())
        enc = [int(e) for e in regs[REG_ENC:REG_ENC + MAX_SEGMENTS]]
        union = 0
        for e in enc:
            union |= e
        assert max(bin(e).count("1") for e in enc) <= 4
        assert 1 <= passes <= bin(union).count("1") < spec.num_exponents
        far = torch.full((4, 64), 1 << 30, dtype=torch.int32)   # top segment
        got, passes = _fired_stage_datapath(far, regs, **kw)
        np.testing.assert_array_equal(
            got.numpy(), tgrau_kernel.grau_plain(far, regs, **kw).long().numpy())
        assert passes == bin(enc[spec.num_segments - 1]).count("1")
    np.testing.assert_array_equal(np.asarray(js.enc), ts.enc.numpy())


def test_right_shifts_compose_as_the_kernels_use_them():
    """The kernels' pre-shift >= 0 path computes stage k's term as (x >>
    min(pre, 31)) >> k; that equals the pinned x >> min(pre + k, 31) for
    every int32 x, pre 0-40 and stage 0-15."""
    x = torch.from_numpy(int_inputs(np.random.default_rng(5), (4096,),
                                    bound=1 << 31))
    for pre in range(41):
        y = torch.bitwise_right_shift(x, min(pre, 31))
        for k in range(16):
            assert torch.equal(torch.bitwise_right_shift(y, k),
                               tgrau.shift_term(x, pre + k))
