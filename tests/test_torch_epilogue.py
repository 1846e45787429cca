"""The CUDA kernels' fused GRAU epilogue, emulated step by step on the CPU.

`kernel_epilogue` is the arithmetic the matmul_wq and paged-attention
kernels run on their f32 sums; the CPU tests of those kernels' split
decompositions (test_torch_matmul_wq, test_torch_paged_attention) import it
to hold the epilogue over an emulated sum. Here it is held, bit for bit,
against the port's attn_output_quant and the reference's on the values where
a rounding or a cast could part them: halfway points, the int32 saturation
edges, infinities and NaN.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.build import build_grau as jbuild_grau  # noqa: E402
from repro.core.folding import fold as jfold  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.build import build_grau as tbuild_grau  # noqa: E402
from repro_torch.core.folding import fold as tfold  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def kernel_epilogue(acc, spec, s_in):
    """The kernels' fused epilogue step by step, as the CUDA code does it:
    acc * f32(1/s_in) in f32, rounded half to even and saturated to int32
    (__float2int_rn, NaN -> 0), then the datapath on the packed register
    file."""
    from repro_torch.kernels.grau import grau_plain, out_dtype
    y = acc.float() * torch.tensor(tref.inv_scale(s_in), dtype=torch.float32)
    xq = torch.nan_to_num(y.double(), nan=0.0).round().clamp(-2**31,
                                                            2**31 - 1)
    return grau_plain(xq.to(torch.int32), spec.packed(torch.device("cpu")),
                      num_exponents=spec.num_exponents, qmin=spec.qmin,
                      qmax=spec.qmax).to(out_dtype(spec.qmin))


def _spec_pair(act, out_signed, s_out):
    kw = dict(mac_range=(-30000, 30000), segments=6, num_exponents=8,
              mode="apot", bias_mode="lsq")
    fk = dict(s_in=2**-10, s_out=s_out, out_bits=8, out_signed=out_signed)
    return (jbuild_grau(jfold(act, **fk), **kw).spec,
            tbuild_grau(tfold(act, **fk), **kw).spec)


def _edge_values(s_in):
    """f32 sums whose scaled value lands on halves, near the int32 edges,
    beyond them, on the GRAU unit's working range, and at random."""
    rng = np.random.default_rng(5)
    halves = (np.arange(-40, 41) + 0.5) * s_in
    edges = np.array([2.0**31, 2.0**31 - 128, -2.0**31, -2.0**31 - 256,
                      3e38, -3e38]) * s_in
    rand = rng.normal(size=512) * 30000 * s_in
    return np.concatenate([halves, edges, rand]).astype(np.float32)


@pytest.mark.parametrize("s_in", [2**-8, 0.01, 2**-10])
@pytest.mark.parametrize("act,out_signed,s_out", [("silu", True, 2**-4),
                                                  ("relu", False, 2**-5)])
def test_kernel_epilogue_is_attn_output_quant(s_in, act, out_signed, s_out):
    js, ts = _spec_pair(act, out_signed, s_out)
    acc = _edge_values(s_in)
    got = kernel_epilogue(torch.from_numpy(acc), ts, s_in).numpy()
    np.testing.assert_array_equal(
        got, tref.attn_output_quant(torch.from_numpy(acc), ts, s_in).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jref.attn_output_quant(jnp.asarray(acc), js, s_in)))


def test_kernel_epilogue_non_finite_as_the_port_oracle():
    """inf saturates and NaN quantizes as 0, as __float2int_rn does and as
    the port's round_to_int32 states."""
    _, ts = _spec_pair("silu", True, 2**-4)
    acc = torch.tensor([float("inf"), float("-inf"), float("nan"), 0.0])
    assert torch.equal(kernel_epilogue(acc, ts, 0.01),
                       tref.attn_output_quant(acc, ts, 0.01))
