"""GRAU functional core — integer datapath reference + float training surrogate.

`grau_reference_int` is the bit-exact executable specification of the RTL in
the paper's Figs. 4-6 (comparators -> shifter pipeline -> sign -> bias ->
clamp). The CUDA kernel in repro_torch/kernels/grau.py must match it exactly;
the numpy variant below is used for host-side verification of fitted specs.

`grau_surrogate` is the float PWL function with a straight-through estimator,
used during QAT so gradients flow through the linear segments.

int32 semantics (shared with the kernels): sums and products wrap modulo
2**32; a right shift by 32 or more fills with the sign bit (the count is
clamped to 31); a left shift by 32 or more gives 0.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.pwlf.spec import GRAUSpec, MAX_EXPONENTS


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def segment_index(x: torch.Tensor, spec: GRAUSpec) -> torch.Tensor:
    """seg = sum_i [x > bp_i] — the comparator bank. Padded bps are INT32_MAX."""
    bps = spec.breakpoints.to(x.device)
    return (x[..., None] > bps).sum(-1).to(torch.int32)


def shift_term(x: torch.Tensor, s: int) -> torch.Tensor:
    """One shifter stage: x >> s for s >= 0, x << -s for s < 0, with the
    int32 edge cases pinned (see module docstring)."""
    if s >= 0:
        return torch.bitwise_right_shift(x, min(s, 31))
    if -s >= 32:
        return torch.zeros_like(x)
    return torch.bitwise_left_shift(x, -s)


def shift_add(x: torch.Tensor, enc_row: torch.Tensor, pre_shift) -> torch.Tensor:
    """The 1-bit right-shifter pipeline: sum_k enc[k] * (x >> (pre_shift+k)).

    Arithmetic shift on signed ints (floor), exactly as cascaded RTL stages;
    a negative pre_shift + k is a left shift.
    """
    pre = int(pre_shift)
    acc = torch.zeros_like(x)
    for k in range(MAX_EXPONENTS):
        term = shift_term(x, pre + k)
        acc = acc + torch.where(enc_row[..., k] != 0, term, 0)
    return acc


def grau_apply_int(x: torch.Tensor, spec: GRAUSpec) -> torch.Tensor:
    """Apply one GRAU unit to int32 MAC outputs (plain torch; the kernels'
    oracle). Returns int32."""
    x = x.to(torch.int32)
    spec = spec.to(x.device)
    seg = segment_index(x, spec).long()
    acc = shift_add(x, spec.enc[seg], spec.pre_shift)
    y = spec.sign[seg] * acc + spec.bias[seg]
    return torch.clamp(y, spec.qmin, spec.qmax)


def grau_reference_int(x: np.ndarray, spec: GRAUSpec) -> np.ndarray:
    """Host-side (numpy, int64 accumulation) bit-exact reference."""
    x = np.asarray(x, np.int64)
    bps = _np(spec.breakpoints).astype(np.int64)
    seg = np.sum(x[..., None] > bps, axis=-1)
    enc = _np(spec.enc)
    pre = int(spec.pre_shift)
    acc = np.zeros_like(x)
    for k in range(enc.shape[1]):
        s = pre + k
        term = (x >> s) if s >= 0 else (x << -s)
        acc = acc + np.where(enc[seg, k] != 0, term, 0)
    y = _np(spec.sign).astype(np.int64)[seg] * acc + _np(spec.bias).astype(np.int64)[seg]
    return np.clip(y, spec.qmin, spec.qmax)


def grau_realized_pwl(spec: GRAUSpec):
    """Float PWL realized by a spec: (breakpoints, slopes, biases) tensors.

    slope[s] = sign[s] * sum_k enc[s,k] * 2^-(pre_shift+k). The powers of two
    are built exactly with ldexp (an exp2 approximation can be off by an ulp
    at some exponents).
    """
    k = torch.arange(MAX_EXPONENTS, device=spec.device)
    pots = torch.ldexp(torch.ones(MAX_EXPONENTS, device=spec.device),
                       -(spec.pre_shift.to(spec.device) + k))       # (E,)
    slopes = spec.sign.to(torch.float32) * (spec.enc.to(torch.float32) @ pots)
    return spec.breakpoints, slopes, spec.bias.to(torch.float32)


def _pwl_tables(spec: GRAUSpec, device):
    """(breakpoints as f32, slopes, biases) on `device`, built once per
    spec (the register file is immutable)."""
    def build():
        bps, slopes, biases = grau_realized_pwl(spec.to(device))
        return bps.to(torch.float32), slopes, biases
    return spec.memo(("pwl", str(torch.device(device))), build)


def _pwl(x: torch.Tensor, spec: GRAUSpec):
    """One segment lookup, one PWL pass: (segment slopes, unclamped y)."""
    bps, slopes, biases = _pwl_tables(spec, x.device)
    seg = (x[..., None] > bps.to(x.dtype)).sum(-1)
    slope = slopes[seg]
    return slope, slope * x + biases[seg]


def grau_apply_float(x: torch.Tensor, spec: GRAUSpec) -> torch.Tensor:
    """Float evaluation of the realized PWL (pre-rounding): surrogate forward."""
    _, y = _pwl(x, spec)
    return torch.clamp(y, float(spec.qmin), float(spec.qmax))


class _GRAUSurrogate(torch.autograd.Function):
    """QAT forward: rounded integer semantics; backward: PWL slope STE — the
    realized segment slope, zeroed where the output saturates (strict
    comparison against the unclamped value matches the clamp mask)."""

    @staticmethod
    def forward(ctx, x, spec):
        slope, y = _pwl(x, spec)
        in_range = (y > float(spec.qmin)) & (y < float(spec.qmax))
        ctx.save_for_backward(slope * in_range.to(x.dtype))
        return torch.round(torch.clamp(y, float(spec.qmin), float(spec.qmax)))

    @staticmethod
    def backward(ctx, g):
        (dydx,) = ctx.saved_tensors
        return g * dydx.to(g.dtype), None


def grau_surrogate(x: torch.Tensor, spec: GRAUSpec) -> torch.Tensor:
    """round(grau_apply_float(x)) with the straight-through gradient; when no
    gradient is being taken the forward alone runs."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GRAUSurrogate.apply(x, spec)
    return torch.round(grau_apply_float(x, spec))
