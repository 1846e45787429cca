"""Quantizers — the integer-aware QAT substrate: integer ranges, the per-layer
settings quant/policy.py hands out, and symmetric uniform quantization with
straight-through estimators (per-tensor or per-channel scales, optionally
rounded up to a power of two) for the vision models' QAT.

The JAX package's `jax.custom_vjp`s become `torch.autograd.Function`s. Two
details keep the gradients those of the reference: `fake_quant` clips with
`minimum(maximum(...))`, whose gradient splits evenly on a tie as JAX's does
(the largest element of a max-abs-calibrated tensor lands exactly on qmax;
`torch.clamp` would pass it the whole gradient), and the scale is computed
on the detached input.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.quant.pot import exp2i


def qrange(bits: int, signed: bool = True):
    if signed:
        return -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return 0, (1 << bits) - 1


class _SteRound(torch.autograd.Function):
    """round half to even forward, identity gradient."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return _SteRound.apply(x)


@dataclasses.dataclass(frozen=True)
class QConfig:
    bits: int = 8
    signed: bool = True
    per_channel: bool = False
    channel_axis: int = -1
    pot_scale: bool = False   # round scales up to a power of two (shift-only
    # dequant, the GRAU / quant.kv convention); scale is then exactly 2^e

    @property
    def qmin(self):
        return qrange(self.bits, self.signed)[0]

    @property
    def qmax(self):
        return qrange(self.bits, self.signed)[1]


def scale_exponent(scale: torch.Tensor) -> torch.Tensor:
    """Integer exponent e with scale == 2^e (for power-of-two scales)."""
    m, f = torch.frexp(scale.to(torch.float32))
    return torch.where(m == 0.5, f - 1, f).to(torch.int32)


def pot_round_scale(scale: torch.Tensor) -> torch.Tensor:
    """Round a positive scale up to the smallest covering power of two.

    frexp: s = m * 2^f with m in [0.5, 1), so the cover is 2^f, or s itself
    when m == 0.5. Rounding up only widens the representable range. 2^e is
    built by bits (quant/pot.exp2i), never by exp2 on a float."""
    e = scale_exponent(scale)
    return exp2i(torch.clamp(e, -126, 126)).to(scale.dtype)


def compute_scale(x: torch.Tensor, cfg: QConfig) -> torch.Tensor:
    """Max-abs calibration scale (symmetric; power-of-two when
    cfg.pot_scale)."""
    if cfg.per_channel:
        axis = cfg.channel_axis % x.dim()
        dims = tuple(i for i in range(x.dim()) if i != axis)
        amax = torch.amax(torch.abs(x), dim=dims, keepdim=True)
    else:
        amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-8) / cfg.qmax
    return pot_round_scale(scale) if cfg.pot_scale else scale


def quantize(x: torch.Tensor, scale: torch.Tensor,
             cfg: QConfig) -> torch.Tensor:
    """Real quantization to integers (inference path)."""
    q = torch.clamp(torch.round(x / scale), cfg.qmin, cfg.qmax)
    if cfg.signed:
        dt = torch.int8 if cfg.bits <= 8 else torch.int16
    else:
        dt = torch.uint8 if cfg.bits <= 8 else torch.uint16
    return q.to(dt)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quant(x: torch.Tensor, cfg: QConfig,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QAT fake quantization: float in/out, STE gradient, clipping."""
    if cfg.bits >= 32:
        return x
    s = compute_scale(x.detach(), cfg) if scale is None else scale
    lo = torch.tensor(float(cfg.qmin), dtype=x.dtype, device=x.device)
    hi = torch.tensor(float(cfg.qmax), dtype=x.dtype, device=x.device)
    y = torch.minimum(torch.maximum(ste_round(x / s), lo), hi) * s
    return y.to(x.dtype)


class _Binarize(torch.autograd.Function):
    """sign (0 -> +1) forward; the gradient passes where |x| <= 1."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return torch.where(v >= 0, 1.0, -1.0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return g * (torch.abs(v) <= 1.0).to(g.dtype)


def binarize(x: torch.Tensor) -> torch.Tensor:
    """1-bit sign quantization with STE clip gradient (BNN path)."""
    return _Binarize.apply(x)
