"""Folding BatchNorm + nonlinear activation + output re-quantization.

The GRAU unit's target function is never the bare activation: it is the whole
integer-in/integer-out map sitting between a MAC array and the next layer's
quantized input (the paper's "End-to-End MAC to Quant" column in Table II):

    a (int MAC output)
      -> z  = s_in * a                        de-quantize (s_in = s_act_in * s_w)
      -> z' = gamma * (z - mu)/sqrt(var+eps) + beta    (BN, if present)
      -> h  = f(z')                           nonlinear activation
      -> q  = clamp(round(h / s_out), qmin, qmax)      re-quantize

`fold` returns this scalar map as a numpy-callable suitable for
repro.pwlf.fit.fit_pwlf. Per-channel BN yields one folded function (and hence
one GRAUSpec register set) per channel — matching the paper's "activation
kernels" counting (ResNet-26: ~4904 units).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

ScalarFn = Callable[[np.ndarray], np.ndarray]


# ---------------------------------------------------------------------------
# Activation zoo (numpy; float64 domain for fitting)
# ---------------------------------------------------------------------------

def relu(x):
    return np.maximum(x, 0.0)


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.clip(x, -60, 60)))


def silu(x):
    return x * sigmoid(x)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))


def softplus(x):
    return np.logaddexp(0.0, x)


def tanh(x):
    return np.tanh(x)


ACTIVATIONS: dict[str, ScalarFn] = {
    "relu": relu,
    "sigmoid": sigmoid,
    "silu": silu,
    "gelu": gelu_tanh,
    "softplus": softplus,
    "tanh": tanh,
    "identity": lambda x: x,
}


@dataclasses.dataclass(frozen=True)
class BNParams:
    """Per-channel batchnorm statistics/affine for folding (scalars here: the
    fold is per-channel, one FoldedActivation per channel)."""
    gamma: float = 1.0
    beta: float = 0.0
    mean: float = 0.0
    var: float = 1.0
    eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class FoldedActivation:
    """The scalar int->int target function GRAU must approximate."""
    activation: str
    s_in: float                   # dequant scale of the MAC output
    s_out: float                  # requant scale of the quantized activation
    out_bits: int
    out_signed: bool = True
    bn: Optional[BNParams] = None

    @property
    def qmin(self) -> int:
        return -(1 << (self.out_bits - 1)) if self.out_signed else 0

    @property
    def qmax(self) -> int:
        return (1 << (self.out_bits - 1)) - 1 if self.out_signed else (1 << self.out_bits) - 1

    def __call__(self, a: np.ndarray) -> np.ndarray:
        """Float-valued folded map (pre-rounding; rounding happens at fit/eval)."""
        z = self.s_in * np.asarray(a, np.float64)
        if self.bn is not None:
            bn = self.bn
            z = bn.gamma * (z - bn.mean) / np.sqrt(bn.var + bn.eps) + bn.beta
        h = ACTIVATIONS[self.activation](z)
        return np.clip(h / self.s_out, self.qmin, self.qmax)

    def quantized(self, a: np.ndarray) -> np.ndarray:
        return np.clip(np.round(self(a)), self.qmin, self.qmax).astype(np.int64)


def fold(
    activation: str,
    *,
    s_in: float,
    s_out: float,
    out_bits: int,
    out_signed: bool = True,
    bn: Optional[BNParams] = None,
) -> FoldedActivation:
    if activation not in ACTIVATIONS:
        raise KeyError(f"unknown activation {activation!r}; have {sorted(ACTIVATIONS)}")
    return FoldedActivation(activation, s_in, s_out, out_bits, out_signed, bn)
