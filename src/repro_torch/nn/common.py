"""Shared NN substrate: initializers, norms, activations, the GRAU activation.

Parameters are plain nested dicts of tensors (the JAX package's layout, one
dict per layer instead of a stacked scan axis), so models/convert.py can map
the reference's parameters across leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # Phi(-2)
_PHI_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))    # Phi(+2)


def trunc_normal(shape, stddev: float, gen: torch.Generator, *, device,
                 dtype) -> torch.Tensor:
    """stddev * (standard normal truncated to [-2, 2]), by inverse-CDF
    sampling from `gen` on `device` (drawn in f32, then cast); on the meta
    device an empty tensor of the shape, nothing drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(2.0 * _PHI_LO - 1.0, 2.0 * _PHI_HI - 1.0, generator=gen)
    x = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(stddev).to(dtype)


def init_param(shape, gen: torch.Generator, *, init: str = "fanin",
               scale: float = 1.0, device, dtype) -> torch.Tensor:
    """The JAX package's ParamBuilder.add initializers: zeros, ones,
    fan-in-scaled truncated normal, or a plain-scale truncated normal."""
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "fanin":
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        return trunc_normal(shape, scale / np.sqrt(max(fan_in, 1)), gen,
                            device=device, dtype=dtype)
    if init == "normal":
        return trunc_normal(shape, scale, gen, device=device, dtype=dtype)
    raise ValueError(init)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rmsnorm(x, weight, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def layernorm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {
        "relu": F.relu,
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softplus": F.softplus,
        "identity": lambda x: x,
    }[name]


@dataclasses.dataclass(frozen=True)
class GRAUActivation:
    """A GRAU register file + the dequant scales that frame it.

    Forward semantics (QAT surrogate): the float pre-activation z is mapped to
    the MAC integer domain (a = z / s_in), pushed through the exact integer
    PWL shift-add function (with straight-through gradients along the
    realized segment slopes), and dequantized (q * s_out).
    """
    spec: Any          # GRAUSpec
    s_in: float
    s_out: float
    name: str = "grau"

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        from repro_torch.core.grau import grau_surrogate
        a = z.float() / self.s_in
        q = grau_surrogate(a, self.spec)
        return (q * self.s_out).to(z.dtype)

    def to(self, device) -> "GRAUActivation":
        return dataclasses.replace(self, spec=self.spec.to(device))


def build_lm_grau(
    act_name: str,
    *,
    segments: int = 6,
    num_exponents: int = 8,
    mode: str = "apot",
    out_bits: int = 8,
    z_absmax: float = 16.0,
    bias_mode: str = "lsq",
) -> GRAUActivation:
    """Build a GRAU activation for a transformer MLP nonlinearity.

    Calibration: pre-activations of normalized transformer MLPs live within a
    few tens; we fit over z in [-z_absmax, z_absmax] mapped to a +/-2^12 MAC
    integer domain, and pick s_out to cover the activation's output range at
    the target bit width. The register file is built on the host (CPU).
    """
    from repro_torch.core.build import build_grau
    from repro_torch.core.folding import ACTIVATIONS, fold

    s_in = z_absmax / 4096.0
    f = ACTIVATIONS[act_name]
    zs = np.linspace(-z_absmax, z_absmax, 8193)
    out_absmax = float(np.max(np.abs(f(zs))))
    qmax = (1 << (out_bits - 1)) - 1
    s_out = max(out_absmax, 1e-6) / qmax
    folded = fold(act_name, s_in=s_in, s_out=s_out, out_bits=out_bits)
    res = build_grau(
        folded, mac_range=(-4096.0, 4096.0), segments=segments,
        num_exponents=num_exponents, mode=mode, bias_mode=bias_mode,
        range_doubling=False,
    )
    return GRAUActivation(spec=res.spec, s_in=s_in, s_out=s_out,
                          name=f"grau-{mode}-{act_name}")


def make_activation(name: str, grau: Optional[GRAUActivation] = None):
    """Activation factory: exact float, or the GRAU QAT surrogate."""
    return grau if grau is not None else act_fn(name)


# ---------------------------------------------------------------------------
# Parameter trees (nested dicts / lists / NamedTuples of tensors)
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` (and the same-structured `rest`), keeping
    the structure: dicts, lists, tuples and NamedTuples are nodes, anything
    else a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_flatten(tree, prefix: str = ""):
    """[(path, leaf)] in a fixed order; a path joins dict keys, list
    indices and NamedTuple field names with "/" (the reference checkpoint's
    key scheme)."""
    if isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += tree_flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out
