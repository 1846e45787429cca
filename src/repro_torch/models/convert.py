"""Map the JAX package's LM parameters onto the port's.

The reference's `repro.models.lm.init_lm` returns nested dicts whose group
leaves carry a leading `stack` axis (one entry per repeat, for lax.scan).
The port keeps one dict per repeat instead. Every leaf keeps its layout
(`wq (d, h, hd)`, `wo (h, hd, d)`, `embed (vocab, d)`, ...), so the same
weights drive both packages. The input may hold numpy arrays or anything
`np.asarray` accepts; this module never imports the reference.

Packed trees carry over too: a reference QuantWeight leaf (anything with
`q`, `e`, `bits`, `caxis`, `kdim`, `tile`) becomes the port's, payload and
exponents converted and the static fields kept, and `pools_from_reference`
converts a reference pool tree, float or quantized (`k_exp`, `v_exp`,
`bits`), leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.nn.attention import PagedKVCache, QuantPagedKVCache
from repro_torch.quant.weights import QuantWeight

_QW_FIELDS = ("q", "e", "bits", "caxis", "kdim", "tile")


def _is_packed(x) -> bool:
    return all(hasattr(x, f) for f in _QW_FIELDS)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if _is_packed(x):
        return QuantWeight(q=fn(x.q), e=fn(x.e), bits=int(x.bits),
                           caxis=int(x.caxis), kdim=int(x.kdim),
                           tile=int(x.tile))
    return fn(x)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def from_reference(ref_params: Dict[str, Any], cfg: ModelConfig, *,
                   device="cpu") -> Dict[str, Any]:
    """Port parameters from the reference tree; each leaf keeps its dtype."""
    def leaf(a):
        return _tensor(a, device)

    out: Dict[str, Any] = {}
    for name, val in ref_params.items():
        if not name.startswith("group"):
            out[name] = _tree(val, leaf)
    for gi, (_, repeats) in enumerate(cfg.groups):
        stacked = ref_params[f"group{gi}"]
        out[f"group{gi}"] = [_tree(stacked, lambda a, r=r: leaf(np.asarray(a)[r]))
                             for r in range(repeats)]
    return out


def pools_from_reference(ref_caches, *, device="cpu"):
    """Port a reference paged pool tree (a tuple per group of per-layer
    leaves stacked over repeats): float PagedKVCache leaves and quantized
    ones (payload, exponent planes and `bits`)."""
    def pool(c):
        if hasattr(c, "k_exp"):
            return QuantPagedKVCache(
                _tensor(c.k, device), _tensor(c.v, device),
                _tensor(c.k_exp, device), _tensor(c.v_exp, device),
                bits=int(c.bits))
        return PagedKVCache(_tensor(c.k, device), _tensor(c.v, device))
    return tuple(tuple(pool(c) for c in group) for group in ref_caches)
