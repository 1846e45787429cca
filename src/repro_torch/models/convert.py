"""Map the JAX package's LM and vision parameters onto the port's.

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
`bits`), leaf by leaf. `opt_state_from_reference` carries an AdamW state
(train/optim.py) across, and `vision_from_reference` the SFC/CNV
parameters of models/vision.py. Every converter places its tensors on the
device given, or on CUDA (models/lm.resolve_device).
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
                   device=None) -> Dict[str, Any]:
    """Port parameters from the reference tree onto `device` (default:
    CUDA, see models/lm.resolve_device); each leaf keeps its dtype."""
    from repro_torch.models.lm import resolve_device
    device = resolve_device(device)

    repeats = {f"group{gi}": n for gi, (_, n) in enumerate(cfg.groups)}
    return _unstack(ref_params, repeats, device)


def _unstack(ref_tree: Dict[str, Any], repeats: Dict[str, int], device):
    """The reference's tree with each group's stacked leading axis unrolled
    into a list of `repeats[group]` per-repeat trees."""
    def leaf(a):
        return _tensor(a, device)

    out: Dict[str, Any] = {}
    for name, val in ref_tree.items():
        if not name.startswith("group"):
            out[name] = _tree(val, leaf)
    for name, n in repeats.items():
        out[name] = [_tree(ref_tree[name],
                           lambda a, r=r: leaf(np.asarray(a)[r]))
                     for r in range(n)]
    return out


def opt_state_from_reference(ref_opt_state, params_like: Dict[str, Any], *,
                             device=None):
    """Port a reference train/optim.OptState (step, f32 moments m and v
    shaped like the stacked parameters) onto `device` (default: CUDA, see
    models/lm.resolve_device), grouped like the port's `params_like`, so a
    run can continue the reference's optimizer state."""
    from repro_torch.models.lm import resolve_device
    from repro_torch.train.optim import OptState
    device = resolve_device(device)
    repeats = {k: len(v) for k, v in params_like.items()
               if k.startswith("group")}
    return OptState(
        step=torch.tensor(int(np.asarray(ref_opt_state.step)),
                          dtype=torch.int32, device=device),
        m=_unstack(ref_opt_state.m, repeats, device),
        v=_unstack(ref_opt_state.v, repeats, device))


def pools_from_reference(ref_caches, *, device=None):
    """Port a reference paged pool tree (a tuple per group of per-layer
    leaves stacked over repeats): float PagedKVCache leaves and quantized
    ones (payload, exponent planes and `bits`), onto `device` (default:
    CUDA, see models/lm.resolve_device)."""
    from repro_torch.models.lm import resolve_device
    device = resolve_device(device)

    def pool(c):
        if hasattr(c, "k_exp"):
            return QuantPagedKVCache(
                _tensor(c.k, device), _tensor(c.v, device),
                _tensor(c.k_exp, device), _tensor(c.v_exp, device),
                bits=int(c.bits))
        return PagedKVCache(_tensor(c.k, device), _tensor(c.v, device))
    return tuple(tuple(pool(c) for c in group) for group in ref_caches)


def vision_from_reference(params: Dict[str, Any], cfg, *,
                          device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Port the reference's SFC/CNV parameters ({layer: {"w", "b"}}, numpy
    leaves or anything np.asarray accepts) for the VisionConfig `cfg` to
    tensors on `device` (default: CUDA, see models/lm.resolve_device).
    Layouts are kept: dense weights (in, out), conv weights HWIO."""
    from repro_torch.models.lm import resolve_device
    device = resolve_device(device)
    want = ([f"fc{i}" for i in range(len(cfg.widths) + 1)]
            if cfg.kind == "sfc" else
            [f"conv{i}" for i in range(len(cfg.conv_channels))] + ["fc_out"])
    if sorted(params) != sorted(want):
        raise ValueError(f"layers {sorted(params)} do not match {cfg.kind}: "
                         f"want {sorted(want)}")
    return {name: {k: _tensor(v, device) for k, v in layer.items()}
            for name, layer in params.items()}
