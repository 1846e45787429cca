"""Map the JAX package's LM parameters onto the port's.

The reference's `repro.models.lm.init_lm` returns nested dicts whose group
leaves carry a leading `stack` axis (one entry per repeat, for lax.scan).
The port keeps one dict per repeat instead. Every leaf keeps its layout
(`wq (d, h, hd)`, `wo (h, hd, d)`, `embed (vocab, d)`, ...), so the same
weights drive both packages. The input may hold numpy arrays or anything
`np.asarray` accepts; this module never imports the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def from_reference(ref_params: Dict[str, Any], cfg: ModelConfig, *,
                   device="cpu") -> Dict[str, Any]:
    """Port parameters from the reference tree; each leaf keeps its dtype."""
    def leaf(a):
        return torch.from_numpy(np.array(a)).to(device)

    out: Dict[str, Any] = {}
    for name, val in ref_params.items():
        if not name.startswith("group"):
            out[name] = _tree(val, leaf)
    for gi, (_, repeats) in enumerate(cfg.groups):
        stacked = ref_params[f"group{gi}"]
        out[f"group{gi}"] = [_tree(stacked, lambda a, r=r: leaf(np.asarray(a)[r]))
                             for r in range(repeats)]
    return out
