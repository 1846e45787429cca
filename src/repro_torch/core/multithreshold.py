"""Multi-Threshold (MT) activation unit — the paper's baseline (FINN/FINN-R).

An n-bit MT unit stores 2^n - 1 thresholds; the output is the count of
thresholds the MAC result exceeds (plus the representation offset for signed
outputs). It folds BN + activation + requant like GRAU, but:

  * hardware cost scales exponentially with output precision (Table VI:
    10206 LUTs pipelined / 255-deep pipeline at 8-bit; core/hwcost.py),
  * it can only realise monotonically increasing functions (Fig. 1) — the
    `fit_thresholds` builder below raises on non-monotone targets unless
    `force=True`, which reproduces the paper's Fig. 1 failure mode.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class MTSpec:
    out_bits: int
    out_signed: bool
    thresholds: torch.Tensor  # (2^out_bits - 1,) int32, ascending

    @property
    def qmin(self) -> int:
        return -(1 << (self.out_bits - 1)) if self.out_signed else 0


def mt_apply_int(x: torch.Tensor, spec: MTSpec) -> torch.Tensor:
    """out = qmin + #(x > t_i). Comparator-bank semantics; int32."""
    x = x.to(torch.int32)
    t = spec.thresholds.to(x.device)
    count = (x[..., None] > t).sum(-1).to(torch.int32)
    return spec.qmin + count


def fit_thresholds(
    fn: Callable[[np.ndarray], np.ndarray],
    lo: int,
    hi: int,
    out_bits: int,
    *,
    out_signed: bool = True,
    force: bool = False,
) -> MTSpec:
    """Derive MT thresholds for a folded target fn over integer domain
    [lo, hi].

    Threshold t_m = smallest x with round(fn(x)) >= level_{m+1}, minus one.
    Requires fn to be monotonically non-decreasing (the paper's structural
    limitation)."""
    xs = np.arange(lo, hi + 1, dtype=np.int64)
    ys = np.round(np.asarray(fn(xs.astype(np.float64)), np.float64)).astype(np.int64)
    qmin = -(1 << (out_bits - 1)) if out_signed else 0
    qmax = qmin + (1 << out_bits) - 1
    ys = np.clip(ys, qmin, qmax)
    if not force and np.any(np.diff(ys) < 0):
        raise ValueError(
            "target function is not monotonically increasing on the domain; "
            "the Multi-Threshold paradigm cannot realise it (paper Fig. 1)"
        )
    n_thresh = (1 << out_bits) - 1
    thresholds = np.full(n_thresh, np.iinfo(np.int32).max, np.int64)
    for m, level in enumerate(range(qmin + 1, qmax + 1)):
        idx = np.nonzero(ys >= level)[0]
        if len(idx):
            # threshold semantics: x > t  <=>  out >= level, so t = x* - 1
            thresholds[m] = xs[idx[0]] - 1
    thresholds = np.maximum.accumulate(thresholds)  # enforce ascending
    thresholds = np.clip(thresholds, np.iinfo(np.int32).min,
                         np.iinfo(np.int32).max)
    return MTSpec(out_bits=out_bits, out_signed=out_signed,
                  thresholds=torch.from_numpy(thresholds.astype(np.int32)))
