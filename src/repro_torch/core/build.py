"""End-to-end builder: folded activation -> fitted PWLF -> GRAU register file.

This is the paper's offline flow (Section II-A) in one call:
  1. double the recorded MAC output range, sample 1000 points (paper protocol);
  2. Algorithm-1 greedy integer-aware breakpoint selection;
  3. per-segment slope fit;
  4. PoT/APoT projection + window search;
  5. emit GRAUSpec (+ a FitReport for the experiment tables).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.folding import FoldedActivation
from repro_torch.pwlf.approx import quantize_pwlf, search_best_window
from repro_torch.pwlf.fit import FitReport, fit_pwlf
from repro_torch.pwlf.spec import GRAUSpec, PWLFunction


@dataclasses.dataclass(frozen=True)
class BuildResult:
    spec: GRAUSpec
    pwl: PWLFunction
    window: Tuple[int, int]
    fit: FitReport
    int_rms: float           # integer-domain RMS vs. the exact folded function
    int_max_abs: float


def build_grau(
    folded: FoldedActivation,
    *,
    mac_range: Tuple[float, float],
    segments: int = 6,
    num_exponents: int = 8,
    mode: str = "apot",
    window: Optional[Tuple[int, int]] = None,
    num_samples: int = 1000,
    range_doubling: bool = True,
    bias_mode: str = "anchor",
) -> BuildResult:
    lo, hi = float(mac_range[0]), float(mac_range[1])
    if range_doubling:  # paper: "doubling the recorded MAC output range"
        c, half = (lo + hi) / 2.0, (hi - lo) / 2.0
        lo, hi = c - 2 * half, c + 2 * half

    pwl = fit_pwlf(folded, lo, hi, segments, num_samples=num_samples)
    report = FitReport.of(folded, pwl, lo, hi)

    if window is not None:
        spec = quantize_pwlf(pwl, mode=mode, win=window, out_bits=folded.out_bits,
                             out_signed=folded.out_signed, domain_lo=lo,
                             domain_hi=hi, bias_mode=bias_mode)
        win = window
    else:
        spec, win, _ = search_best_window(
            pwl, mode=mode, n_exp=num_exponents, lo=lo, hi=hi,
            out_bits=folded.out_bits, out_signed=folded.out_signed,
            bias_mode=bias_mode,
        )

    from repro_torch.core.grau import grau_reference_int
    xs = np.unique(np.round(np.linspace(lo, hi, 4097)).astype(np.int64))
    exact = folded.quantized(xs)
    got = grau_reference_int(xs, spec)
    err = (got - exact).astype(np.float64)
    return BuildResult(
        spec=spec, pwl=pwl, window=win, fit=report,
        int_rms=float(np.sqrt(np.mean(err**2))),
        int_max_abs=float(np.max(np.abs(err))),
    )
