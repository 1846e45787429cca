"""Algorithm 1 — Greedy Integer-Aware PWLF Breakpoint Selection.

Faithful implementation of the paper's fast greedy fitter, replacing the
continuous least-squares `pwlf` library:

    1. start with one segment spanning the whole sampled range;
    2. for each segment, find the sample with maximum vertical distance to the
       chord joining the segment endpoints;
    3. round that point to the nearest integer (integer breakpoints are a
       hardware requirement);
    4. accept a candidate only if it lies strictly inside its segment,
       improves by more than `eps`, and respects the minimum gap `g`;
    5. greedily take the best candidate, split the segment, repeat until the
       target segment count is reached or no candidate helps.

The paper folds BN + activation + requant into the target function before
fitting; see repro/core/folding.py for the fold and repro/pwlf/approx.py for
the PoT/APoT slope projection that follows this fit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np

from repro_torch.pwlf.spec import PWLFunction


def _chord_distances(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Vertical distance from every sample to the chord of its segment ends."""
    if len(x) < 3:
        return np.zeros_like(y)
    x0, x1, y0, y1 = x[0], x[-1], y[0], y[-1]
    if x1 == x0:
        return np.zeros_like(y)
    chord = y0 + (y1 - y0) * (x - x0) / (x1 - x0)
    return np.abs(y - chord)


def greedy_breakpoints(
    x: np.ndarray,
    y: np.ndarray,
    target_segments: int,
    *,
    min_gap: int = 1,
    eps: float = 1e-6,
) -> np.ndarray:
    """Algorithm 1. Returns the selected interior breakpoints (ascending ints)."""
    order = np.argsort(x, kind="stable")
    x = np.asarray(x, np.float64)[order]
    y = np.asarray(y, np.float64)[order]

    # segments held as (lo, hi) index pairs into the sorted sample arrays
    segments: List[Tuple[int, int]] = [(0, len(x) - 1)]
    breaks: List[float] = []

    while len(breaks) < target_segments - 1:
        candidates = []  # (dist, rounded_breakpoint, seg_index)
        for si, (lo, hi) in enumerate(segments):
            if hi - lo < 2:
                continue
            seg_x, seg_y = x[lo : hi + 1], y[lo : hi + 1]
            d = _chord_distances(seg_x, seg_y)
            j = int(np.argmax(d))
            if d[j] <= eps:
                continue
            bp = float(np.round(seg_x[j]))  # integer-aware rounding
            if not (seg_x[0] < bp < seg_x[-1]):
                continue
            # min-gap against existing breakpoints and segment endpoints
            neighbours = breaks + [float(seg_x[0]), float(seg_x[-1])]
            if any(abs(bp - nb) < min_gap for nb in neighbours):
                continue
            candidates.append((float(d[j]), bp, si))
        if not candidates:
            break
        _, bp, si = max(candidates, key=lambda c: c[0])
        lo, hi = segments[si]
        mid = lo + int(np.searchsorted(x[lo : hi + 1], bp, side="left"))
        mid = min(max(mid, lo + 1), hi - 1)
        segments[si : si + 1] = [(lo, mid), (mid, hi)]
        breaks.append(bp)
        breaks.sort()
    return np.asarray(breaks, np.float64)


def fit_segments(
    x: np.ndarray,
    y: np.ndarray,
    breakpoints: np.ndarray,
) -> PWLFunction:
    """Per-segment least-squares slope/intercept given fixed breakpoints.

    The hardware applies y = slope*x + bias independently per segment (the
    PoT/APoT projection breaks continuity anyway — the paper's Fig. 2 "gap"),
    so we fit each segment independently rather than solving the continuous
    system: strictly better per-segment L2 and much cheaper.
    """
    order = np.argsort(x, kind="stable")
    x = np.asarray(x, np.float64)[order]
    y = np.asarray(y, np.float64)[order]
    seg = np.searchsorted(breakpoints, x, side="right")
    n_seg = len(breakpoints) + 1
    slopes = np.zeros(n_seg)
    intercepts = np.zeros(n_seg)
    for s in range(n_seg):
        m = seg == s
        xs, ys = x[m], y[m]
        if len(xs) == 0:
            continue
        if len(xs) == 1 or np.ptp(xs) == 0:
            slopes[s], intercepts[s] = 0.0, float(np.mean(ys))
            continue
        a = np.stack([xs, np.ones_like(xs)], axis=1)
        sol, *_ = np.linalg.lstsq(a, ys, rcond=None)
        slopes[s], intercepts[s] = float(sol[0]), float(sol[1])
    return PWLFunction(np.asarray(breakpoints, np.float64), slopes, intercepts)


def fit_pwlf(
    fn: Callable[[np.ndarray], np.ndarray],
    lo: float,
    hi: float,
    target_segments: int,
    *,
    num_samples: int = 1000,
    min_gap: int = 1,
    eps: float = 1e-6,
) -> PWLFunction:
    """Fit `fn` over [lo, hi] with the paper's sampling protocol.

    The paper doubles each layer's recorded MAC range and draws 1000 evenly
    spaced samples; callers are expected to pass the already-doubled range.
    """
    x = np.linspace(lo, hi, num_samples)
    y = np.asarray(fn(x), np.float64)
    bps = greedy_breakpoints(x, y, target_segments, min_gap=min_gap, eps=eps)
    return fit_segments(x, y, bps)


@dataclasses.dataclass(frozen=True)
class FitReport:
    """Quality record for one fitted activation (goes into benchmark tables)."""
    num_segments: int
    max_abs_err: float
    rms_err: float

    @staticmethod
    def of(fn, pwl: PWLFunction, lo: float, hi: float, num_samples: int = 4096) -> "FitReport":
        x = np.linspace(lo, hi, num_samples)
        err = np.asarray(fn(x), np.float64) - pwl(x)
        return FitReport(pwl.num_segments, float(np.max(np.abs(err))), float(np.sqrt(np.mean(err**2))))
