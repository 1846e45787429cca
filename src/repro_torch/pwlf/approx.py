"""PoT / APoT slope projection and shift-encoding emission.

Turns a fitted float `PWLFunction` into the GRAU register file (`GRAUSpec`):

  * breakpoints rounded to the nearest integer (paper step 1);
  * each segment slope projected onto
      - PoT:  sign * 2^e, single e in the allowed contiguous window, or
      - APoT: sign * sum of *distinct* 2^e from the window (each exponent
        usable once — exactly the paper's encoding, Fig. 3);
  * the new segment line is re-anchored at the segment's (rounded) left
    breakpoint (paper step 3), which produces the small right-end "gap" the
    paper shows in Fig. 2;
  * the integer bias is the anchored intercept rounded to int.

Projection is *exact* subset selection, not the paper's greedy residual
decomposition: with <= 16 exponents there are <= 65536 encodings, so we
enumerate all subset sums once per window and take the nearest. This is a
strict improvement documented in EXPERIMENTS.md (beyond-paper, algorithmic).
`project_apot_greedy` reproduces the paper's greedy variant for comparison.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from repro_torch.pwlf.spec import GRAUSpec, PWLFunction, make_spec


# ---------------------------------------------------------------------------
# Exponent windows
# ---------------------------------------------------------------------------

def window(e_lo: int, e_hi: int) -> Tuple[int, int]:
    """Contiguous exponent window [e_lo, e_hi] (paper notation 2^e_lo ~ 2^e_hi)."""
    if e_lo > e_hi:
        raise ValueError("window requires e_lo <= e_hi")
    return (int(e_lo), int(e_hi))


def window_values(win: Tuple[int, int]) -> np.ndarray:
    """Stage-ordered exponent values: stage k realises 2^(e_hi - k)."""
    e_lo, e_hi = win
    return 2.0 ** np.arange(e_hi, e_lo - 1, -1, dtype=np.float64)


# ---------------------------------------------------------------------------
# Slope projection
# ---------------------------------------------------------------------------

def project_pot(slope: float, win: Tuple[int, int]) -> np.ndarray:
    """Nearest single power of two in the window; returns the stage bitmask."""
    vals = window_values(win)
    n = len(vals)
    enc = np.zeros(n, np.int32)
    mag = abs(float(slope))
    if mag == 0.0:
        return enc  # all-zero encoding == slope 0 (paper: "all bits 0 means slope 0")
    k = int(np.argmin(np.abs(vals - mag)))
    # An all-zero encoding may still be closer than the smallest stage value.
    if abs(vals[k] - mag) < mag:
        enc[k] = 1
    return enc


@functools.lru_cache(maxsize=32)
def _subset_table(n: int, e_hi: int) -> Tuple[np.ndarray, np.ndarray]:
    """(sums, masks) of all 2^n subset sums of {2^(e_hi-k)}, sorted by sum."""
    masks = np.arange(1 << n, dtype=np.uint32)
    bits = ((masks[:, None] >> np.arange(n, dtype=np.uint32)[None, :]) & 1).astype(np.float64)
    sums = bits @ (2.0 ** (e_hi - np.arange(n, dtype=np.float64)))
    order = np.argsort(sums, kind="stable")
    return sums[order], masks[order]


def project_apot(slope: float, win: Tuple[int, int]) -> np.ndarray:
    """Optimal APoT projection: nearest subset sum of distinct window PoTs."""
    e_lo, e_hi = win
    n = e_hi - e_lo + 1
    mag = abs(float(slope))
    sums, masks = _subset_table(n, e_hi)
    i = int(np.searchsorted(sums, mag))
    best = min((j for j in (i - 1, i) if 0 <= j < len(sums)), key=lambda j: abs(sums[j] - mag))
    mask = int(masks[best])
    return ((mask >> np.arange(n)) & 1).astype(np.int32)


def project_apot_greedy(slope: float, win: Tuple[int, int]) -> np.ndarray:
    """The paper's greedy residual decomposition (kept for ablation)."""
    vals = window_values(win)
    enc = np.zeros(len(vals), np.int32)
    residual = abs(float(slope))
    for k, v in enumerate(vals):
        if residual >= v:
            enc[k] = 1
            residual -= v
    # round the tail: flip the nearest unset smaller bit if it helps
    unset = np.where(enc == 0)[0]
    if len(unset) and residual > 0:
        k = unset[np.argmin(np.abs(vals[unset] - residual))]
        if abs(vals[k] - residual) < residual:
            enc[k] = 1
    return enc


def encoding_value(enc: np.ndarray, win: Tuple[int, int]) -> float:
    """Slope magnitude realized by a stage bitmask."""
    return float(np.dot(np.asarray(enc, np.float64), window_values(win)))


# ---------------------------------------------------------------------------
# PWLFunction -> GRAUSpec
# ---------------------------------------------------------------------------

def quantize_pwlf(
    pwl: PWLFunction,
    *,
    mode: str,                      # "pot" | "apot" | "apot-greedy"
    win: Tuple[int, int],
    out_bits: int,
    out_signed: bool = True,
    domain_lo: float | None = None,
    domain_hi: float | None = None,
    bias_mode: str = "anchor",      # "anchor" (paper-faithful) | "lsq" (beyond-paper)
) -> GRAUSpec:
    """Emit the GRAU register file for a fitted PWL function.

    bias_mode="anchor" (paper step 3): segment s is re-anchored at its
    (rounded, integer) left breakpoint x_l, so the integer datapath reproduces
    round(pwl(x_l)) exactly at the anchor and the error grows towards the
    right end of the segment — the paper's Fig. 2 gap.

    bias_mode="lsq" (beyond-paper improvement, see EXPERIMENTS.md): given the
    projected slope, the optimal integer bias under L2 is the rounded mean
    residual over the segment; this centres the Fig. 2 gap instead of pushing
    it to the right end and costs nothing in hardware (same bias register).
    """
    project = {"pot": project_pot, "apot": project_apot, "apot-greedy": project_apot_greedy}[mode]
    e_lo, e_hi = win
    n_exp = e_hi - e_lo + 1
    pre_shift = -e_hi

    bps = np.round(pwl.breakpoints).astype(np.int64)
    # Integer-collapsed breakpoints (paper's pwlf critique) should have been
    # prevented upstream by Algorithm 1's min-gap; de-duplicate defensively.
    bps = np.unique(bps)
    n_seg = len(bps) + 1

    # Anchor of segment 0 is the fit-domain left edge (out-of-range inputs
    # belong to the first/last segments, per the paper).
    if domain_lo is None:
        domain_lo = float(bps[0]) - 1.0 if len(bps) else 0.0
    if domain_hi is None:
        domain_hi = float(bps[-1]) + 1.0 if len(bps) else 1.0
    anchors = np.concatenate([[np.floor(domain_lo)], bps.astype(np.float64)])
    right_edges = np.concatenate([bps.astype(np.float64), [np.ceil(domain_hi)]])

    # Map (possibly deduplicated) segments back onto pwl's own segmentation.
    enc = np.zeros((n_seg, n_exp), np.int32)
    sign = np.ones(n_seg, np.int32)
    bias = np.zeros(n_seg, np.int64)
    for s in range(n_seg):
        x_anchor = anchors[s]
        # Segment s covers (anchor, right_edge]: classify by a point strictly
        # inside it (the anchor itself belongs to the previous segment).
        src = int(np.searchsorted(pwl.breakpoints,
                                  (x_anchor + right_edges[s]) / 2.0, side="left"))
        src = min(src, pwl.num_segments - 1)
        slope = float(pwl.slopes[src])
        enc[s] = project(slope, win)
        sign[s] = -1 if slope < 0 else 1
        if bias_mode == "anchor":
            realized = _integer_slope_terms(int(x_anchor), enc[s], pre_shift)
            # anchor on the segment's own fitted line (per-segment fits are
            # discontinuous at edges; pwl(x_anchor) would use the neighbour)
            target = int(np.round(slope * x_anchor + float(pwl.intercepts[src])))
            bias[s] = target - int(sign[s]) * realized
        elif bias_mode == "lsq":
            xs = np.unique(np.round(
                np.linspace(x_anchor + 1.0, right_edges[s], 257)).astype(np.int64))
            acc = _integer_slope_terms_vec(xs, enc[s], pre_shift)
            line = slope * xs.astype(np.float64) + float(pwl.intercepts[src])
            resid = np.round(line) - sign[s] * acc
            bias[s] = int(np.round(np.mean(resid)))
        else:
            raise ValueError(f"unknown bias_mode {bias_mode!r}")

    bias = np.clip(bias, np.iinfo(np.int32).min, np.iinfo(np.int32).max)
    return make_spec(
        bps, enc, sign, bias,
        pre_shift=pre_shift, num_exponents=n_exp,
        out_bits=out_bits, out_signed=out_signed,
    )


def _integer_slope_terms(x: int, enc: np.ndarray, pre_shift: int) -> int:
    """Bit-exact shift-add of the datapath for a scalar anchor input."""
    acc = 0
    for k, bit in enumerate(np.asarray(enc)):
        if not bit:
            continue
        s = pre_shift + k
        acc += (x >> s) if s >= 0 else (x << -s)
    return acc


def _integer_slope_terms_vec(xs: np.ndarray, enc: np.ndarray, pre_shift: int) -> np.ndarray:
    acc = np.zeros_like(xs)
    for k, bit in enumerate(np.asarray(enc)):
        if not bit:
            continue
        s = pre_shift + k
        acc = acc + ((xs >> s) if s >= 0 else (xs << -s))
    return acc


def search_best_window(
    pwl: PWLFunction,
    *,
    mode: str,
    n_exp: int,
    lo: float,
    hi: float,
    out_bits: int,
    out_signed: bool = True,
    e_hi_candidates: range = range(0, -24, -1),
    bias_mode: str = "anchor",
) -> Tuple[GRAUSpec, Tuple[int, int], float]:
    """Pick the contiguous exponent window minimising integer-domain RMS error.

    Mirrors the paper's per-table exploration of exponent ranges (they report
    the best range next to each accuracy number). Error is measured against
    the float PWLF rounded to ints over the fit domain.
    """
    from repro_torch.core.grau import grau_reference_int  # local import, avoids cycle

    xs = np.unique(np.round(np.linspace(lo, hi, 4097)).astype(np.int64))
    ref = np.round(pwl(xs.astype(np.float64)))
    qmin = -(1 << (out_bits - 1)) if out_signed else 0
    qmax = (1 << (out_bits - 1)) - 1 if out_signed else (1 << out_bits) - 1
    ref = np.clip(ref, qmin, qmax)

    best = None
    for e_hi in e_hi_candidates:
        win = (e_hi - n_exp + 1, e_hi)
        spec = quantize_pwlf(pwl, mode=mode, win=win, out_bits=out_bits,
                             out_signed=out_signed, domain_lo=lo, domain_hi=hi,
                             bias_mode=bias_mode)
        got = np.asarray(grau_reference_int(xs.astype(np.int64), spec))
        rms = float(np.sqrt(np.mean((got - ref) ** 2)))
        if best is None or rms < best[2]:
            best = (spec, win, rms)
    return best
