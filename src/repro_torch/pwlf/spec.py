"""GRAUSpec — the runtime-reconfigurable register file of a GRAU unit.

The paper's hardware unit is configured by a small set of registers:
  * S-1 integer breakpoints (segment comparators),
  * per-segment shift encodings (which 1-bit right-shifter stages fire),
  * per-segment sign bit,
  * per-segment integer bias,
  * a global pre-shift (the paper's "pre-right-shifting" that normalises all
    exponents into a contiguous window),
  * output bit-width / signedness (mixed-precision mode register).

The static fields (segment/exponent counts, output mode) are plain Python
values; the register file itself is a set of int32 tensors, so "runtime
reconfiguration" is a tensor update: every kernel takes the registers as
data and never needs rebuilding for a new activation or precision.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Hardware limits mirrored from the paper's implemented instances (Table VI).
MAX_SEGMENTS = 8          # 4/6/8-segment instances
MAX_EXPONENTS = 16        # 8/16-exponent shifter pipelines

# Word layout of the packed register file the CUDA kernels read
# (csrc/grau_datapath.cuh): breakpoints, bit-packed enc rows, sign, bias,
# pre-shift — 32 int32 words in one device tensor.
REG_BP, REG_ENC, REG_SIGN, REG_BIAS, REG_PRE = 0, 7, 15, 23, 31
REG_WORDS = 32


@dataclasses.dataclass(frozen=True, eq=False)
class GRAUSpec:
    """Register file of one GRAU unit (one folded activation).

    Shapes are padded to (MAX_SEGMENTS, MAX_EXPONENTS) so that specs for
    different activation functions are interchangeable at runtime.

    Semantics of the integer datapath (bit-exact with the RTL):
      seg  = sum_i [x > breakpoints[i]]                           # comparators
      acc  = sum_{k: enc[seg,k]=1} arith_shift_right(x, pre_shift + k)
             # pre_shift + k < 0 is a left shift
      y    = sign[seg] * acc + bias[seg]
      out  = clamp(y, qmin(out_bits), qmax(out_bits))
    """

    # --- static fields ---
    num_segments: int
    num_exponents: int
    out_bits: int
    out_signed: bool

    # --- register file (data; reconfigurable at runtime) ---
    breakpoints: torch.Tensor   # (MAX_SEGMENTS - 1,) int32, ascending; padded with INT32_MAX
    enc: torch.Tensor           # (MAX_SEGMENTS, MAX_EXPONENTS) int32 {0,1}
    sign: torch.Tensor          # (MAX_SEGMENTS,) int32 in {-1, +1}
    bias: torch.Tensor          # (MAX_SEGMENTS,) int32
    pre_shift: torch.Tensor     # () int32; may be negative

    @property
    def qmin(self) -> int:
        return -(1 << (self.out_bits - 1)) if self.out_signed else 0

    @property
    def qmax(self) -> int:
        return (1 << (self.out_bits - 1)) - 1 if self.out_signed else (1 << self.out_bits) - 1

    @property
    def device(self) -> torch.device:
        return self.breakpoints.device

    def replace(self, **kw) -> "GRAUSpec":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GRAUSpec":
        """The same register file with its tensors on `device`."""
        return self.replace(**{f: getattr(self, f).to(device) for f in
                               ("breakpoints", "enc", "sign", "bias",
                                "pre_shift")})

    def memo(self, key, build):
        """A value derived from this register file, built once and kept on
        the spec (its fields are never mutated, so the value stays valid)."""
        cache = self.__dict__.setdefault("_memo", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def packed(self, device) -> torch.Tensor:
        """The register file as the kernels' (REG_WORDS,) int32 word array
        (enc rows bit-packed, see kernels/ops.pack_spec), on `device`,
        packed and uploaded once per device."""
        def build():
            from repro_torch.kernels.ops import pack_spec
            bp, encp, sign, bias, pre = pack_spec(self.to("cpu"))
            words = torch.cat([bp, encp, sign, bias, pre.reshape(1)])
            assert words.numel() == REG_WORDS
            return words.to(torch.int32).to(device)
        return self.memo(("packed", str(torch.device(device))), build)


def make_spec(
    breakpoints: np.ndarray,
    enc: np.ndarray,
    sign: np.ndarray,
    bias: np.ndarray,
    *,
    pre_shift: int,
    num_exponents: int,
    out_bits: int,
    out_signed: bool = True,
) -> GRAUSpec:
    """Pad a fitted configuration into the fixed-size register file."""
    s = int(len(bias))
    if s > MAX_SEGMENTS:
        raise ValueError(f"{s} segments > hardware maximum {MAX_SEGMENTS}")
    if num_exponents > MAX_EXPONENTS:
        raise ValueError(f"{num_exponents} exponents > hardware maximum {MAX_EXPONENTS}")
    bp = np.full((MAX_SEGMENTS - 1,), np.iinfo(np.int32).max, np.int32)
    bp[: s - 1] = np.asarray(breakpoints, np.int32)
    e = np.zeros((MAX_SEGMENTS, MAX_EXPONENTS), np.int32)
    e[:s, :num_exponents] = np.asarray(enc, np.int32)
    sg = np.ones((MAX_SEGMENTS,), np.int32)
    sg[:s] = np.asarray(sign, np.int32)
    b = np.zeros((MAX_SEGMENTS,), np.int32)
    b[:s] = np.asarray(bias, np.int32)
    return GRAUSpec(
        num_segments=s,
        num_exponents=int(num_exponents),
        out_bits=int(out_bits),
        out_signed=bool(out_signed),
        breakpoints=torch.from_numpy(bp),
        enc=torch.from_numpy(e),
        sign=torch.from_numpy(sg),
        bias=torch.from_numpy(b),
        pre_shift=torch.tensor(int(pre_shift), dtype=torch.int32),
    )


@dataclasses.dataclass(frozen=True)
class PWLFunction:
    """A float piecewise-linear function: the pre-hardware fit artifact.

    y(x) = slope[seg]*x + intercept[seg],  seg chosen by breakpoints.
    Used as (a) the QAT training surrogate and (b) the reference that PoT/APoT
    projection starts from.
    """
    breakpoints: np.ndarray   # (S-1,) float — segment boundaries, ascending
    slopes: np.ndarray        # (S,) float
    intercepts: np.ndarray    # (S,) float

    @property
    def num_segments(self) -> int:
        return len(self.slopes)

    def __call__(self, x):
        # seg = #(breakpoints < x): identical comparator semantics to the
        # integer datapath's sum_i [x > bp_i].
        if isinstance(x, torch.Tensor):
            bps = torch.as_tensor(self.breakpoints, dtype=x.dtype,
                                  device=x.device)
            seg = torch.searchsorted(bps, x.contiguous(), right=False)
            slopes = torch.as_tensor(self.slopes, dtype=x.dtype,
                                     device=x.device)
            icpt = torch.as_tensor(self.intercepts, dtype=x.dtype,
                                   device=x.device)
            return slopes[seg] * x + icpt[seg]
        seg = np.searchsorted(np.asarray(self.breakpoints), x, side="left")
        return np.asarray(self.slopes)[seg] * x + np.asarray(self.intercepts)[seg]
