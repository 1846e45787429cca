"""The GRAU unit as a hand-written CUDA kernel for Hopper (csrc/grau.cu).

Replaces the JAX package's kernels/grau.py::grau_pallas (body _grau_kernel,
datapath grau_datapath). Per element of a 2-D int32 array:

    seg   = sum_i [x > bp_i]                      comparator bank
    bits  = enc_packed[seg]                       setting-buffer select
    acc   = sum_k ((bits >> k) & 1) * (x >> (pre_shift + k))
    out   = clamp(sign[seg] * acc + bias[seg], qmin, qmax) -> int8 / uint8

Bound on the H100: memory bytes and integer operations alike (4 bytes in
and 1 out an element against ~21 operations plus 4 a fired stage). The
kernel's grid is sized to the SMs; each thread evaluates 8 elements from two
16-byte loads, visiting only the stages that fire, with the 32-word register
file (runtime data, spec.packed) in shared memory; see the source note in
csrc/grau.cu.

`grau_unit` launches the kernel for a CUDA tensor and runs `grau_plain`, the
same datapath in plain torch, for a CPU tensor; `grau_unit.launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.grau import shift_term
from repro_torch.kernels import build as kbuild
from repro_torch.pwlf.spec import (MAX_SEGMENTS, REG_BIAS, REG_BP, REG_ENC,
                                   REG_PRE, REG_SIGN, REG_WORDS)

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"grau_launch": (_P, _P, ctypes.c_longlong, _P, _I, _I, _I, _I,
                               _P)}


def out_dtype(qmin: int) -> torch.dtype:
    """Signed modes emit int8, unsigned uint8 (a [0, 255] clamp does not fit
    int8 — the mixed-precision mode register picks the output bus)."""
    return torch.int8 if qmin < 0 else torch.uint8


def grau_plain(x: torch.Tensor, regs: torch.Tensor, *, num_exponents: int,
               qmin: int, qmax: int) -> torch.Tensor:
    """The datapath in plain torch on the packed register file: int32 array
    -> clipped int32 (the kernel's arithmetic, for any device)."""
    regs = regs.to(x.device)
    bp = regs[REG_BP:REG_BP + MAX_SEGMENTS - 1]
    seg = (x[..., None] > bp).sum(-1)
    bits = regs[REG_ENC:REG_ENC + MAX_SEGMENTS][seg]
    sign = regs[REG_SIGN:REG_SIGN + MAX_SEGMENTS][seg]
    bias = regs[REG_BIAS:REG_BIAS + MAX_SEGMENTS][seg]
    pre = int(regs[REG_PRE])
    acc = torch.zeros_like(x)
    for k in range(num_exponents):
        fire = torch.bitwise_and(torch.bitwise_right_shift(bits, k), 1) != 0
        acc = acc + torch.where(fire, shift_term(x, pre + k), 0)
    return torch.clamp(sign * acc + bias, qmin, qmax)


def grau_unit(x: torch.Tensor, regs: torch.Tensor, *, num_exponents: int,
              qmin: int, qmax: int) -> torch.Tensor:
    """Apply a packed GRAU register file to a 2-D int32 tensor; returns the
    8-bit bus (int8, or uint8 when qmin >= 0). See ops.grau for the
    user-facing wrapper (any rank, spec packing)."""
    if x.dim() != 2 or x.dtype != torch.int32:
        raise ValueError(f"grau_unit wants a 2-D int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if regs.shape != (REG_WORDS,) or regs.dtype != torch.int32:
        raise ValueError("regs must be the (32,) int32 packed register file")
    odt = out_dtype(qmin)
    if x.device.type == "cpu":
        return grau_plain(x, regs, num_exponents=num_exponents, qmin=qmin,
                          qmax=qmax).to(odt)
    if x.device.type != "cuda":
        raise ValueError(f"grau_unit: unsupported device {x.device}")
    if regs.device != x.device:
        raise ValueError("regs must live on the input's device")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()          # the kernel reads 16-byte vectors
    out = torch.empty(x.shape, dtype=odt, device=x.device)
    lib = kbuild.library("grau", SIGNATURES)
    err = lib.grau_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                          regs.data_ptr(), num_exponents, qmin, qmax,
                          kbuild.sm_count(x.device),
                          torch.cuda.current_stream(x.device).cuda_stream)
    kbuild.check(err, "grau_launch")
    grau_unit.launches += 1
    return out


grau_unit.launches = 0
