"""Fused int8 matrix product + GRAU epilogue as a hand-written CUDA kernel for
Hopper (csrc/matmul_grau.cu): the paper's "End-to-End MAC to Quant".

Replaces the JAX package's kernels/matmul_grau.py::matmul_grau_pallas (body
_mm_grau_kernel): x (M, K) int8 times w (K, N) int8, summed exactly in int32
(wrapping modulo 2^32 as the reference's int32 dot does), then the GRAU
datapath on every sum, written as the 8-bit bus (int8, or uint8 for unsigned
modes).

Bound on the H100: int8 tensor-core operations at the MLP widths, the weight
bytes at a few rows; the source note in the .cu file has the numbers. The
kernel masks its own ragged edges, so no operand is padded.

`matmul_grau` launches the kernel for CUDA tensors and runs
`matmul_grau_plain` for CPU tensors; `matmul_grau.launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.grau import grau_plain, out_dtype
from repro_torch.kernels.ref import wrap_int32
from repro_torch.pwlf.spec import REG_WORDS

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"matmul_grau_launch": (_P, _P, _P, _I, _I, _I, _P, _I, _I, _I,
                                     _P)}


def _check(x: torch.Tensor, w: torch.Tensor, regs: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"matmul_grau wants 2-D x and w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"matmul_grau wants int8 operands, got {x.dtype} "
                         f"and {w.dtype}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"K mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if regs.shape != (REG_WORDS,) or regs.dtype != torch.int32:
        raise ValueError("regs must be the (32,) int32 packed register file")
    devs = {x.device, w.device, regs.device}
    if len(devs) != 1:
        raise ValueError(f"x, w and regs must share one device, got {devs}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"matmul_grau: unsupported device {x.device}")


def matmul_grau_plain(x: torch.Tensor, w: torch.Tensor, regs: torch.Tensor,
                      *, num_exponents: int, qmin: int,
                      qmax: int) -> torch.Tensor:
    """Plain torch version of the kernel, for either device (CUDA has no
    integer matmul): the product in float64, where every partial sum of
    int8 products is an integer below 2^53 for K < 2^39 and so exact, then
    wrapped to int32 and run through `grau_plain`."""
    acc = wrap_int32((x.double() @ w.double()).long())
    return grau_plain(acc, regs, num_exponents=num_exponents, qmin=qmin,
                      qmax=qmax).to(out_dtype(qmin))


def matmul_grau(x: torch.Tensor, w: torch.Tensor, regs: torch.Tensor, *,
                num_exponents: int, qmin: int, qmax: int) -> torch.Tensor:
    """x (M, K) int8 @ w (K, N) int8 -> the GRAU bus (M, N): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. See
    ops.matmul_grau for the user-facing wrapper (any rank, spec packing)."""
    _check(x, w, regs)
    if x.device.type == "cpu":
        return matmul_grau_plain(x, w, regs, num_exponents=num_exponents,
                                 qmin=qmin, qmax=qmax)
    x, w = x.contiguous(), w.contiguous()
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype(qmin), device=x.device)
    lib = kbuild.library("matmul_grau", SIGNATURES)
    err = lib.matmul_grau_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, regs.data_ptr(),
        num_exponents, qmin, qmax,
        torch.cuda.current_stream(x.device).cuda_stream)
    kbuild.check(err, "matmul_grau_launch")
    matmul_grau.launches += 1
    return out


matmul_grau.launches = 0
