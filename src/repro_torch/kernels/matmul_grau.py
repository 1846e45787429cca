"""Fused int8 matrix product + GRAU epilogue as a hand-written CUDA kernel for
Hopper (csrc/matmul_grau.cu): the paper's "End-to-End MAC to Quant".

Replaces the JAX package's kernels/matmul_grau.py::matmul_grau_pallas (body
_mm_grau_kernel): x (M, K) int8 times w (K, N) int8, summed exactly in int32
(wrapping modulo 2^32 as the reference's int32 dot does), then the GRAU
datapath on every sum, written as the 8-bit bus (int8, or uint8 for unsigned
modes).

Bound on the H100: int8 tensor-core operations at the MLP widths, the weight
bytes at a few rows; the source note in the .cu file has the numbers. The
kernel computes out^T = w^T x^T on wgmma (w as the register operand, x by
TMA) in blocks of 256 w columns x `row_tile` rows of x, and splits K into
parts when the output tiles are fewer than the SMs (`plan`, a plain function
of the shapes and the SM count); the parts' int32 partial sums go to a
workspace [parts, M, N] that a second launch sums (modulo 2^32: any order
gives the same integers) before the datapath. The kernel masks its own
ragged edges, so no operand is padded.

`matmul_grau` launches the kernel for CUDA tensors and runs
`matmul_grau_plain` for CPU tensors (an empty output for meta tensors;
roofline/count.py counts the call through `cost`); `matmul_grau.launches` counts kernel
launches (one per call, whatever the part count).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.grau import grau_plain, out_dtype
from repro_torch.kernels.ref import wrap_int32
from repro_torch.pwlf.spec import REG_WORDS
from repro_torch.roofline import count as rcount

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, out, ws, M, N, K, bm, parts, spp, regs, num_exponents, qmin, qmax,
# sms, stream
SIGNATURES = {"matmul_grau_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _P, _I, _I, _I, _I, _P)}
BLOCK_N = 256          # w columns a CUDA block (csrc/matmul_grau.cu kBN)
STEP_K = 128           # k a pipeline stage (kBK)
MIN_PART_STEPS = 4     # a K part sums at least 512 k (when K has them)


def _tiles(m: int, n: int, bm: int) -> int:
    return -(-n // BLOCK_N) * -(-m // bm)


@functools.lru_cache(maxsize=1024)
def plan(m: int, n: int, k: int,
         sms: int = kbuild.H100_SMS) -> Tuple[int, int, int]:
    """(row tile, parts, k steps a part) of the kernel's grid, from the
    shapes and the SM count only (so a launch can be captured in a CUDA
    graph). The row tile is 128 rows of x when that still gives a block
    per SM, else 32; if the output tiles are then fewer than the SMs, K is
    split into as many parts (runs of whole 128-k steps, at least
    MIN_PART_STEPS each where K has them) as give every SM a block. The
    last part may hold fewer steps."""
    bm = 128 if _tiles(m, n, 128) >= sms else 32
    tiles = _tiles(m, n, bm)
    steps = max(1, -(-k // STEP_K))
    want = -(-sms // tiles)
    spp = min(steps, max(MIN_PART_STEPS, -(-steps // want)))
    return bm, -(-steps // spp), spp


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
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"matmul_grau: unsupported device {x.device}")


def cost(m: int, k: int, n: int) -> rcount.Cost:
    """The product's 2 M K N int8 operations; x, w and the register file
    read once, the 8-bit bus written once."""
    return rcount.Cost(flops=2.0 * m * k * n, kind="int8",
                       reads=m * k + k * n + 4 * REG_WORDS, writes=m * n)


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
    (m, k), n = x.shape, w.shape[1]
    with rcount.kernel("matmul_grau", lambda: cost(m, k, n)):
        if x.is_meta:
            return torch.empty((m, n), dtype=out_dtype(qmin), device="meta")
        if x.device.type == "cpu":
            return matmul_grau_plain(x, w, regs,
                                     num_exponents=num_exponents, qmin=qmin,
                                     qmax=qmax)
        return _launch(x, w, regs, num_exponents=num_exponents, qmin=qmin,
                       qmax=qmax)


def _launch(x, w, regs, *, num_exponents, qmin, qmax):
    x, w = x.contiguous(), w.contiguous()
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype(qmin), device=x.device)
    sms = kbuild.sm_count(x.device)
    bm, parts, spp = plan(m, n, k, sms)
    ws = (torch.empty((parts, m, n), dtype=torch.int32, device=x.device)
          if parts > 1 else None)
    lib = kbuild.library("matmul_grau", SIGNATURES)
    err = lib.matmul_grau_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, n, k, bm, parts, spp,
        regs.data_ptr(), num_exponents, qmin, qmax, sms,
        torch.cuda.current_stream(x.device).cuda_stream)
    kbuild.check(err, "matmul_grau_launch")
    matmul_grau.launches += 1
    return out


matmul_grau.launches = 0
