"""User-facing wrappers around the CUDA kernels.

Handles GRAUSpec -> packed register file and shape normalisation (any rank
-> 2-D). Unlike the TPU kernels, the CUDA kernels mask their ragged edges
themselves (M, K, a pack tile of any width), so no padding copy is made —
but for matmul_wq's N when it is not a multiple of 16, which its wrapper
pads with zero bytes. A CPU tensor runs the kernel's plain torch version; a
CUDA tensor launches the kernel.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import grau as grau_kernel
from repro_torch.kernels import matmul_grau as mm_kernel
from repro_torch.kernels import matmul_wq as wq_kernel
from repro_torch.pwlf.spec import GRAUSpec, MAX_EXPONENTS


def pack_spec(spec: GRAUSpec) -> Tuple[torch.Tensor, ...]:
    """Bit-pack enc rows into one int32 per segment (the setting buffer)."""
    weights = torch.as_tensor(1 << np.arange(MAX_EXPONENTS),
                              dtype=torch.int32, device=spec.enc.device)
    enc_packed = (spec.enc.to(torch.int32) * weights).sum(-1).to(torch.int32)
    return spec.breakpoints, enc_packed, spec.sign, spec.bias, spec.pre_shift


def _to_2d(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    shape = tuple(x.shape)
    if x.dim() == 1:
        return x.reshape(1, -1), shape
    return x.reshape(-1, shape[-1]), shape


def grau(x: torch.Tensor, spec: GRAUSpec) -> torch.Tensor:
    """Apply a GRAU unit to int32 MAC outputs (any rank). Returns the 8-bit
    bus: int8, or uint8 for unsigned modes."""
    x2, orig_shape = _to_2d(x.to(torch.int32))
    out = grau_kernel.grau_unit(
        x2.contiguous(), spec.packed(x.device),
        num_exponents=spec.num_exponents, qmin=spec.qmin, qmax=spec.qmax)
    return out.reshape(orig_shape)


def matmul_grau(x: torch.Tensor, w: torch.Tensor,
                spec: GRAUSpec) -> torch.Tensor:
    """Fused int8 GEMM + GRAU epilogue. x: (..., K) int8, w: (K, N) int8;
    returns (..., N) on the 8-bit bus (int8, or uint8 for unsigned modes)."""
    x2, orig_shape = _to_2d(x)
    out = mm_kernel.matmul_grau(
        x2, w, spec.packed(x.device), num_exponents=spec.num_exponents,
        qmin=spec.qmin, qmax=spec.qmax)
    return out.reshape(*orig_shape[:-1], w.shape[1])


def matmul_wq(x: torch.Tensor, w, spec: GRAUSpec = None, *,
              s_in: float = 1.0) -> torch.Tensor:
    """Weight-quantized GEMM: float x (..., K) against a packed 2-D
    quant/weights.QuantWeight (contraction axis -2), dequantized per tile
    inside the kernel. With a GRAUSpec the fused epilogue emits the 8-bit
    bus of the sum scaled by 1/s_in."""
    return wq_kernel.matmul_wq(x, w, spec, s_in=s_in)
