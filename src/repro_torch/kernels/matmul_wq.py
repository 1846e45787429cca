"""Weight-quantized matrix product as a hand-written CUDA kernel for Hopper
(csrc/matmul_wq.cu), with the GRAU epilogue optionally fused.

Replaces the JAX package's kernels/matmul_wq.py::matmul_wq_pallas: float
activations x (M, K) against a packed 2-D quant/weights.QuantWeight with
contraction axis -2 — payload q (K or K/2, N) int8, exponents e (K/tile, N)
int8 — summing x[:, tile] @ (q_tile * 2^e_tile) over the k-tiles in f32.
The output is `out_dtype`, by default x's (the reference kernel's
`out_dtype = x.dtype`), or with `spec` the 8-bit GRAU bus of the full sum
scaled by f32(1/s_in).

Bound on the H100: memory bytes (the weight stream at M = 8 / 32); the
source note in the .cu file has the numbers and what the design does about
them. The kernel's grid splits K into parts of whole pack tiles
(`plan_parts`, a plain function of the shapes and the SM count); with more
than one part the f32 partial sums go to a workspace [parts, M, N] that a
second launch sums in part order, then writes the output. M above 32 runs
as a grid over row tiles of 32. Any pack tile the reference takes runs
(the kernel zero-fills a tile's ragged edge); an N that is not a multiple
of 16 is padded here with zero payload bytes — exact zeros, as the
reference's own padding — and the output sliced back (a copy of the
weight per call: no served shape has such an N).

`matmul_wq` launches the kernel for CUDA tensors and runs `matmul_wq_plain`
(the same per-tile f32 accumulation in torch) for CPU tensors; it counts
`.launches` (one per call, whatever the part count) and
`.epilogue_launches` (those with the fused GRAU datapath).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.grau import out_dtype as grau_out_dtype
from repro_torch.kernels.ref import attn_output_quant, inv_scale
from repro_torch.pwlf.spec import GRAUSpec
from repro_torch.quant.pot import dequantize_pot, unpack_int4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, q, e, out, ws, M, N, K, tile, bits, dtype, out_kind, parts, tpp, regs,
# num_exponents, qmin, qmax, inv_s, stream
SIGNATURES = {"matmul_wq_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _P, _I, _I, _I, _F, _P)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_F32, _OUT_BF16, _OUT_GRAU = 0, 1, 2
BLOCK_N = 128          # output channels a CUDA block (csrc/matmul_wq.cu kBN)


def row_tile(m: int) -> int:
    """Rows of x a CUDA block holds: 8, 16 or 32 (the kernel's NT * 8)."""
    return 8 if m <= 8 else 16 if m <= 16 else 32


@functools.lru_cache(maxsize=1024)
def plan_parts(m: int, n: int, kdim: int, tile: int,
               sms: int = kbuild.H100_SMS) -> Tuple[int, int]:
    """(parts, tiles per part) of the kernel's split over K: runs of whole
    pack tiles (each part starts on a new exponent row), as few as give the
    grid (column tiles x row tiles x parts) at least two blocks per SM, and
    at most one part per tile. The last part may hold fewer tiles."""
    kt = kdim // tile
    blocks = -(-n // BLOCK_N) * -(-m // row_tile(m))
    want = -(-2 * sms // blocks)
    tpp = max(1, kt // want)
    return -(-kt // tpp), tpp


def _check(x, q, e, bits: int, kdim: int) -> int:
    """Validate the 2-D operands; returns the tile width."""
    if x.dim() != 2 or q.dim() != 2 or e.dim() != 2:
        raise ValueError(f"matmul_wq wants 2-D x, q, e; got {tuple(x.shape)}"
                         f", {tuple(q.shape)}, {tuple(e.shape)}")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if q.dtype != torch.int8 or e.dtype != torch.int8:
        raise ValueError("payload and exponents must be int8")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x dtype {x.dtype}: want float32 or bfloat16")
    m, k = x.shape
    kt, n = e.shape
    if k != kdim or kt < 1 or kdim % kt:
        raise ValueError(f"x has K={k}; weight kdim={kdim} with {kt} tiles")
    tile = kdim // kt
    if bits == 4 and tile % 2:
        raise ValueError(f"tile {tile} is odd: 4-bit tiles pack in pairs")
    want = (kdim if bits == 8 else kdim // 2, n)
    if tuple(q.shape) != want:
        raise ValueError(f"payload shape {tuple(q.shape)}, want {want}")
    devs = {x.device, q.device, e.device}
    if len(devs) != 1:
        raise ValueError(f"all inputs must share one device, got {devs}")
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        for name, t in (("q", q), ("e", e)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if n % 16 == 0 and (q.data_ptr() % 16 or e.data_ptr() % 16):
            raise ValueError("payload and exponents must start on a 16-byte "
                             "boundary")
    return tile


def matmul_wq_plain(x: torch.Tensor, q: torch.Tensor, e: torch.Tensor, *,
                    bits: int, kdim: int, spec: Optional[GRAUSpec] = None,
                    s_in: float = 1.0,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain torch version of the kernel (2-D operands): per k-tile, unpack
    and dequantize the tile exactly, accumulate x_tile @ w_tile in f32."""
    kt, n = e.shape
    tile = kdim // kt
    tp = q.shape[0] // kt
    xf = x.float()
    acc = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    for i in range(kt):
        qt = q[i * tp:(i + 1) * tp]
        if bits == 4:
            qt = unpack_int4(qt.t()).t()          # rows [0, t/2) low nibbles
        acc += xf[:, i * tile:(i + 1) * tile] @ dequantize_pot(qt, e[i])
    if spec is not None:
        return attn_output_quant(acc, spec, s_in)
    return acc.to(out_dtype or x.dtype)


def _pad_n(t: torch.Tensor, n: int) -> torch.Tensor:
    """t (rows, N) int8 widened to n columns with zero bytes."""
    out = torch.zeros((t.shape[0], n), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def _launch(x, q, e, *, bits, kdim, tile, spec, s_in, out_dtype):
    n_out = e.shape[1]
    if n_out % 16:      # weight rows in whole 16-byte vectors; zeros dequant
        n16 = -(-n_out // 16) * 16                       # to exact zeros
        q, e = _pad_n(q, n16), _pad_n(e, n16)
    m, n = x.shape[0], e.shape[1]
    if x.data_ptr() % 16:
        x = x.clone()                  # the kernel stages x in 16-byte vectors
    parts, tpp = plan_parts(m, n, kdim, tile, kbuild.sm_count(x.device))
    ws = (torch.empty((parts, m, n), dtype=torch.float32, device=x.device)
          if parts > 1 else None)
    if spec is not None:
        out = torch.empty((m, n), dtype=grau_out_dtype(spec.qmin),
                          device=x.device)
        regs = spec.packed(x.device)
        epi = (regs.data_ptr(), spec.num_exponents, spec.qmin, spec.qmax,
               inv_scale(s_in))
        out_kind = _OUT_GRAU
    else:
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
        epi = (None, 0, 0, 0, 0.0)
        out_kind = _OUT_F32 if out_dtype == torch.float32 else _OUT_BF16
    lib = kbuild.library("matmul_wq", SIGNATURES)
    err = lib.matmul_wq_launch(
        x.data_ptr(), q.data_ptr(), e.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, n, kdim, tile, bits,
        _DTYPE_CODE[x.dtype], out_kind, parts, tpp, *epi,
        torch.cuda.current_stream(x.device).cuda_stream)
    kbuild.check(err, "matmul_wq_launch")
    return out if n == n_out else out[:, :n_out].contiguous()


def matmul_wq(x: torch.Tensor, w, spec: Optional[GRAUSpec] = None, *,
              s_in: float = 1.0,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., K) @ a packed 2-D QuantWeight (contraction axis -2) ->
    (..., N): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. With `spec` the fused GRAU epilogue emits the 8-bit bus;
    otherwise the output dtype is `out_dtype` (default: x's), so the f32
    sum behind a bf16 product can be read."""
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype {out_dtype}: want float32 or bfloat16")
    if w.q.dim() != 2 or w.caxis != -2:
        raise ValueError(f"matmul_wq wants a 2-D weight packed along axis "
                         f"-2, got q {tuple(w.q.shape)} caxis {w.caxis}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    tile = _check(x2, w.q, w.e, w.bits, w.kdim)
    if x2.device.type == "cpu":
        out = matmul_wq_plain(x2, w.q, w.e, bits=w.bits, kdim=w.kdim,
                              spec=spec, s_in=s_in, out_dtype=out_dtype)
    else:
        out = _launch(x2.contiguous(), w.q, w.e, bits=w.bits, kdim=w.kdim,
                      tile=tile, spec=spec, s_in=s_in, out_dtype=out_dtype)
        matmul_wq.launches += 1
        matmul_wq.epilogue_launches += spec is not None
    return out.reshape(*lead, out.shape[-1])


matmul_wq.launches = matmul_wq.epilogue_launches = 0
