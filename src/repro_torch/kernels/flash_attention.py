"""Dense GQA flash attention forward as a hand-written CUDA kernel for Hopper
(csrc/flash_attention.cu), its tiled backward, and the autograd Function
that joins them: the attention of LM training.

Replaces the JAX package's kernels/flash_attention.py::flash_attention (body
_flash_kernel): q (b, s_q, h, d) over k and v (b, s_kv, kvh, d), query head
hi reading KV head hi // (h // kvh), causal or not, query row r at position
q_offset + r (as nn/attention.chunked_attention places it). Masked scores are
-1e30 and the result acc / max(l, 1e-30), as in the reference.

Bound on the H100: tensor-core operations at the training shape (see the
source note in the .cu file). The kernel is chosen by dtype and head_dim,
never on a failure (`kernel_for`): bf16 at head_dim 64, 128, 192 and 256
runs the wgmma kernel (TMA tensor maps over the strided views, a producer
and two consumer warpgroups), bf16 at 16, 32 and 48 the mma.sync kernel
(wgmma's 64-column panels do not fit those widths), both rounding P to
bf16 before P V; f32 runs on the FMA units, in f32 throughout, at every
head_dim of HEAD_DIMS (the reference's archs').

`flash_attention` launches the kernel for CUDA tensors and runs
`ref.flash_attention_plain` for CPU tensors; both return (o, lse) with lse
(b, h, s_q) the row logsumexp of the scaled, masked scores (meta tensors
get empty ones; roofline/count.py counts every call through `cost`, and
the backward through `backward_cost`).
`flash_attention.launches` counts kernel launches.

The reference has no backward kernel: its gradient is XLA's autodiff of the
chunked scan. `flash_attention_backward` is the port's counterpart, plain
torch over (q_chunk x kv_chunk) tiles from the saved lse (no (s, s) tensor,
no second forward): D = rowsum(dO o), P = exp(S - lse), dV += P^T dO,
dS = P (dO V^T - D), dQ += dS K scale, dK += dS^T Q scale, dK and dV summed
over each KV head's query heads. A backward kernel is a later speed step.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ref import NEG_INF, flash_attention_plain
from repro_torch.roofline import count as rcount

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {"flash_attention_launch": (
    (_P,) * 5 + (_I,) * 6 + (_L,) * 9 + (ctypes.c_float, _I, _I, _I, _P))}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# every head_dim of the reference's configs/archs.py
HEAD_DIMS = (16, 32, 48, 64, 128, 192, 256)
WGMMA_HEAD_DIMS = (64, 128, 192, 256)


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The kernel of csrc/flash_attention.cu that a CUDA call at this dtype
    and head_dim launches: "wgmma" (bf16, head_dim a multiple of 64),
    "mma" (bf16 at 16, 32, 48) or "f32" (the FMA kernel)."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if d in WGMMA_HEAD_DIMS else "mma"


def _check(q, k, v, q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (b, s_q, h, d) and k, v (b, s_kv, kvh, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s_q, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"head layout mismatch: q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}")
    if s_q < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {HEAD_DIMS}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"q, k and v must share one device, got {devs}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")


def pairs(s_q: int, s_kv: int, causal: bool, q_offset: int = 0) -> int:
    """The (query, key) pairs a head attends: s_q s_kv, or under the causal
    mask the sum over query rows r of min(s_kv, q_offset + r + 1)."""
    if not causal:
        return s_q * s_kv
    full = max(0, min(s_q, s_kv - q_offset))    # rows r with r + off < s_kv
    tri = full * q_offset + full * (full + 1) // 2
    return tri + (s_q - full) * s_kv


def cost(q, k, causal: bool, q_offset: int) -> rcount.Cost:
    """The forward's work: 4 d operations a (query, key) pair and query
    head (Q K^T and P V) at q's type; q, k, v read once, o and the f32 lse
    written once."""
    b, s_q, h, d = q.shape
    n = b * h * pairs(s_q, k.shape[1], causal, q_offset)
    return rcount.Cost(flops=4.0 * n * d, kind=rcount.OP_KIND[q.dtype],
                       reads=rcount.nbytes(q) + 2 * rcount.nbytes(k),
                       writes=rcount.nbytes(q) + 4 * b * h * s_q)


def backward_cost(q, k, causal: bool, q_offset: int) -> rcount.Cost:
    """The backward's work: 10 d operations a pair and query head (the
    scores again, dV, dP, dQ and dK); q, k, v, o, lse and dO read once, dq,
    dk and dv written once."""
    b, s_q, h, d = q.shape
    n = b * h * pairs(s_q, k.shape[1], causal, q_offset)
    qb, kb = rcount.nbytes(q), rcount.nbytes(k)
    return rcount.Cost(flops=10.0 * n * d, kind=rcount.OP_KIND[q.dtype],
                       reads=3 * qb + 2 * kb + 4 * b * h * s_q,
                       writes=qb + 2 * kb)


def _rows_aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself when its last dimension is contiguous and every row starts
    on 16 bytes (the kernels read rows in 16-byte vectors, and the wgmma
    kernel's tensor maps need 16-byte strides, through the other strides;
    a dimension of size 1 is never stepped); otherwise a contiguous copy on
    a fresh allocation."""
    step = 16 // x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % step == 0 and s > 0
                    for s, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1)):
        return x
    return x.contiguous() if not x.is_contiguous() else x.clone()


def _strides(x: torch.Tensor):
    """x's element strides (b, s, heads), a dimension of size 1 given its
    contiguous stride (its own is never stepped, and a tensor map takes
    only positive multiples of 16 bytes)."""
    b, s, heads, d = x.shape
    dense = (s * heads * d, heads * d, d)
    return tuple(st if n > 1 else ds
                 for st, n, ds in zip(x.stride()[:3], (b, s, heads), dense))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0):
    """(o (b, s_q, h, d) in q's dtype, lse (b, h, s_q) f32): the CUDA
    kernel for CUDA tensors (float32 or bfloat16), the plain version for CPU
    tensors."""
    _check(q, k, v, q_offset)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    with rcount.kernel("flash_attention",
                       lambda: cost(q, k, causal, q_offset)):
        if q.is_meta:
            b, s_q, h, _ = q.shape
            return (torch.empty_like(q), torch.empty(
                (b, h, s_q), dtype=torch.float32, device="meta"))
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                         q_offset=q_offset)
        return _launch(q, k, v, causal=causal, scale=scale,
                       q_offset=q_offset)


def _launch(q, k, v, *, causal, scale, q_offset):
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype}: the kernel takes float32 or "
                         "bfloat16")
    if kernel_for(q.dtype, q.shape[-1]) == "wgmma" and not scale > 0:
        raise ValueError(f"scale {scale}: the wgmma kernel takes scale > 0 "
                         "(it folds the scale into its exponent)")
    q, k, v = _rows_aligned(q), _rows_aligned(k), _rows_aligned(v)
    b, s_q, h, d = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    lib = kbuild.library("flash_attention", SIGNATURES)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s_q, s_kv, h, kvh, d,
        *_strides(q), *_strides(k), *_strides(v),
        float(scale), int(bool(causal)), int(q_offset), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    kbuild.check(err, "flash_attention_launch")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             scale: Optional[float] = None, q_offset: int = 0,
                             q_chunk: int = 1024, kv_chunk: int = 1024):
    """(dq, dk, dv) of the flash forward from its saved (o, lse), in f32
    (float64 for float64 inputs) over (q_chunk x kv_chunk) tiles, skipping
    tiles wholly above the diagonal; cast to the inputs' dtypes (empty ones
    for meta inputs)."""
    with rcount.kernel("flash_attention_backward",
                       lambda: backward_cost(q, k, causal, q_offset),
                       launch=False):
        if q.is_meta:
            return (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v))
        return _backward(q, k, v, o, lse, do, causal=causal, scale=scale,
                         q_offset=q_offset, q_chunk=q_chunk,
                         kv_chunk=kv_chunk)


def _backward(q, k, v, o, lse, do, *, causal, scale, q_offset, q_chunk,
              kv_chunk):
    b, s_q, h, d = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    dev = q.device
    delta = (do.to(acc) * o.to(acc)).sum(-1)                   # (b, s_q, h)
    delta = delta.reshape(b, s_q, kvh, g).permute(0, 2, 3, 1)  # (b,kvh,g,s_q)
    lse = lse.to(acc).reshape(b, kvh, g, s_q)
    dq = torch.zeros((b, s_q, kvh, g, d), dtype=acc, device=dev)
    dk = torch.zeros((b, s_kv, kvh, d), dtype=acc, device=dev)
    dv = torch.zeros((b, s_kv, kvh, d), dtype=acc, device=dev)
    for i0 in range(0, s_q, q_chunk):
        i1 = min(i0 + q_chunk, s_q)
        qc = q[:, i0:i1].to(acc).reshape(b, i1 - i0, kvh, g, d)
        doc = do[:, i0:i1].to(acc).reshape(b, i1 - i0, kvh, g, d)
        lc, dc = lse[..., i0:i1, None], delta[..., i0:i1, None]
        qpos = q_offset + torch.arange(i0, i1, device=dev)
        for j0 in range(0, s_kv, kv_chunk):
            if causal and j0 > q_offset + i1 - 1:
                break                        # above the diagonal: P = 0
            j1 = min(j0 + kv_chunk, s_kv)
            kc, vc = k[:, j0:j1].to(acc), v[:, j0:j1].to(acc)
            s = torch.einsum("bqkgd,bskd->bkgqs", qc, kc).mul_(scale)
            if causal and j1 - 1 > q_offset + i0:
                kpos = torch.arange(j0, j1, device=dev)
                s = s.masked_fill_(qpos[:, None] < kpos[None, :], NEG_INF)
            p = s.sub_(lc).exp_()
            dv[:, j0:j1] += torch.einsum("bkgqs,bqkgd->bskd", p, doc)
            ds = torch.einsum("bqkgd,bskd->bkgqs", doc, vc).sub_(dc).mul_(p)
            del p, s
            dq[:, i0:i1] += torch.einsum("bkgqs,bskd->bqkgd", ds, kc)
            dk[:, j0:j1] += torch.einsum("bkgqs,bqkgd->bskd", ds, qc)
            del ds
    dq = dq.mul_(scale).reshape(b, s_q, h, d)
    return dq.to(q.dtype), dk.mul_(scale).to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """o = flash_attention(q, k, v)[0], differentiated by
    flash_attention_backward from the saved (o, lse). Under activation
    checkpointing the forward runs again in the backward pass and saves the
    same (deterministic) lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, q_chunk, kv_chunk):
        o, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                 q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, scale=scale, q_offset=q_offset,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              **ctx.args)
        return dq, dk, dv, None, None, None, None, None
