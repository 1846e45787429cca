"""Plain torch oracles for the kernels (the correctness ground truth)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.grau import grau_apply_int
from repro_torch.kernels.grau import out_dtype
from repro_torch.pwlf.spec import GRAUSpec
from repro_torch.quant import kv as kvq

NEG_INF = -1e30
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def round_to_int32(x: torch.Tensor) -> torch.Tensor:
    """round half to even, then a saturating f32 -> int32 cast with NaN -> 0
    (what the reference's round().astype(int32) and CUDA's __float2int_rn
    both give; a bare .to(torch.int32) does not saturate)."""
    r = torch.nan_to_num(torch.round(x), nan=0.0)
    return r.double().clamp(_I32_MIN, _I32_MAX).to(torch.int32)


def inv_scale(s_in: float) -> float:
    """The f32 -> MAC-domain multiplier: 1/s_in in double, rounded once to
    f32 (exactly what the kernels receive)."""
    return float(np.float32(1.0 / s_in))


def grau_ref(x: torch.Tensor, spec: GRAUSpec) -> torch.Tensor:
    """Oracle for kernels/grau.py: int32 MAC outputs -> 8-bit quantized acts."""
    return grau_apply_int(x, spec).to(out_dtype(spec.qmin))


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement), as an int32 sum
    wraps."""
    return (torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def matmul_grau_ref(x: torch.Tensor, w: torch.Tensor,
                    spec: GRAUSpec) -> torch.Tensor:
    """Oracle for kernels/matmul_grau.py: int8 GEMM -> GRAU epilogue -> the
    8-bit bus. x: (M, K) int8, w: (K, N) int8; the product is summed in
    int64 on the host and wrapped to int32 (the reference's int32 dot)."""
    acc = wrap_int32(x.cpu().long() @ w.cpu().long())
    return grau_apply_int(acc, spec).to(out_dtype(spec.qmin)).to(x.device)


def attn_output_quant(o: torch.Tensor, spec: GRAUSpec,
                      s_in: float) -> torch.Tensor:
    """The GRAU attention-output epilogue's math, on an f32 attention output:
    scale into the int32 MAC domain, run the datapath, emit the 8-bit bus."""
    xq = round_to_int32(o.float() * inv_scale(s_in))
    return grau_apply_int(xq, spec).to(out_dtype(spec.qmin))


def matmul_wq_ref(x: torch.Tensor, w, spec: Optional[GRAUSpec] = None,
                  s_in: float = 1.0) -> torch.Tensor:
    """Oracle for kernels/matmul_wq.py: f32 x @ quant/weights.dense(w) (a
    raw tensor makes it plain dense), then optionally the GRAU epilogue."""
    from repro_torch.quant import weights as wq
    out = x.float() @ wq.dense(w)
    if spec is None:
        return out
    return attn_output_quant(out, spec, s_in)


def dense_kv_views(k_pool, v_pool, block_table, *, k_exp=None, v_exp=None,
                    kv_bits: int = 16):
    """Gather (and, for 8/4-bit pools, dequantize through quant/kv.
    load_block) the per-slot dense K/V views through the block table."""
    rows, nblocks = block_table.shape
    block_size, kvh = k_pool.shape[1], k_pool.shape[2]
    seq = nblocks * block_size
    idx = block_table.long()
    if kv_bits < 16:
        hd = k_pool.shape[3] * (2 if kv_bits == 4 else 1)
        kd = kvq.load_block(k_pool[idx], k_exp[idx], kv_bits)
        vd = kvq.load_block(v_pool[idx], v_exp[idx], kv_bits)
    else:
        hd = k_pool.shape[3]
        kd, vd = k_pool[idx], v_pool[idx]
    return kd.reshape(rows, seq, kvh, hd), vd.reshape(rows, seq, kvh, hd)


def paged_attention_ref(
    q: torch.Tensor,             # (slots, h, d)
    k_pool: torch.Tensor,        # (num_blocks, block_size, kvh, d)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,   # (slots, nblocks) int32
    lengths: torch.Tensor,       # (slots,) int32 — attended positions per slot
    *,
    scale: Optional[float] = None,
    spec: Optional[GRAUSpec] = None,
    s_in: Optional[float] = None,
    k_exp: Optional[torch.Tensor] = None,
    v_exp: Optional[torch.Tensor] = None,
    kv_bits: int = 16,
) -> torch.Tensor:
    """Oracle for the decode kernel: gather the dense per-slot view through
    the block table, run masked softmax attention, optionally apply the GRAU
    output epilogue."""
    slots, h, d = q.shape
    kvh = k_pool.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    kd, vd = dense_kv_views(k_pool, v_pool, block_table, k_exp=k_exp,
                             v_exp=v_exp, kv_bits=kv_bits)
    qg = q.reshape(slots, kvh, g, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), kd.float()) * scale
    pos = torch.arange(kd.shape[1], device=q.device)
    valid = pos[None] < lengths.to(q.device)[:, None]
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, vd.float()).reshape(slots, h, d)
    if spec is not None:
        assert s_in is not None
        return attn_output_quant(o, spec, s_in)
    return o.to(q.dtype)


def paged_prefill_ref(
    q: torch.Tensor,             # (b, C, h, d) — one prefill chunk per row
    k_pool: torch.Tensor,        # (num_blocks, block_size, kvh, d)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,   # (b, nblocks) int32
    start: torch.Tensor,         # (b,) int32 — absolute position of chunk row 0
    *,
    scale: Optional[float] = None,
    spec: Optional[GRAUSpec] = None,
    s_in: Optional[float] = None,
    k_exp: Optional[torch.Tensor] = None,
    v_exp: Optional[torch.Tensor] = None,
    kv_bits: int = 16,
) -> torch.Tensor:
    """Oracle for the chunked-prefill kernel: chunk row r attends positions
    0..start+r of the gathered dense view."""
    b, chunk, h, d = q.shape
    kvh = k_pool.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    kd, vd = dense_kv_views(k_pool, v_pool, block_table, k_exp=k_exp,
                             v_exp=v_exp, kv_bits=kv_bits)
    qg = q.reshape(b, chunk, kvh, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kd.float()) * scale
    pos = torch.arange(kd.shape[1], device=q.device)
    row_end = (start.to(q.device)[:, None]
               + torch.arange(chunk, device=q.device)[None])     # (b, C)
    valid = pos[None, None] <= row_end[..., None]                # (b, C, s)
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, vd.float())
    o = o.permute(0, 3, 1, 2, 4).reshape(b, chunk, h, d)
    if spec is not None:
        assert s_in is not None
        return attn_output_quant(o, spec, s_in)
    return o.to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None, q_offset: int = 0):
    """Plain torch version of kernels/flash_attention.py's kernel, in the
    reference's layout: q (b, s_q, h, d), k and v (b, s_kv, kvh, d); query
    head hi reads KV head hi // (h // kvh); row r sits at position
    q_offset + r. Computed in f32 (float64 for float64 inputs) with masked
    scores -1e30. Returns (o in q's dtype, lse (b, h, s_q) in the compute
    dtype)."""
    b, s_q, h, d = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.to(acc).reshape(b, s_q, kvh, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(acc)) * scale
    if causal:
        qpos = q_offset + torch.arange(s_q, device=q.device)
        kpos = torch.arange(s_kv, device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.to(acc))
    o = o / torch.clamp(l, min=1e-30)
    lse = (m + torch.log(l))[..., 0].reshape(b, h, s_q)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s_q, h, d).to(q.dtype), lse
