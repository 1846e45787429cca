"""Paged attention through the block table, as hand-written CUDA kernels for
Hopper (csrc/paged_attention.cu): one-token flash decode and chunked
(multi-query) prefill, each with the GRAU epilogue optionally fused.

Replaces the JAX package's kernels/paged_attention.py:
  * `paged_attention`         <- _paged_attention_jit (decode)
  * `paged_prefill_attention` <- _paged_prefill_jit (chunked prefill)

The engine stores K/V in a shared pool of fixed-size blocks; a slot owns only
the blocks its sequence occupies, and the table maps its logical blocks to
pool blocks (block 0 is the null block). Both kernels run an online-softmax
(flash) recurrence over exactly the live blocks — max(cdiv(len, bs), 1) for
decode, max(cdiv(start + C, bs), 1) for a prefill chunk, never past the
table width — so bytes read follow live tokens, not pool capacity.

Bound on the H100: memory bytes (see the source notes in the .cu files for
the numbers and what the designs do about them). bf16 queries, the served
dtype (csrc/paged_prefill.cu): one block per (sequence part, KV head,
batch row) on the bf16 tensor cores — for prefill over all C * g query
rows of the KV head, for decode over its g rows with 4 warps splitting
each tile's positions; the parts are runs of whole table blocks planned on
the host from the table width (`prefill_plan`, `decode_plan`), so a launch
is capturable in a CUDA graph, and a second launch combines their (o, m,
l) in part order from an f32 workspace: two CUDA launches a call. f32
queries (csrc/paged_attention.cu): one CUDA block per (16 query rows, KV
head, batch row) loops over the live blocks with the (m, l, acc) carry in
shared memory and registers — the TPU grid's sequential block axis made a
loop. Both take every head_dim of HEAD_DIMS (the reference's archs').

Quantized pools (`kv_bits` 8 or 4, quant/kv.py): the pools are int8 words
of width packed_head_dim(d, kv_bits) and `k_exp` / `v_exp` the
(num_blocks, kvh) int8 power-of-two exponent planes; both kernels dequantize
each block exactly at load (the reference's in-VMEM `_dequant_tile`), so the
bytes they move follow kv_bits.

Epilogue: with `spec` (+ `s_in`) the normalised f32 output is scaled by
f32(1/s_in), rounded half to even with saturation, and pushed through the
shared GRAU datapath (csrc/grau_datapath.cuh), emitting the 8-bit bus.

Each wrapper launches its kernel for CUDA tensors and runs its plain torch
version (`*_plain`: the same online-softmax recurrence over the live blocks)
for CPU tensors. `.launches` counts wrapper calls that launched the kernels
(one per call, whatever the CUDA launches), `.epilogue_launches` those
that ran the fused GRAU datapath, and `.kv8_launches` / `.kv4_launches`
those on 8- and 4-bit pools.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.grau import out_dtype as grau_out_dtype
from repro_torch.kernels.ref import NEG_INF, attn_output_quant, inv_scale
from repro_torch.pwlf.spec import GRAUSpec
from repro_torch.quant import kv as kvq

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, k_exp, v_exp, kv_bits, table, stride, start/len, out
_COMMON = (_P, _P, _P, _P, _P, _I, _P, _I, _P, _P)
SIGNATURES = {
    "paged_decode_launch": _COMMON + (_I, _I, _I, _I, _I, _I, _F, _I, _I,
                                      _P, _I, _I, _I, _F, _P),
    "paged_prefill_launch": _COMMON + (_I, _I, _I, _I, _I, _I, _I, _F, _I,
                                       _I, _P, _I, _I, _I, _F, _P),
}
# the tensor-core kernels (bf16 q): q, k, v, k_exp, v_exp, kv_bits, table,
# stride, start (decode: lengths), out, ws_o, ws_ml, batch, [chunk,] h, kvh,
# d, bs, nblocks, parts, bpp, scale, out_kind, regs, num_exponents, qmin,
# qmax, inv_s, stream
_EPI = (_F, _I, _P, _I, _I, _I, _F, _P)
BF16_SIGNATURES = {
    "paged_prefill_bf16_launch": _COMMON + (_P, _P) + (_I,) * 9 + _EPI,
    "paged_decode_bf16_launch": _COMMON + (_P, _P) + (_I,) * 8 + _EPI,
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_F32, _OUT_BF16, _OUT_GRAU = 0, 1, 2
# every head_dim of the reference's configs/archs.py; the kernels take any
# multiple of 16 and are instantiated for these
HEAD_DIMS = (16, 32, 48, 64, 128, 192, 256)
GROUP_ROWS = 128       # query rows a prefill block holds (paged_prefill.cu)
MIN_PART_POSITIONS = 64    # one tile of the tensor-core kernels
DECODE_BLOCKS_PER_SM = 4   # decode_plan's target before ragged lengths


@functools.lru_cache(maxsize=1024)
def prefill_plan(batch: int, kvh: int, rows: int, width: int, bs: int,
                 sms: int = kbuild.H100_SMS) -> Tuple[int, int]:
    """(parts, table blocks per part) of the bf16 prefill kernel's split
    over the sequence, from what the host knows — the table width, never
    `start`: as many parts as make batch x KV heads x row groups x parts
    fill the SMs, each a run of whole table blocks covering at least
    MIN_PART_POSITIONS positions (the last part may be shorter)."""
    groups = -(-rows // GROUP_ROWS)
    most = max(1, width * bs // MIN_PART_POSITIONS)
    want = -(-sms // (batch * kvh * groups))
    bpp = -(-width // max(1, min(want, most)))
    return -(-width // bpp), bpp


@functools.lru_cache(maxsize=1024)
def decode_plan(batch: int, kvh: int, width: int, bs: int,
                sms: int = kbuild.H100_SMS) -> Tuple[int, int]:
    """(parts, table blocks per part) of the bf16 decode kernel's split
    over the sequence, from what the host knows — the table width, never
    `lengths`: about as many parts as give batch x KV heads x parts
    DECODE_BLOCKS_PER_SM blocks an SM (the ragged lengths idle the parts
    past a slot's live blocks), each a run of whole table blocks of at
    least MIN_PART_POSITIONS positions, rounded to whole 64-position tiles
    where the block size divides 64 (the last part may be shorter)."""
    most = max(1, width * bs // MIN_PART_POSITIONS)
    want = -(-DECODE_BLOCKS_PER_SM * sms // (batch * kvh))
    bpp = -(-width // max(1, min(want, most)))
    if MIN_PART_POSITIONS % bs == 0:       # the nearest whole tiles
        step = MIN_PART_POSITIONS // bs
        bpp = max(1, (2 * bpp + step) // (2 * step)) * step
    bpp = min(bpp, width)
    return -(-width // bpp), bpp


def _vector_bytes(row_bytes: int) -> int:
    """Bytes a kernel copies at once from a pool row: 16, or 8 where the row
    is not whole 16-byte vectors (4-bit rows at head_dim 16 and 48)."""
    return 16 if row_bytes % 16 == 0 else 8


def _check_pools(q, k_pool, v_pool, k_exp, v_exp, kv_bits: int) -> None:
    """16-bit pools have q's dtype; 8/4-bit pools are int8 of width
    packed_head_dim(d, kv_bits) with (num_blocks, kvh) int8 exponents."""
    kvq.validate_kv_bits(kv_bits)
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be (num_blocks, block_size, kvh, d), "
                         f"got {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    h, d = q.shape[-2], q.shape[-1]
    nb, kvh = k_pool.shape[0], k_pool.shape[2]
    if kv_bits == 16:
        if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise ValueError("16-bit pools must have q's dtype")
        if k_exp is not None or v_exp is not None:
            raise ValueError("exponent planes belong to 8/4-bit pools")
        width = d
    else:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise ValueError(f"kv_bits={kv_bits} pools must be int8")
        for name, e in (("k_exp", k_exp), ("v_exp", v_exp)):
            if (e is None or e.dtype != torch.int8
                    or tuple(e.shape) != (nb, kvh)):
                raise ValueError(f"kv_bits={kv_bits} needs {name} as a "
                                 f"({nb}, {kvh}) int8 exponent plane")
        width = kvq.packed_head_dim(d, kv_bits)
    if k_pool.shape[3] != width or h % kvh:
        raise ValueError(f"head layout mismatch: q heads {h} x {d}, pool "
                         f"kv heads {kvh} x {k_pool.shape[3]} at "
                         f"kv_bits={kv_bits}")


def _check(q, k_pool, v_pool, block_table, start, *, rows_dim: int,
           out_dtype, k_exp=None, v_exp=None, kv_bits: int = 16) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q dtype {q.dtype}: want float32 or bfloat16")
    _check_pools(q, k_pool, v_pool, k_exp, v_exp, kv_bits)
    d = q.shape[-1]
    if (block_table.dim() != 2 or block_table.dtype != torch.int32
            or block_table.shape[0] != q.shape[0]
            or block_table.shape[1] < 1):
        raise ValueError("block_table must be (rows, nblocks>=1) int32")
    if start.shape != (q.shape[0],) or start.dtype != torch.int32:
        raise ValueError(f"{'lengths' if rows_dim == 1 else 'start'} must be "
                         f"({q.shape[0]},) int32")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype}: want float32 or bfloat16")
    exps = [e for e in (k_exp, v_exp) if e is not None]
    devs = {t.device for t in (q, k_pool, v_pool, block_table, start, *exps)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must share one device, got {devs}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if d not in HEAD_DIMS:
            raise ValueError(f"head_dim {d} not in the kernel's {HEAD_DIMS}")
        if block_table.stride(1) != 1:
            raise ValueError("block_table rows must be contiguous")
        for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                        ("start", start), ("k_exp", k_exp), ("v_exp", v_exp)):
            if t is not None and not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        vec = _vector_bytes(k_pool.shape[3] * k_pool.element_size())
        if k_pool.data_ptr() % vec or v_pool.data_ptr() % vec:
            raise ValueError(f"pools must start on a {vec}-byte boundary "
                             f"(the kernels read their rows in {vec}-byte "
                             "vectors)")


def _block_loader(k_pool, v_pool, k_exp, v_exp, kv_bits):
    """blk (b,) -> the f32 K and V blocks (b, bs, kvh, d): an upcast of
    16-bit pools, or quant/kv.load_block's exact dequant."""
    if kv_bits == 16:
        return lambda blk: (k_pool[blk].float(), v_pool[blk].float())
    return lambda blk: (kvq.load_block(k_pool[blk], k_exp[blk], kv_bits),
                        kvq.load_block(v_pool[blk], v_exp[blk], kv_bits))


def _attend_plain(qr, k_pool, v_pool, block_table, start, chunk, groups,
                  scale, k_exp=None, v_exp=None, kv_bits=16):
    """The kernels' recurrence in plain torch. qr: (b, kvh, R, d) f32 query
    rows ordered (chunk row, group); row (c, gi) attends positions
    <= start + c. Returns the normalised (b, kvh, R, d) f32 output."""
    load = _block_loader(k_pool, v_pool, k_exp, v_exp, kv_bits)
    b, kvh, rows, d = qr.shape
    bs = k_pool.shape[1]
    nblocks = block_table.shape[1]
    dev = qr.device
    row_end = (start.long()[:, None]
               + torch.arange(rows, device=dev)[None] // groups)    # (b, R)
    live = torch.clamp((start.long() + chunk + bs - 1) // bs, 1, nblocks)
    m = torch.full((b, kvh, rows, 1), NEG_INF, device=dev)
    l = torch.zeros((b, kvh, rows, 1), device=dev)
    acc = torch.zeros((b, kvh, rows, d), device=dev)
    for j in range(int(live.max())):
        k, v = load(block_table[:, j].long())                       # (b, bs, kvh, d)
        lg = torch.einsum("bkrd,btkd->bkrt", qr, k) * scale
        pos = j * bs + torch.arange(bs, device=dev)
        valid = pos[None, None, :] <= row_end[:, :, None]            # (b, R, bs)
        lg = torch.where(valid[:, None], lg, NEG_INF)
        m_new = torch.maximum(m, lg.amax(-1, keepdim=True))
        p = torch.exp(lg - m_new)
        alpha = torch.exp(m - m_new)
        upd = (j < live)[:, None, None, None]      # blocks past live: unread
        l = torch.where(upd, l * alpha + p.sum(-1, keepdim=True), l)
        acc = torch.where(upd, acc * alpha + torch.einsum(
            "bkrt,btkd->bkrd", p, v), acc)
        m = torch.where(upd, m_new, m)
    return acc / torch.clamp(l, min=1e-30)


def _finish_plain(o, spec, s_in, out_dtype):
    if spec is not None:
        return attn_output_quant(o, spec, s_in)
    return o.to(out_dtype)


def paged_attention_plain(q, k_pool, v_pool, block_table, lengths, *,
                          scale=None, spec=None, s_in=None, out_dtype=None,
                          k_exp=None, v_exp=None, kv_bits=16):
    """Plain torch version of the decode kernel (same arguments)."""
    slots, h, d = q.shape
    kvh = k_pool.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qr = q.reshape(slots, kvh, g, d).float()
    o = _attend_plain(qr, k_pool, v_pool, block_table, lengths.long() - 1, 1,
                      g, scale, k_exp, v_exp, kv_bits)
    return _finish_plain(o.reshape(slots, h, d), spec, s_in,
                         out_dtype or q.dtype)


def paged_prefill_plain(q, k_pool, v_pool, block_table, start, *,
                        scale=None, spec=None, s_in=None, out_dtype=None,
                        k_exp=None, v_exp=None, kv_bits=16):
    """Plain torch version of the prefill kernel (same arguments)."""
    b, chunk, h, d = q.shape
    kvh = k_pool.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qr = (q.reshape(b, chunk, kvh, g, d).permute(0, 2, 1, 3, 4)
          .reshape(b, kvh, chunk * g, d).float())
    o = _attend_plain(qr, k_pool, v_pool, block_table, start, chunk, g, scale,
                      k_exp, v_exp, kv_bits)
    o = (o.reshape(b, kvh, chunk, g, d).permute(0, 2, 1, 3, 4)
         .reshape(b, chunk, h, d))
    return _finish_plain(o, spec, s_in, out_dtype or q.dtype)


def _output(q, spec, s_in, out_dtype):
    """(out, out_kind, epilogue args) of one launch."""
    if spec is not None:
        out = torch.empty(q.shape, dtype=grau_out_dtype(spec.qmin),
                          device=q.device)
        regs = spec.packed(q.device)
        epi = (regs.data_ptr(), spec.num_exponents, spec.qmin, spec.qmax,
               inv_scale(s_in))
        out_kind = _OUT_GRAU
    else:
        out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
        epi = (None, 0, 0, 0, 0.0)
        out_kind = _OUT_F32 if out_dtype == torch.float32 else _OUT_BF16
    return out, out_kind, epi


def _pool_ptrs(k_pool, v_pool, k_exp, v_exp, kv_bits):
    return (k_pool.data_ptr(), v_pool.data_ptr(),
            k_exp.data_ptr() if k_exp is not None else None,
            v_exp.data_ptr() if v_exp is not None else None, kv_bits)


def _launch(fn_name, q, k_pool, v_pool, block_table, start, shape_args, *,
            scale, spec, s_in, out_dtype, k_exp, v_exp, kv_bits):
    """f32 q, decode or prefill: csrc/paged_attention.cu."""
    d = q.shape[-1]
    out, out_kind, epi = _output(q, spec, s_in, out_dtype)
    lib = kbuild.library("paged_attention", SIGNATURES)
    err = getattr(lib, fn_name)(
        q.data_ptr(), *_pool_ptrs(k_pool, v_pool, k_exp, v_exp, kv_bits),
        block_table.data_ptr(), block_table.stride(0), start.data_ptr(),
        out.data_ptr(), *shape_args, k_pool.shape[2], d, k_pool.shape[1],
        block_table.shape[1], scale, _DTYPE_CODE[q.dtype], out_kind, *epi,
        torch.cuda.current_stream(q.device).cuda_stream)
    kbuild.check(err, fn_name)
    return out


def _launch_bf16(q, k_pool, v_pool, block_table, start, *, scale, spec,
                 s_in, out_dtype, k_exp, v_exp, kv_bits):
    """bf16 q: csrc/paged_prefill.cu's tensor-core kernels, decode (q 3-D,
    `start` the lengths) or prefill (q 4-D), with the part plan and the f32
    workspace for the parts' (o, m, l)."""
    if q.data_ptr() % 16:
        q = q.clone()                  # the kernel reads q in 16-byte vectors
    decode = q.dim() == 3
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    chunk = 1 if decode else q.shape[1]
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    width = block_table.shape[1]
    rows = chunk * (h // kvh)
    sms = kbuild.sm_count(q.device)
    parts, bpp = (decode_plan(b, kvh, width, bs, sms) if decode else
                  prefill_plan(b, kvh, rows, width, bs, sms))
    ws_o = torch.empty((b, kvh, parts, rows, d), dtype=torch.float32,
                       device=q.device)
    ws_ml = torch.empty((b, kvh, parts, rows, 2), dtype=torch.float32,
                        device=q.device)
    out, out_kind, epi = _output(q, spec, s_in, out_dtype)
    lib = kbuild.library("paged_prefill", BF16_SIGNATURES)
    name = "paged_decode_bf16_launch" if decode else "paged_prefill_bf16_launch"
    shape = (b, h) if decode else (b, chunk, h)
    err = getattr(lib, name)(
        q.data_ptr(), *_pool_ptrs(k_pool, v_pool, k_exp, v_exp, kv_bits),
        block_table.data_ptr(), block_table.stride(0), start.data_ptr(),
        out.data_ptr(), ws_o.data_ptr(), ws_ml.data_ptr(), *shape, kvh, d, bs,
        width, parts, bpp, scale, out_kind, *epi,
        torch.cuda.current_stream(q.device).cuda_stream)
    kbuild.check(err, name)
    return out


def paged_attention(
    q: torch.Tensor,             # (slots, h, d)
    k_pool: torch.Tensor,        # (num_blocks, block_size, kvh, d)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,   # (slots, nblocks) int32; 0 = null block
    lengths: torch.Tensor,       # (slots,) int32 — positions to attend per slot
    *,
    scale: Optional[float] = None,
    spec: Optional[GRAUSpec] = None,
    s_in: Optional[float] = None,
    k_exp: Optional[torch.Tensor] = None,   # (num_blocks, kvh) int8
    v_exp: Optional[torch.Tensor] = None,
    kv_bits: int = 16,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Flash decode over the mapped blocks of each slot.

    `nblocks` (the table width) is the live-block bucket the caller chose;
    the table may be a column slice of a wider one (its row stride is
    passed). With `spec` (+ `s_in`, the f32 -> MAC-domain scale) the GRAU
    epilogue quantizes the output to the spec's 8-bit bus; otherwise the
    output dtype is `out_dtype` (default: q's). With `kv_bits` 8 or 4 the
    pools are packed int8 with exponent planes `k_exp` / `v_exp`.
    """
    if spec is not None and s_in is None:
        raise ValueError("the GRAU epilogue needs s_in")
    out_dtype = out_dtype or q.dtype
    if q.dim() != 3:
        raise ValueError(f"q must be (slots, h, d), got {tuple(q.shape)}")
    kw = dict(k_exp=k_exp, v_exp=v_exp, kv_bits=kv_bits)
    _check(q, k_pool, v_pool, block_table, lengths, rows_dim=1,
           out_dtype=out_dtype, **kw)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_table, lengths,
                                     scale=scale, spec=spec, s_in=s_in,
                                     out_dtype=out_dtype, **kw)
    slots, h, _ = q.shape
    if q.dtype == torch.bfloat16:          # the served dtype: tensor cores
        out = _launch_bf16(q, k_pool, v_pool, block_table, lengths,
                           scale=scale, spec=spec, s_in=s_in,
                           out_dtype=out_dtype, **kw)
    else:
        out = _launch("paged_decode_launch", q, k_pool, v_pool, block_table,
                      lengths, (slots, h), scale=scale, spec=spec, s_in=s_in,
                      out_dtype=out_dtype, **kw)
    _count(paged_attention, spec, kv_bits)
    return out


def paged_prefill_attention(
    q: torch.Tensor,             # (b, C, h, d) — one chunk of query positions
    k_pool: torch.Tensor,        # (num_blocks, block_size, kvh, d)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,   # (b, nblocks) int32; 0 = null block
    start: torch.Tensor,         # (b,) int32 — absolute position of chunk row 0
    *,
    scale: Optional[float] = None,
    spec: Optional[GRAUSpec] = None,
    s_in: Optional[float] = None,
    k_exp: Optional[torch.Tensor] = None,   # (num_blocks, kvh) int8
    v_exp: Optional[torch.Tensor] = None,
    kv_bits: int = 16,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Flash attention for one prefill chunk over a slot's mapped blocks.

    Row r attends pool positions 0..start+r (the already-resident prefix
    plus the chunk's own blocks, which must already be written through the
    table). Same epilogue, pool and output rules as `paged_attention`.
    """
    if spec is not None and s_in is None:
        raise ValueError("the GRAU epilogue needs s_in")
    out_dtype = out_dtype or q.dtype
    if q.dim() != 4:
        raise ValueError(f"q must be (b, C, h, d), got {tuple(q.shape)}")
    kw = dict(k_exp=k_exp, v_exp=v_exp, kv_bits=kv_bits)
    _check(q, k_pool, v_pool, block_table, start, rows_dim=2,
           out_dtype=out_dtype, **kw)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return paged_prefill_plain(q, k_pool, v_pool, block_table, start,
                                   scale=scale, spec=spec, s_in=s_in,
                                   out_dtype=out_dtype, **kw)
    b, chunk, h, _ = q.shape
    if q.dtype == torch.bfloat16:          # the served dtype: tensor cores
        out = _launch_bf16(q, k_pool, v_pool, block_table, start,
                           scale=scale, spec=spec, s_in=s_in,
                           out_dtype=out_dtype, **kw)
    else:
        out = _launch("paged_prefill_launch", q, k_pool, v_pool,
                      block_table, start, (b, chunk, h), scale=scale,
                      spec=spec, s_in=s_in, out_dtype=out_dtype, **kw)
    _count(paged_prefill_attention, spec, kv_bits)
    return out


def _count(fn, spec, kv_bits: int) -> None:
    fn.launches += 1
    fn.epilogue_launches += spec is not None
    fn.kv8_launches += kv_bits == 8
    fn.kv4_launches += kv_bits == 4


for _fn in (paged_attention, paged_prefill_attention):
    _fn.launches = _fn.epilogue_launches = 0
    _fn.kv8_launches = _fn.kv4_launches = 0
