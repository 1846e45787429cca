"""Attention: chunked (flash-style) training attention over the full
sequence, and attention over the paged KV pool — write paths, the gathered
dense view, and decode / chunked-prefill attention through either the CUDA
kernels ("kernel") or the gathered view ("gather"), over float pools
(PagedKVCache) or packed 8/4-bit pools with power-of-two block exponents
(QuantPagedKVCache, quant/kv.py).

Unlike the JAX package, whose arrays are immutable, the pool writes here
update the pool tensors in place (the pools are the largest tensors the
server holds, and a functional update would copy a whole layer's pool per
token); the functions still return the cache so call sites read the same.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.quant import kv as kvq

NEG_INF = -1e30


def _largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (chunk sizes must tile the seq)."""
    cap = min(cap, n)
    for c in range(cap, 0, -1):
        if n % c == 0:
            return c
    return 1


def _chunk_attend(q, k, v, *, q_offset, kv_offset, causal, scale):
    """One (q_chunk, kv_chunk) tile: returns (scores_max, exp_sums,
    out_part), each (b, kvh, g, qc[, d]) in f32.

    q: (b, qc, h, d); k/v: (b, kc, kvh, d) with h = kvh * groups. The
    causal mask is a (qc, kc) additive bias of 0 / -1e30, as in the
    reference."""
    b, qc, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, qc, kvh, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(qc, device=q.device)
        kpos = kv_offset + torch.arange(k.shape[1], device=q.device)
        bias = torch.where(qpos[:, None] >= kpos[None, :], 0.0, NEG_INF)
        logits = logits + bias
    m = logits.amax(-1)                                            # (b,k,g,q)
    p = torch.exp(logits - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())            # (b,k,g,q,d)
    return m, l, o


def chunked_attention(
    q: torch.Tensor,                  # (b, s_q, h, d)
    k: torch.Tensor,                  # (b, s_kv, kvh, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    q_offset: int = 0,
    scale: Optional[float] = None,
    impl: str = "kernel",             # "kernel" | "plain"
) -> torch.Tensor:
    """Training attention over the full sequence, the logits never
    materialised at (seq, seq).

    impl="kernel": on a CUDA tensor the forward is the flash kernel
    (kernels/flash_attention.FlashAttention, differentiated from its saved
    lse over (q_chunk x kv_chunk) tiles); on a CPU tensor it is the plain
    scan below. impl="plain": the plain scan on any device — the
    reference's online-softmax recurrence over query chunks with an inner
    loop over KV chunks, differentiated by autograd."""
    b, s_q, h, d = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    q_chunk = _largest_divisor(s_q, q_chunk)
    kv_chunk = _largest_divisor(s_kv, kv_chunk)
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "kernel" and q.device.type == "cuda":
        from repro_torch.kernels.flash_attention import FlashAttention
        return FlashAttention.apply(q, k, v, causal, scale, q_offset,
                                    q_chunk, kv_chunk)
    outs = []
    for i0 in range(0, s_q, q_chunk):
        qc = q[:, i0:i0 + q_chunk]
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((b, kvh, g, q_chunk), device=q.device)
        o = torch.zeros((b, kvh, g, q_chunk, d), device=q.device)
        for j0 in range(0, s_kv, kv_chunk):
            mj, lj, oj = _chunk_attend(
                qc, k[:, j0:j0 + kv_chunk], v[:, j0:j0 + kv_chunk],
                q_offset=q_offset + i0, kv_offset=j0, causal=causal,
                scale=scale)
            m_new = torch.maximum(m, mj)
            a = torch.exp(m - m_new)
            bfac = torch.exp(mj - m_new)
            l = l * a + lj * bfac
            o = o * a[..., None] + oj * bfac[..., None]
            m = m_new
        out = o / torch.clamp(l[..., None], min=1e-30)             # (b,kvh,g,qc,d)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, d))
    return torch.cat(outs, dim=1).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor          # (batch, max_seq, kv_heads, head_dim)
    v: torch.Tensor          # (batch, max_seq, kv_heads, head_dim)
    length: torch.Tensor     # (batch,) int32 — filled prefix length


def decode_attention(
    q: torch.Tensor,                  # (b, 1, h, d)
    cache: KVCache,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention over the full cache (masked beyond `length`)."""
    b, _, h, d = q.shape
    kvh = cache.k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kvh, g, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          cache.k.float()) * scale
    pos = torch.arange(cache.k.shape[1], device=q.device)
    valid = pos[None] < cache.length[:, None]            # (b, s)
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, cache.v.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged KV cache (block-pool storage with slot -> block-table indirection)
# ---------------------------------------------------------------------------

class PagedKVCache(NamedTuple):
    """Block-pool KV storage for continuous-batching decode. Block 0 is the
    null/trash block: unmapped table entries point at it, so writes from
    idle slots or padded prefill positions land there harmlessly."""
    k: torch.Tensor          # (num_blocks, block_size, kv_heads, head_dim)
    v: torch.Tensor


class QuantPagedKVCache(NamedTuple):
    """Quantized block-pool KV storage: int8 words — one value per byte at
    bits=8, two split-halves nibbles at bits=4 — plus one int8 power-of-two
    exponent per (block, kv_head) per tensor. Exponents are set by
    whole-block prefill writes and only ever raised (with a rounding
    requantization of the resident payload) by decode writes."""
    k: torch.Tensor          # (num_blocks, block_size, kvh, packed_hd) int8
    v: torch.Tensor
    k_exp: torch.Tensor      # (num_blocks, kvh) int8
    v_exp: torch.Tensor
    bits: int = 8            # 8 or 4


AnyPagedKVCache = Union[PagedKVCache, QuantPagedKVCache]


def cache_slice(pool: AnyPagedKVCache, r: int) -> AnyPagedKVCache:
    """One repeat's pools (views) out of a leaf stacked over repeats."""
    if isinstance(pool, QuantPagedKVCache):
        return QuantPagedKVCache(pool.k[r], pool.v[r], pool.k_exp[r],
                                 pool.v_exp[r], bits=pool.bits)
    return PagedKVCache(pool.k[r], pool.v[r])


def _kernel_pools(cache: AnyPagedKVCache) -> dict:
    """The pool arguments of the attention kernels for either cache kind."""
    if isinstance(cache, QuantPagedKVCache):
        return dict(k_exp=cache.k_exp, v_exp=cache.v_exp, kv_bits=cache.bits)
    return {}


class PagedState(NamedTuple):
    """Per-step slot metadata shared by every layer (not part of the pools)."""
    block_table: torch.Tensor   # (slots, blocks) int32; 0 = unmapped
    length: torch.Tensor        # (slots,) int32 — valid prefix length per slot
    ctx: Optional[torch.Tensor] = None   # (slots,) int32, chunked prefill
    # only: each row's real context length. Quantized pools keep positions
    # >= ctx (chunk padding) out of a block's exponent amax


class AttnQuant(NamedTuple):
    """GRAU register file + scales for the fused attention-output epilogue:
    `s_in` maps the f32 attention output into the unit's int32 MAC domain,
    `s_out` dequantizes the 8-bit bus back to float for the output
    projection."""
    spec: Any
    s_in: float
    s_out: float


def _write_slots(cache: AnyPagedKVCache, st: PagedState):
    """(pool block, offset) of each slot's decode write. The column index is
    clamped to the table: a slot the host has retired while the device
    still counts it (a ghost) has a NULL row, so its write lands in the
    trash block whatever its length."""
    block_size = cache.k.shape[1]
    col = torch.clamp(st.length.long() // block_size,
                      max=st.block_table.shape[1] - 1)
    blk = torch.gather(st.block_table, 1, col[:, None])[:, 0].long()
    return blk, (st.length % block_size).long()


def _quant_paged_update(cache: QuantPagedKVCache, k_new, v_new,
                        st: PagedState) -> QuantPagedKVCache:
    """Decode write into a quantized pool, one position per slot (in
    place). The block's exponent only rises: e_new = max(resident, token);
    when it rises the resident payload is requantized by a rounding right
    shift before the new position lands, so a block stays on one grid."""
    bits = cache.bits
    blk, off = _write_slots(cache, st)
    rows = torch.arange(blk.shape[0], device=blk.device)

    def upd(buf, exp, new):                       # new: (slots, kvh, hd)
        e_tok = kvq.pot_exponent(new.float().abs().amax(-1), bits)
        e_old = exp[blk]
        e_new = torch.maximum(e_old, e_tok)
        delta = e_new.to(torch.int32) - e_old.to(torch.int32)
        resident = buf[blk]                       # (slots, bs, kvh, hdp)
        q = kvq.unpack_int4(resident) if bits == 4 else resident
        q = kvq.requant_shift(q, delta[:, None, :, None], bits)
        q[rows, off] = kvq.quantize_pot(new, e_new[..., None], bits)
        buf[blk] = kvq.pack_int4(q) if bits == 4 else q
        exp[blk] = e_new

    upd(cache.k, cache.k_exp, k_new[:, 0])
    upd(cache.v, cache.v_exp, v_new[:, 0])
    return cache


def paged_update(cache: AnyPagedKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor, st: PagedState) -> AnyPagedKVCache:
    """Write one position per slot at logical index `length` via the table
    (in place; see _write_slots for ghost slots)."""
    if isinstance(cache, QuantPagedKVCache):
        return _quant_paged_update(cache, k_new, v_new, st)
    blk, off = _write_slots(cache, st)
    cache.k[blk, off] = k_new[:, 0].to(cache.k.dtype)
    cache.v[blk, off] = v_new[:, 0].to(cache.v.dtype)
    return cache


def paged_view(cache: AnyPagedKVCache, st: PagedState,
               max_blocks: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each slot's blocks into a dense (slots, logical_seq, ...) view
    (transient; garbage read through null-block entries is masked by
    `length` downstream). With `max_blocks`, only the first `max_blocks`
    table columns are gathered. Quantized pools gather the packed payload
    and the exponents, then dequantize (an f32 view)."""
    table = (st.block_table if max_blocks is None
             else st.block_table[:, :max_blocks])
    from repro_torch.kernels.ref import dense_kv_views
    return dense_kv_views(cache.k, cache.v, table, **_kernel_pools(cache))


def paged_decode_attention(
    q: torch.Tensor,                  # (b, 1, h, d)
    cache: AnyPagedKVCache,
    st: PagedState,                   # table possibly bucket-sliced; length =
                                      # positions already written - 1
    *,
    impl: str = "kernel",             # "kernel" | "gather"
    quant: Optional[AttnQuant] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention over a slot's mapped blocks (current token already
    written via `paged_update`, hence `st.length + 1` attended positions).

    impl="kernel" runs kernels/paged_attention.py (the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors); impl="gather" is the
    dense-view path. Both honor the optional fused GRAU output epilogue and
    return (b, 1, h, d) float (dequantized when quantizing).
    """
    lengths = st.length + 1
    if impl == "kernel":
        from repro_torch.kernels import paged_attention as paged_kernel
        o = paged_kernel.paged_attention(
            q[:, 0], cache.k, cache.v, st.block_table, lengths, scale=scale,
            spec=quant.spec if quant is not None else None,
            s_in=quant.s_in if quant is not None else None,
            **_kernel_pools(cache))
        if quant is not None:
            o = o.float() * quant.s_out
        return o[:, None].to(q.dtype)
    if impl != "gather":
        raise ValueError(f"unknown paged decode impl {impl!r}")
    kd, vd = paged_view(cache, st)
    o = decode_attention(q, KVCache(kd, vd, lengths), scale=scale)
    if quant is not None:
        from repro_torch.kernels.ref import attn_output_quant
        oq = attn_output_quant(o[:, 0], quant.spec, quant.s_in)
        o = (oq.float() * quant.s_out)[:, None].to(q.dtype)
    return o


def paged_prefill_update(cache: AnyPagedKVCache, k_new: torch.Tensor,
                         v_new: torch.Tensor, st: PagedState
                         ) -> AnyPagedKVCache:
    """Scatter one prefill chunk's K/V into the pool through the table (in
    place). k_new/v_new: (b, C, kvh, hd) with C a block multiple; st.length
    holds each row's block-aligned chunk start. Columns past a slot's
    reservation are NULL_BLOCK and land in trash.

    Quantized pools *set* each written block's exponent (quant/kv.
    store_block over the whole block): a chunk on the absolute grid always
    covers whole blocks. With st.ctx, positions >= ctx (chunk padding) stay
    out of the exponent's amax."""
    block_size = cache.k.shape[1]
    b, chunk = k_new.shape[0], k_new.shape[1]
    assert chunk % block_size == 0, (chunk, block_size)
    pos = (st.length.long()[:, None]
           + torch.arange(chunk, device=k_new.device)[None])        # (b, C)
    if isinstance(cache, QuantPagedKVCache):
        nbc = chunk // block_size
        blk = torch.gather(st.block_table, 1,
                           pos[:, ::block_size] // block_size).long()
        valid = None
        if st.ctx is not None:
            valid = (pos < st.ctx.long()[:, None]).reshape(b, nbc, block_size)
        for new, buf, exp in ((k_new, cache.k, cache.k_exp),
                              (v_new, cache.v, cache.v_exp)):
            payload, e = kvq.store_block(
                new.reshape(b, nbc, block_size, *new.shape[2:]), cache.bits,
                valid=valid)
            buf[blk] = payload
            exp[blk] = e
        return cache
    blk = torch.gather(st.block_table, 1, pos // block_size).long()
    off = pos % block_size
    cache.k[blk, off] = k_new.to(cache.k.dtype)
    cache.v[blk, off] = v_new.to(cache.v.dtype)
    return cache


def paged_prefill_attention(
    q: torch.Tensor,                  # (b, C, h, d) — one prefill chunk
    cache: AnyPagedKVCache,
    st: PagedState,                   # table sliced to the chunk-position
                                      # bucket; length = chunk start position
    *,
    impl: str = "kernel",             # "kernel" | "gather"
    quant: Optional[AttnQuant] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill attention: row r of the chunk attends positions
    0..start+r — the already-resident prefix plus the chunk itself (its K/V
    written first via `paged_prefill_update`). Returns (b, C, h, d) float
    (dequantized when quantizing)."""
    if impl == "kernel":
        from repro_torch.kernels import paged_attention as paged_kernel
        o = paged_kernel.paged_prefill_attention(
            q, cache.k, cache.v, st.block_table, st.length, scale=scale,
            spec=quant.spec if quant is not None else None,
            s_in=quant.s_in if quant is not None else None,
            **_kernel_pools(cache))
        if quant is not None:
            o = o.float() * quant.s_out
        return o.to(q.dtype)
    if impl != "gather":
        raise ValueError(f"unknown paged prefill impl {impl!r}")
    # the dense-view computation is exactly the oracle's
    from repro_torch.kernels.ref import paged_prefill_ref
    o = paged_prefill_ref(q, cache.k, cache.v, st.block_table, st.length,
                          scale=scale,
                          spec=quant.spec if quant is not None else None,
                          s_in=quant.s_in if quant is not None else None,
                          **_kernel_pools(cache))
    if quant is not None:
        o = o.float() * quant.s_out
    return o.to(q.dtype)
