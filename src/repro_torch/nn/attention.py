"""Attention over the paged KV pool (float pools): write paths, the gathered
dense view, and decode / chunked-prefill attention through either the CUDA
kernels ("kernel") or the gathered view ("gather").

Unlike the JAX package, whose arrays are immutable, the pool writes here
update the pool tensors in place (the pools are the largest tensors the
server holds, and a functional update would copy a whole layer's pool per
token); the functions still return the cache so call sites read the same.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30


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


class PagedState(NamedTuple):
    """Per-step slot metadata shared by every layer (not part of the pools)."""
    block_table: torch.Tensor   # (slots, blocks) int32; 0 = unmapped
    length: torch.Tensor        # (slots,) int32 — valid prefix length per slot


class AttnQuant(NamedTuple):
    """GRAU register file + scales for the fused attention-output epilogue:
    `s_in` maps the f32 attention output into the unit's int32 MAC domain,
    `s_out` dequantizes the 8-bit bus back to float for the output
    projection."""
    spec: Any
    s_in: float
    s_out: float


def paged_update(cache: PagedKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor, st: PagedState) -> PagedKVCache:
    """Write one position per slot at logical index `length` via the table
    (in place). The column index is clamped to the table: a slot the host
    has retired while the device still counts it (a ghost) has a NULL row,
    so its write lands in the trash block whatever its length."""
    block_size = cache.k.shape[1]
    col = torch.clamp(st.length.long() // block_size,
                      max=st.block_table.shape[1] - 1)
    blk = torch.gather(st.block_table, 1, col[:, None])[:, 0].long()
    off = (st.length % block_size).long()
    cache.k[blk, off] = k_new[:, 0].to(cache.k.dtype)
    cache.v[blk, off] = v_new[:, 0].to(cache.v.dtype)
    return cache


def paged_view(cache: PagedKVCache, st: PagedState,
               max_blocks: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each slot's blocks into a dense (slots, logical_seq, ...) view
    (transient; garbage read through null-block entries is masked by
    `length` downstream). With `max_blocks`, only the first `max_blocks`
    table columns are gathered."""
    table = (st.block_table if max_blocks is None
             else st.block_table[:, :max_blocks])
    slots, blocks_per_slot = table.shape
    block_size, kvh, hd = cache.k.shape[1], cache.k.shape[2], cache.k.shape[3]
    seq = blocks_per_slot * block_size
    idx = table.long()
    return (cache.k[idx].reshape(slots, seq, kvh, hd),
            cache.v[idx].reshape(slots, seq, kvh, hd))


def paged_decode_attention(
    q: torch.Tensor,                  # (b, 1, h, d)
    cache: PagedKVCache,
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
            s_in=quant.s_in if quant is not None else None)
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


def paged_prefill_update(cache: PagedKVCache, k_new: torch.Tensor,
                         v_new: torch.Tensor, st: PagedState) -> PagedKVCache:
    """Scatter one prefill chunk's K/V into the pool through the table (in
    place). k_new/v_new: (b, C, kvh, hd) with C a block multiple; st.length
    holds each row's block-aligned chunk start. Columns past a slot's
    reservation are NULL_BLOCK and land in trash."""
    block_size = cache.k.shape[1]
    b, chunk = k_new.shape[0], k_new.shape[1]
    assert chunk % block_size == 0, (chunk, block_size)
    pos = (st.length.long()[:, None]
           + torch.arange(chunk, device=k_new.device)[None])        # (b, C)
    blk = torch.gather(st.block_table, 1, pos // block_size).long()
    off = pos % block_size
    cache.k[blk, off] = k_new.to(cache.k.dtype)
    cache.v[blk, off] = v_new.to(cache.v.dtype)
    return cache


def paged_prefill_attention(
    q: torch.Tensor,                  # (b, C, h, d) — one prefill chunk
    cache: PagedKVCache,
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
            s_in=quant.s_in if quant is not None else None)
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
                          s_in=quant.s_in if quant is not None else None)
    if quant is not None:
        o = o.float() * quant.s_out
    return o.to(q.dtype)
