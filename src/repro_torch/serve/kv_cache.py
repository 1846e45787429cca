"""Paged KV-cache management for the serving engine.

Storage is a pool of fixed-size blocks per layer (nn/attention.PagedKVCache);
this module owns everything around it: the host-side refcounted block
allocator, pool construction mirroring the model's (group, period-layer,
repeats) tree, the prompt / decode-block / chunk-table bucket ladders, and
the copy-on-write block copy of the prefix cache.

Conventions
-----------
* Block 0 is the null/trash block. Unmapped block-table entries are 0, so a
  write routed through them (idle slots during the global decode step, padded
  prefill blocks past a prompt's reservation) lands in scratch storage that no
  reader ever treats as valid.
* Blocks for a request's full lifetime (prompt + max_new_tokens) are reserved
  at admission; a request that cannot reserve waits in the queue (or, once
  it has waited, preempts later arrivals: serve/engine.py).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import resolve_device
from repro_torch.nn.attention import PagedKVCache, QuantPagedKVCache
from repro_torch.quant import kv as kvq

NULL_BLOCK = 0


# ---------------------------------------------------------------------------
# Bucket ladders
# ---------------------------------------------------------------------------

def default_buckets(max_len: int, multiple: int = 1,
                    lo: int = 16) -> Tuple[int, ...]:
    """Power-of-two bucket ladder up to max_len, rounded to `multiple`."""
    def round_up(n):
        return ((n + multiple - 1) // multiple) * multiple

    buckets = []
    b = lo
    while b < max_len:
        buckets.append(round_up(b))
        b *= 2
    buckets.append(round_up(max_len))
    return tuple(sorted(set(buckets)))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"length {n} exceeds largest prefill bucket {buckets[-1]}")


def decode_block_buckets(blocks_per_slot: int) -> Tuple[int, ...]:
    """Power-of-two ladder of live-block counts for the decode step: each
    tick runs the smallest bucket covering the longest live sequence, so
    per-step attention work scales with live context, not capacity."""
    buckets = []
    b = 1
    while b < blocks_per_slot:
        buckets.append(b)
        b *= 2
    buckets.append(blocks_per_slot)
    return tuple(sorted(set(buckets)))


def chunk_starts(cached_tokens: int, ctx: int, chunk: int) -> Tuple[int, ...]:
    """Absolute chunk-grid start positions covering [cached_tokens, ctx).

    Chunked prefill always runs on the *absolute* grid (chunk k covers
    positions [k*chunk, (k+1)*chunk)); `cached_tokens` must sit on the grid.
    """
    if cached_tokens % chunk:
        raise ValueError(f"cached prefix {cached_tokens} off the chunk grid "
                         f"(chunk={chunk})")
    return tuple(range(cached_tokens, max(ctx, cached_tokens), chunk))


def chunk_table_width(p0: int, chunk: int, block_size: int,
                      buckets: Sequence[int]) -> int:
    """Block-table width for the chunk starting at `p0`: the smallest bucket
    covering prefix + chunk (a pure function of the grid position)."""
    return bucket_for(blocks_for(p0 + chunk, block_size), buckets)


# ---------------------------------------------------------------------------
# Host-side block allocator
# ---------------------------------------------------------------------------

def blocks_for(tokens: int, block_size: int) -> int:
    return max(1, math.ceil(tokens / block_size))


class BlockAllocator:
    """Refcounted free-list allocator over the pool's block ids.

    Block 0 (the null/trash block) is reserved and never handed out. Blocks
    come back refcount 1 from `alloc`, `incref` adds a holder (a slot
    pinning a cached prefix block, the radix cache keeping a retired
    request's prefix) and `free` drops one — a block returns to the free
    list only when its last holder lets go. Freeing a block that
    is not currently allocated (double-free, never-allocated id,
    out-of-range id, the null block) raises instead of corrupting the free
    list.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}     # live block id -> refcount

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return len(self._refs)

    @property
    def shared_blocks(self) -> int:
        """Live blocks held by more than one owner (prefix sharing)."""
        return sum(1 for r in self._refs.values() if r > 1)

    def live_block_ids(self) -> List[int]:
        return list(self._refs)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if not self.can_alloc(n):
            return None
        taken = [self._free.pop() for _ in range(n)]
        for b in taken:
            self._refs[b] = 1
        return taken

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def incref(self, blocks: Sequence[int]) -> None:
        """Take an extra reference on already-allocated blocks (prefix
        sharing: a slot pinning cached blocks, the radix cache retaining a
        retired request's prefix)."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(f"incref of unallocated block {b}")
            self._refs[b] += 1

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; recycle at refcount zero.

        Raises ValueError on the null block, out-of-range ids, and blocks
        that are not currently allocated (double-free / never-allocated).
        """
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("free of the null block (never allocated)")
            if not (0 < b < self.num_blocks):
                raise ValueError(f"free of out-of-range block id {b} "
                                 f"(pool has {self.num_blocks} blocks)")
            refs = self._refs.get(b)
            if refs is None:
                raise ValueError(f"double-free (or never-allocated) block {b}")
            if refs > 1:
                self._refs[b] = refs - 1
            else:
                del self._refs[b]
                self._free.append(b)


# ---------------------------------------------------------------------------
# Pool construction
# ---------------------------------------------------------------------------

def paged_supported(cfg: ModelConfig) -> bool:
    """Paged serving covers plain GQA/MHA decoders. Recurrent state (SSM)
    has no seq axis to page; MLA latent and cross-attention caches keep the
    dense backend."""
    if cfg.mla is not None or cfg.encoder is not None:
        return False
    return all(spec.kind == "attn" and not spec.cross_attn
               for period, _ in cfg.groups for spec in period)


def pool_blocks(slots: int, max_seq: int, block_size: int) -> int:
    """Default pool size: every slot can hold max_seq tokens, + null block."""
    return slots * blocks_for(max_seq, block_size) + 1


def validate_pool_packing(cfg: ModelConfig, block_size: int,
                          bits: int, layer: str = "") -> None:
    """Every assumption the packed layout makes, checked when the pools are
    built, with the reference's messages."""
    where = f" ({layer})" if layer else ""
    kvq.validate_kv_bits(bits)
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    try:
        kvq.packed_head_dim(cfg.head_dim, bits)   # odd head_dim at 4-bit
    except ValueError as e:
        raise ValueError(f"{cfg.name}{where}: {e}") from None


def kv_bits_by_layer(cfg: ModelConfig, policy
                     ) -> Tuple[Tuple[int, ...], ...]:
    """Per-layer KV bits from the policy (16 everywhere when None); layer
    names follow the pool tree: group{gi}.l{li}."""
    return tuple(
        tuple(policy.kv_bits_for(f"group{gi}.l{li}") if policy else 16
              for li in range(len(period)))
        for gi, (period, _) in enumerate(cfg.groups))


def init_paged_caches(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                      dtype=torch.bfloat16, device=None, policy=None,
                      kv_heads: Optional[int] = None):
    """Pool tree with the model's structure: a tuple per group of
    per-period-layer leaves, each stacked over the group's repeats.
    16-bit layers (policy.kv_bits_for) get float PagedKVCache pools in
    `dtype`, k/v (repeats, num_blocks, block_size, kv_heads, head_dim);
    8/4-bit layers get QuantPagedKVCache: int8 payloads of width
    packed_head_dim plus (repeats, num_blocks, kv_heads) exponent planes
    filled with EXP_EMPTY, so the first write into a block sets its
    scale. The pools live on `device` (default: CUDA, see
    models/lm.resolve_device) and hold `kv_heads` heads: a serving-mesh
    rank's local count (serve/sharding.local_heads), by default
    cfg.kv_heads_phys."""
    device = resolve_device(device)
    if not paged_supported(cfg):
        raise ValueError(f"{cfg.name}: arch not pageable")
    kvh = cfg.kv_heads_phys if kv_heads is None else int(kv_heads)
    hd = cfg.head_dim
    bits_tree = kv_bits_by_layer(cfg, policy)
    caches = []
    for gi, (period, repeats) in enumerate(cfg.groups):
        per_layer = []
        for li in range(len(period)):
            bits = bits_tree[gi][li]
            validate_pool_packing(cfg, block_size, bits,
                                  layer=f"group{gi}.l{li}")
            if bits == 16:
                shape = (repeats, num_blocks, block_size, kvh, hd)
                per_layer.append(PagedKVCache(
                    k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device)))
                continue
            shape = (repeats, num_blocks, block_size, kvh,
                     kvq.packed_head_dim(hd, bits))
            eshape = (repeats, num_blocks, kvh)
            per_layer.append(QuantPagedKVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                k_exp=torch.full(eshape, kvq.EXP_EMPTY, dtype=torch.int8,
                                 device=device),
                v_exp=torch.full(eshape, kvq.EXP_EMPTY, dtype=torch.int8,
                                 device=device),
                bits=bits))
        caches.append(tuple(per_layer))
    return tuple(caches)


# ---------------------------------------------------------------------------
# Pool block ops
# ---------------------------------------------------------------------------

def copy_pool_block(pools, src: int, dst: int):
    """Copy one block (every layer's K and V) from pool id `src` to `dst`,
    in place, on the pools' device (one indexed copy a buffer, no host round
    trip).

    The copy-on-write step for partial-block prefix reuse: a cached block
    whose leading tokens match the new prompt is duplicated into a
    slot-private block before decode starts writing into it, so the shared
    cached copy is never mutated. Quantized pools copy the payload and the
    `k_exp` / `v_exp` exponent planes together: the planes have the same
    (repeats, block, ...) leading layout as the payloads."""
    src, dst = int(src), int(dst)
    for group in pools:
        for pool in group:
            bufs = [pool.k, pool.v]
            if isinstance(pool, QuantPagedKVCache):
                bufs += [pool.k_exp, pool.v_exp]
            for buf in bufs:
                buf[:, dst].copy_(buf[:, src])
    return pools


def scrub_pool_block(pools, blk: int):
    """Zero one block (every layer's K and V) in place — the numeric
    quarantine's step before a block that may hold NaN/Inf goes back to the
    allocator.

    Freeing alone would be unsound: a recycled block's stale payload is
    normally harmless (dead positions are masked by context length), but
    the attention still reads the bytes, and NaN survives a `0 *` mask.
    Copying from the null block is no better: ghost-active slots write real
    (possibly poisoned) values there. So float pools go to 0, and packed
    pools to a zero payload with EXP_EMPTY exponents (the never-written
    scale state, so the first real write re-arms the scale)."""
    blk = int(blk)
    for group in pools:
        for pool in group:
            pool.k[:, blk].zero_()
            pool.v[:, blk].zero_()
            if isinstance(pool, QuantPagedKVCache):
                pool.k_exp[:, blk].fill_(kvq.EXP_EMPTY)
                pool.v_exp[:, blk].fill_(kvq.EXP_EMPTY)
    return pools
