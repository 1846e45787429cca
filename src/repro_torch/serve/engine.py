"""Continuous-batching serving engine over the paged KV pool: chunked prefill
on the absolute grid, the radix prefix cache, preemption and cancel, decode
block buckets, on-device termination and deferred drains — the paged path
of the JAX package's serve/engine.py.

Request lifecycle: `submit()` enqueues; each `step()` admits waiting
requests into free slots (reserving their blocks, or preempting later
arrivals for a blocked head), advances mid-prefill slots by whole chunks
under the prefill token budget (round-robin), and runs one decode tick for
every activated slot. The tick's sampled tokens and EOS/max-token flags are
computed on the device and stay there: the host learns about them only when
the pending ticks are drained — at `poll()`, before an admission, or at
`max_pending_ticks` — so the decode loop never waits on the device per
token.

Prefix cache (`prefix_cache`): admission matches the prompt against a radix
tree of block-aligned cached prefixes (serve/radix_cache.py), pins the
matched blocks into the slot's table and prefills only the suffix chunks; a
partially matched final block is copied on write (kv_cache.copy_pool_block;
not at kv_bits < 16, whose block exponents depend on the donor's trailing
positions). Each chunk publishes its full blocks as it runs. Because the
chunk grid, the chunk-table widths and the decode kernel's sequence parts
(sized from the table's row stride, kernels/paged_attention.decode_plan)
never depend on how much prefix was cached or which bucket a tick runs,
cache-on and cache-off streams and pool contents are the same bits.

Overload: when the queue head cannot reserve blocks while slots are free
and it has waited `preempt_after_ticks`, the engine evicts last-admitted
decoding slots that arrived after it (LIFO), folds their generated tokens
into their prompts and requeues them for recompute through the same chunked
prefill. `cancel()` releases a request wherever it is (queued, mid-prefill,
mid-decode). Both leave the device slot "ghost-active", as a retirement
does: its table row is NULLed (the one row update a retirement makes), its
decode writes land in the trash block, the remaining countdown bounds them,
and `_activate` re-arms the slot for its next request.

Each decode tick slices the block table to the smallest decode bucket that
covers the longest live context, and attention runs through the CUDA
kernels (`paged_impl=None` or "kernel"; a CPU engine runs their plain
versions) or the gathered dense view ("gather", the comparison path).

Precision: one quant/policy.PrecisionPolicy (`precision`, or the uniform
`kv_bits` / `weight_bits` shorthands) assigns per-layer KV-pool bits (8/4:
packed pools with power-of-two block exponents, read by the same kernels)
and serving-weight bits (8/4: the parameter tree is packed once at
construction; the MLP runs through the matmul_wq kernel).

Left out of this slice (ROADMAP A3-A6, A8, A10): sampled decoding,
deadlines, fault injection and containment, the journal, snapshots,
telemetry, the mesh and the dense backend. A failing chunk or tick raises
to the caller.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.nn.attention import AttnQuant, PagedState
from repro_torch.quant import weights as wq_lib
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import sampling as samp_lib
from repro_torch.serve.radix_cache import RadixCache
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import RequestState, Scheduler


@dataclasses.dataclass
class Request:
    """User-facing request record. `out_tokens` is filled in as the engine
    generates (it aliases the live RequestState token list)."""
    rid: int
    prompt: np.ndarray            # (len,) int
    max_new_tokens: int = 32
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    out_tokens: Optional[List[int]] = None


@dataclasses.dataclass
class EngineConfig:
    slots: int = 8                # decode batch size
    max_seq: int = 512            # per-slot prompt+generation capacity
    eos_id: int = 1
    page_size: int = 16           # tokens per KV block
    num_blocks: Optional[int] = None   # pool size; None = no oversubscription
    decode_buckets: Optional[Tuple[int, ...]] = None  # live-block ladder;
    # None = power-of-two ladder up to blocks_per_slot
    paged_impl: Optional[str] = None   # None | "kernel": the CUDA kernels
    # (their plain versions for a CPU engine); "gather": the dense view
    attn_grau: Optional[Any] = None    # GRAUActivation-like (spec/s_in/s_out):
    # fuse the GRAU quantization epilogue on the paged attention output
    prefill_chunk: Optional[int] = None   # chunked-prefill grid step (a
    # page_size multiple); None = 32 rounded up to one page
    prefill_token_budget: Optional[int] = None  # max prefill tokens per
    # tick across all prefilling slots; None = one chunk per tick
    prefix_cache: bool = False    # radix-tree shared-prefix KV reuse:
    # admissions pin the longest cached block-aligned prefix and prefill
    # only the suffix
    precision: Optional[Any] = None   # quant/policy.PrecisionPolicy: per-
    # layer KV-pool bits (16 float; 8/4 packed int pools with power-of-two
    # block exponents) and serving-weight bits (16 float; 8/4 packed planes)
    kv_bits: Optional[int] = None     # shorthand: uniform KV precision;
    # mutually exclusive with `precision`
    weight_bits: Optional[int] = None  # shorthand: uniform weight precision
    # (<16 packs the parameter tree once at construction); composes with
    # kv_bits into one policy; mutually exclusive with `precision`
    policy: str = "fcfs"          # "fcfs" | "prefill" (serve/scheduler.py)
    max_prefills_per_tick: Optional[int] = None   # None: 1 under fcfs,
    # every free slot under prefill
    max_pending_ticks: int = 32   # force a host drain after this many
    # undelivered decode ticks (bounds ghost decode past an unseen EOS)
    preemption: bool = True       # KV-pressure preemption: when a waiting
    # request cannot reserve blocks while slots are free, evict
    # last-admitted decode slots (their generated tokens fold into the
    # prompt and are recomputed through chunked prefill on re-admission)
    preempt_after_ticks: int = 8  # a blocked head must have waited this many
    # ticks (since submit, or since its own last preemption) before it may
    # evict running requests
    seed: int = 0


class _SlotState(NamedTuple):
    """Device-resident per-slot decode state."""
    last_tok: torch.Tensor    # (slots, 1) int64 — token fed to the next decode
    lengths: torch.Tensor     # (slots,) int32 — valid context length
    remaining: torch.Tensor   # (slots,) int32 — decode budget left
    active: torch.Tensor      # (slots,) bool — slot is generating


class _TickRecord(NamedTuple):
    """One enqueued decode tick awaiting host-side delivery."""
    tick: int
    slots: Tuple[int, ...]   # host-believed active slots at enqueue time
    tokens: torch.Tensor     # (slots,) sampled tokens (on device)
    done: torch.Tensor       # (slots,) bool fused EOS/max-token flags


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, *,
                 dtype: Optional[torch.dtype] = None, device=None):
        """`params` must live on `device` (default: CUDA; see
        lm.resolve_device). `dtype` is the float KV pool dtype (default: the
        activations', lm.compute_dtype)."""
        self.device = lm.resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        if not kvc.paged_supported(cfg):
            raise ValueError(f"{cfg.name}: paged KV cache unsupported")
        if ecfg.paged_impl not in (None, "kernel", "gather"):
            raise ValueError(f"unknown paged_impl {ecfg.paged_impl!r}")
        if ecfg.precision is not None and ecfg.kv_bits is not None:
            raise ValueError("pass either precision (a PrecisionPolicy) or "
                             "kv_bits (uniform shorthand), not both")
        if ecfg.precision is not None and ecfg.weight_bits is not None:
            raise ValueError("pass either precision (a PrecisionPolicy) or "
                             "weight_bits (uniform shorthand), not both")
        if ecfg.kv_bits is not None or ecfg.weight_bits is not None:
            self.precision = PrecisionPolicy(
                kv_default_bits=(16 if ecfg.kv_bits is None
                                 else ecfg.kv_bits),
                weight_default_bits=(16 if ecfg.weight_bits is None
                                     else ecfg.weight_bits))
        else:
            self.precision = ecfg.precision
        self._kv_quant = (self.precision is not None
                          and self.precision.kv_quantized)
        self._wq = (self.precision is not None
                    and self.precision.weights_quantized)
        self.dtype = dtype or lm.compute_dtype(params)
        if self._wq:
            # packed once here (int4 evenness validated eagerly); leaves that
            # are already packed are kept as they are
            params = wq_lib.pack_params(params, cfg, self.precision)
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        self.paged_impl = ecfg.paged_impl or "kernel"
        self._act = lm.make_act(cfg, self.device)
        self._attn_quant = None
        if ecfg.attn_grau is not None:
            g = ecfg.attn_grau
            self._attn_quant = AttnQuant(spec=g.spec.to(self.device),
                                         s_in=float(g.s_in),
                                         s_out=float(g.s_out))

        bs = ecfg.page_size
        self.blocks_per_slot = kvc.blocks_for(ecfg.max_seq, bs)
        num_blocks = (ecfg.num_blocks if ecfg.num_blocks is not None else
                      kvc.pool_blocks(ecfg.slots, ecfg.max_seq, bs))
        self.allocator = kvc.BlockAllocator(num_blocks)
        self.radix = (RadixCache(self.allocator, bs) if ecfg.prefix_cache
                      else None)
        self.caches = kvc.init_paged_caches(cfg, num_blocks, bs,
                                            dtype=self.dtype,
                                            device=self.device,
                                            policy=self.precision)
        if ecfg.prefill_chunk is None:
            self.prefill_chunk = max(32, bs)
            self.prefill_chunk -= self.prefill_chunk % bs
        else:
            self.prefill_chunk = int(ecfg.prefill_chunk)
        if self.prefill_chunk < bs or self.prefill_chunk % bs:
            raise ValueError(f"prefill_chunk={self.prefill_chunk} must be a "
                             f"positive multiple of page_size={bs}")
        budget = (ecfg.prefill_token_budget
                  if ecfg.prefill_token_budget is not None
                  else self.prefill_chunk)
        if budget < self.prefill_chunk:
            raise ValueError(
                f"prefill_token_budget={budget} below one chunk "
                f"({self.prefill_chunk}): admitted prompts could never "
                "finish prefilling")
        # the table carries chunk-grid spill columns past blocks_per_slot
        # (always NULL): the last grid chunk of a near-max_seq prompt may
        # cover positions past the slot's reservation, and those writes
        # must land in trash
        self._chunk_cols = self.blocks_per_slot + self.prefill_chunk // bs
        self.chunk_buckets = kvc.decode_block_buckets(self._chunk_cols)
        self.chunk_widths = tuple(sorted({
            kvc.chunk_table_width(p0, self.prefill_chunk, bs,
                                  self.chunk_buckets)
            for p0 in range(0, ecfg.max_seq - 1, self.prefill_chunk)}))
        self.block_table = np.zeros((ecfg.slots, self._chunk_cols), np.int32)
        # device mirror of the decode-visible table, updated only when a row
        # changes (activation, retirement), never per tick
        self._table_dev = torch.zeros((ecfg.slots, self._chunk_cols),
                                      dtype=torch.int32, device=self.device)
        if ecfg.decode_buckets is not None:
            self.decode_buckets = tuple(sorted(set(ecfg.decode_buckets)))
            if (self.decode_buckets[0] < 1
                    or self.decode_buckets[-1] != self.blocks_per_slot):
                raise ValueError(
                    f"decode_buckets {self.decode_buckets} must be >= 1 "
                    f"and end at blocks_per_slot={self.blocks_per_slot}")
        else:
            self.decode_buckets = kvc.decode_block_buckets(
                self.blocks_per_slot)

        self.slot_req: List[Optional[RequestState]] = [None] * ecfg.slots
        self._host_len = np.zeros(ecfg.slots, np.int32)  # conservative shadow
        self._samp: List[SamplingParams] = [SamplingParams()] * ecfg.slots
        self._sp_packed = samp_lib.pack(self._samp)
        dev = self.device
        self._state = _SlotState(
            last_tok=torch.zeros((ecfg.slots, 1), dtype=torch.int64,
                                 device=dev),
            lengths=torch.zeros(ecfg.slots, dtype=torch.int32, device=dev),
            remaining=torch.zeros(ecfg.slots, dtype=torch.int32, device=dev),
            active=torch.zeros(ecfg.slots, dtype=torch.bool, device=dev),
        )
        self._pending: List[_TickRecord] = []
        self._prefilling: List[int] = []     # slots mid-chunked-prefill,
        # admission order; chunk grants rotate round-robin across them
        self._prefill_rr = 0
        if ecfg.preempt_after_ticks < 1:
            raise ValueError("preempt_after_ticks must be >= 1, got "
                             f"{ecfg.preempt_after_ticks}")
        self.scheduler = Scheduler(ecfg.policy, ecfg.max_prefills_per_tick,
                                   prefill_token_budget=budget)
        self.stats: Dict[str, Any] = {"ticks": 0, "decode_tokens": 0,
                                      "prefill_tokens": 0, "chunks": 0,
                                      "cached_prefix_tokens": 0}
        self._requests: Dict[int, Request] = {}
        self._finished_unpolled: List[RequestState] = []
        wbits = sorted(set(wq_lib.weight_bits_by_layer(
            cfg, self.precision).values()))
        kbits = sorted({b for grp in kvc.kv_bits_by_layer(cfg, self.precision)
                        for b in grp})
        self._static_metrics: Dict[str, Any] = {
            "weight_bits": wbits[0] if len(wbits) == 1 else wbits,
            "weights_quantized": self._wq,
            "weight_bytes": wq_lib.packed_param_bytes(self.params),
            "kv_bits": kbits[0] if len(kbits) == 1 else kbits,
            "kv_quantized": self._kv_quant,
            "prefix_cache": self.radix is not None,
        }

    # --- host -> device ---------------------------------------------------

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """Copy a small host array to the engine's device without waiting
        for the device's queue (pinned staging + non_blocking)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _set_table_row(self, slot: int, row: np.ndarray) -> None:
        self.block_table[slot] = row
        self._table_dev[slot].copy_(self._h2d(self.block_table[slot]),
                                    non_blocking=True)

    # --- device steps -----------------------------------------------------

    def _decode_tick(self, width: int):
        """Fused decode step + greedy sampling + termination, all on the
        device. Inactive slots decode masked garbage (their writes land in
        the null block) and their state is held frozen by `active`. The
        bucket is a column slice of the one table, whose row stride sizes
        the kernel's sequence parts, so a slot's output does not depend on
        the bucket `width`."""
        st = self._state
        paged = PagedState(self._table_dev[:, :width], st.lengths)
        logits, _ = lm.decode_step(self.params, self.cfg, st.last_tok,
                                   self.caches, paged=paged, act=self._act,
                                   paged_impl=self.paged_impl,
                                   attn_quant=self._attn_quant)
        nxt = samp_lib.sample(logits[:, -1], self._sp_packed)
        act_i = st.active.to(torch.int32)
        remaining = st.remaining - act_i
        done = st.active & ((nxt == self.ecfg.eos_id) | (remaining <= 0))
        self._state = _SlotState(
            last_tok=torch.where(st.active[:, None], nxt[:, None],
                                 st.last_tok),
            lengths=st.lengths + act_i,
            remaining=remaining,
            active=st.active & ~done,
        )
        return nxt, done

    def _chunk(self, toks: np.ndarray, row: np.ndarray, p0: int,
               ctx: int) -> None:
        """One chunk of the chunked-prefill state machine: tokens (1, C) at
        absolute positions p0..p0+C-1, written through the slot's (bucket-
        sliced) table row and attending the already-resident prefix. `ctx`
        (the prompt's real context) keeps chunk padding out of a quantized
        block's exponent."""
        st = PagedState(self._h2d(row), self._h2d(np.array([p0], np.int32)),
                        self._h2d(np.array([ctx], np.int32)))
        lm.prefill_step(self.params, self.cfg, self._h2d(toks), self.caches,
                        paged=st, act=self._act, paged_impl=self.paged_impl,
                        attn_quant=self._attn_quant, want_logits=False)

    # --- submission / results -------------------------------------------

    def submit(self, req: Request) -> int:
        plen = int(len(req.prompt))
        if plen < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if plen + req.max_new_tokens > self.ecfg.max_seq:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds max_seq ({self.ecfg.max_seq})")
        need = kvc.blocks_for(plen + req.max_new_tokens, self.ecfg.page_size)
        if need > self.allocator.num_blocks - 1:
            raise ValueError("request exceeds total KV pool capacity")
        if req.rid in self._requests:
            raise ValueError(f"duplicate rid {req.rid}")
        samp_lib.check_supported(req.sampling)
        rs = RequestState(rid=req.rid,
                          prompt=np.asarray(req.prompt, np.int32),
                          max_new_tokens=int(req.max_new_tokens),
                          sampling=req.sampling)
        req.out_tokens = rs.out_tokens          # live alias
        self._requests[req.rid] = req
        self.scheduler.submit(rs, self.stats["ticks"], time.perf_counter())
        return req.rid

    def poll(self) -> List[Request]:
        """Requests finished since the last poll, in completion order.
        Draining happens here: every pending tick's tokens and flags come to
        the host in one copy, and slots/blocks are recycled."""
        self._drain()
        out = [self._requests.pop(rs.rid) for rs in self._finished_unpolled]
        self._finished_unpolled = []
        return out

    # --- admission -------------------------------------------------------

    def _blocks_needed(self, rs: RequestState) -> int:
        return kvc.blocks_for(rs.prompt_len + rs.max_new_tokens,
                              self.ecfg.page_size)

    def _match_prefix(self, rs: RequestState):
        """Longest usable cached prefix for `rs` under the chunk grid:
        (match, blocks, nodes, cached_tokens, cow_src). Pure — the match is
        committed (LRU bump, hit/miss counts) only once the admission lands.

        Full coverage (the whole context cached, block-aligned or through a
        copy-on-write partial block) uses every matched block; otherwise
        reuse rounds down to a chunk-grid multiple, so the suffix chunks
        land on the same absolute grid positions (the same inputs, table
        widths and kernel plans) as a cache-off admission."""
        ctx = rs.prompt_len - 1
        if self.radix is None or ctx <= 0:
            return None, [], [], 0, None
        memo = rs.match_memo
        if memo is not None and memo[0] == self.radix.clock:
            return memo[1]
        m = self.radix.match(rs.prompt[:ctx])
        if self._kv_quant and m.cow_src is not None:
            # a quantized block's exponent depends on all of its positions,
            # the donor's trailing ones too: a partial-block copy would make
            # the reused prefix depend on the donor's suffix. Full blocks
            # stay exact (identical writes: identical payload and exponent)
            m = dataclasses.replace(m, cow_src=None, cow_node=None,
                                    cow_tokens=0)
        if m.tokens_matched + m.cow_tokens >= ctx:
            out = (m, m.blocks, m.nodes, ctx, m.cow_src)
        else:
            used = ((m.tokens_matched // self.prefill_chunk)
                    * self.prefill_chunk)
            nb = used // self.ecfg.page_size
            out = (m, m.blocks[:nb], m.nodes[:nb], used, None)
        rs.match_memo = (self.radix.clock, out)
        return out

    def _can_admit(self, rs: RequestState) -> bool:
        need = self._blocks_needed(rs)
        if self.radix is None:
            return self.allocator.can_alloc(need)
        _, blocks, _, _, _ = self._match_prefix(rs)
        if need - len(blocks) <= self.allocator.free_blocks:
            return True
        # cache-only blocks are evictable headroom, but the matched chain is
        # about to be pinned: never count it as both reused and evictable
        headroom = max(0, self.radix.evictable_blocks() - len(blocks))
        return need - len(blocks) <= self.allocator.free_blocks + headroom

    def _admit(self, rs: RequestState) -> bool:
        """Reserve blocks, pin the longest cached prefix, and arm the
        chunk-grid suffix prefill; False means the reservation no longer
        fits (same-tick over-commit) and the caller requeues it. The
        decode-visible table row stays NULL until activation, so ghost
        decode writes keep landing in trash."""
        slot = self.slot_req.index(None)
        ctx = rs.prompt_len - 1       # prompt[-1] is fed by the first decode
        total = self._blocks_needed(rs)
        match, cached, nodes, cached_tokens, cow_src = self._match_prefix(rs)
        if cached:
            # pin and hold before any eviction runs: the matched chain must
            # survive the allocation below
            self.radix.pin(nodes)
            self.allocator.incref(cached)
        need_new = total - len(cached)
        if self.radix is not None and not self.allocator.can_alloc(need_new):
            self.radix.evict(need_new)
        blocks = self.allocator.alloc(need_new)
        if blocks is None:
            if cached:
                self.allocator.free(cached)
                self.radix.unpin(nodes)
            return False
        if match is not None:
            self.radix.commit(match)
        rs.blocks = blocks
        rs.cached_blocks = list(cached)
        rs.radix_nodes = list(nodes)
        row = np.zeros(self._chunk_cols, np.int32)
        row[:len(cached)] = cached
        row[len(cached):total] = blocks
        rs.table_row = row
        if cow_src is not None:
            # decode writes position ctx into the block holding the matched
            # partial prefix: copy it into the slot's first private block so
            # the shared copy stays pristine
            kvc.copy_pool_block(self.caches, cow_src, row[len(cached)])
        rs.slot = slot
        self.slot_req[slot] = rs
        rs.prefill_pos = cached_tokens
        rs.prefill_ctx = ctx
        # full coverage needs no chunks and may sit off the grid; partial
        # reuse is always on it
        rs.pending_chunks = ([] if cached_tokens >= ctx else
                             list(kvc.chunk_starts(cached_tokens, ctx,
                                                   self.prefill_chunk)))
        rs.match_memo = None
        rs.cached_prefix_tokens = cached_tokens
        self.stats["cached_prefix_tokens"] += cached_tokens
        # publish cursor: suffix chunks extend the trie from the end of the
        # matched chain
        rs.published_blocks = len(cached)
        rs.radix_tail = nodes[-1] if nodes else None
        if not rs.pending_chunks:
            self._activate(slot, rs)
        else:
            self._prefilling.append(slot)
        return True

    def _activate(self, slot: int, rs: RequestState) -> None:
        """Prefill complete: make the slot decode-visible (install its table
        row, arm the device slot state — also a ghost-active slot's, left by
        a preemption, cancel or undrained finish)."""
        ctx = rs.prefill_ctx
        self._set_table_row(slot, rs.table_row)
        self._host_len[slot] = ctx
        self._samp[slot] = rs.sampling
        self._sp_packed = samp_lib.pack(self._samp)
        st = self._state
        st.last_tok[slot, 0] = int(rs.prompt[-1])
        st.lengths[slot] = ctx
        st.remaining[slot] = int(rs.max_new_tokens)
        st.active[slot] = True

    def _run_chunk(self, rs: RequestState) -> None:
        p0 = rs.pending_chunks.pop(0)
        C = self.prefill_chunk
        W = kvc.chunk_table_width(p0, C, self.ecfg.page_size,
                                  self.chunk_buckets)
        toks = np.zeros((1, C), np.int32)
        n = min(rs.prefill_ctx - p0, C)
        toks[0, :n] = rs.prompt[p0:p0 + n]
        self._chunk(toks, rs.table_row[None, :W], p0, rs.prefill_ctx)
        rs.prefill_pos = p0 + C
        rs.computed_prefill_tokens += n
        self.stats["prefill_tokens"] += n
        self.stats["chunks"] += 1
        if self.radix is not None:
            # publish the newly completed full blocks now: a same-prefix
            # request admitted a tick later can pin them (stream order makes
            # the values visible to any later reader); the cursor resumes
            # from the last published node
            bs = self.ecfg.page_size
            nfull = min(rs.prefill_pos, rs.prefill_ctx) // bs
            prev = rs.published_blocks
            if nfull > prev:
                tail, walked = self.radix.insert(
                    rs.prompt[prev * bs:nfull * bs],
                    list(rs.table_row[prev:nfull]), node=rs.radix_tail)
                # pinned until retirement: the cursor must survive eviction
                self.radix.pin(walked)
                rs.radix_nodes.extend(walked)
                rs.radix_tail = tail
                rs.published_blocks = nfull

    def _run_prefill_chunks(self) -> int:
        """Advance mid-prefill slots on the absolute chunk grid, spending at
        most the per-tick prefill token budget; grants rotate round-robin
        across prefilling slots (one chunk per slot per pass). Slots write
        disjoint blocks and shared cached blocks are read-only, so chunk
        order is invisible in the values. A failing chunk raises:
        containment belongs to a later slice. Returns the chunks run."""
        if not self._prefilling:
            return 0
        budget = self.scheduler.prefill_token_budget
        C = self.prefill_chunk
        start = self._prefill_rr % len(self._prefilling)
        self._prefill_rr += 1
        order = self._prefilling[start:] + self._prefilling[:start]
        ran = 0
        progressed = True
        while budget >= C and progressed:
            progressed = False
            for slot in order:
                if budget < C:
                    break
                rs = self.slot_req[slot]
                if not rs.pending_chunks:
                    continue
                self._run_chunk(rs)
                budget -= C
                ran += 1
                progressed = True
        still: List[int] = []
        for slot in self._prefilling:
            rs = self.slot_req[slot]
            if not rs.pending_chunks:
                self._activate(slot, rs)
            else:
                still.append(slot)
        self._prefilling = still
        return ran

    def _free_slot(self, slot: int, rs: RequestState) -> None:
        """Drop a slotted request's pool holds — its private blocks, its
        references to shared cached blocks (the cache's own reference keeps
        them warm) and its radix pins — and NULL the slot's table row, so
        the ghost-active device slot writes to trash."""
        self.slot_req[slot] = None
        self._host_len[slot] = 0
        self.allocator.free(rs.blocks)
        rs.blocks = []
        if rs.cached_blocks:
            self.allocator.free(rs.cached_blocks)
            rs.cached_blocks = []
        if rs.radix_nodes:
            self.radix.unpin(rs.radix_nodes)
            rs.radix_nodes = []
        self._set_table_row(slot, np.full(self._chunk_cols, kvc.NULL_BLOCK,
                                          np.int32))

    def _retire(self, slot: int, rs: RequestState, reason: str,
                now: float, tick: int) -> None:
        self.scheduler.retire(rs, tick, now, reason)
        self._free_slot(slot, rs)
        self._finished_unpolled.append(rs)

    def _retire_unslotted(self, rs: RequestState, reason: str, now: float,
                          tick: int) -> None:
        """Retire a request that holds no slot and no blocks (still queued):
        it becomes deliverable at the next poll()."""
        self.scheduler.retire(rs, tick, now, reason)
        self._finished_unpolled.append(rs)

    # --- preemption -------------------------------------------------------

    def _preempt_slot(self, slot: int) -> None:
        """Evict one decoding slot under KV-pool pressure and requeue its
        request at the queue head (scheduler.preempt). Its generated tokens
        fold into the prompt, so re-admission recomputes the whole context
        through the absolute-grid chunked prefill; prefill-computed full
        blocks it published stay cached (unpinned: evictable headroom, a
        cheap re-match at resume), decode-written blocks are dropped. The
        device slot goes ghost-active (see `_free_slot`)."""
        rs = self.slot_req[slot]
        self._release_slot_resources(slot, rs)
        new = rs.out_tokens[rs.folded_tokens:]
        if new:
            # a spent budget retires at drain, and preemption runs against a
            # drained pending buffer: budget remains
            assert len(new) < rs.max_new_tokens
            rs.prompt = np.concatenate(
                [rs.prompt, np.asarray(new, np.int32)])
            rs.max_new_tokens -= len(new)
            rs.folded_tokens = len(rs.out_tokens)
        self.scheduler.preempt(rs, self.stats["ticks"])

    def _release_slot_resources(self, slot: int, rs: RequestState) -> None:
        """`_free_slot`, then reset the request's slot and prefill state for
        a later re-admission. Its delivered tokens and fold bookkeeping are
        untouched."""
        self._free_slot(slot, rs)
        rs.slot = -1
        rs.table_row = None
        rs.prefill_pos = rs.prefill_ctx = 0
        rs.pending_chunks = []
        rs.match_memo = None
        rs.cached_prefix_tokens = 0
        rs.published_blocks = 0
        rs.radix_tail = None

    def _maybe_preempt(self) -> int:
        """Admit-or-preempt: when the blocked queue head has waited
        `preempt_after_ticks` (since submit, or since its own last
        preemption), evict last-admitted decode slots — LIFO, least progress
        lost — until the head's reservation fits. Returns slots preempted.

        Runs against a drained pending buffer. Victims are only requests
        that arrived after the head (a strict order, so two requests can
        never evict each other in turn) and are past their prefill. A
        what-if gate skips the whole round when even preempting every
        victim could not admit the head; the head is held out of the queue
        while victims requeue, so the freed blocks admit it first."""
        sched = self.scheduler
        head = sched.waiting[0]
        if self._can_admit(head):
            return 0
        if head.wait_age(self.stats["ticks"]) < self.ecfg.preempt_after_ticks:
            return 0
        victims = sorted(
            (s for s, r in enumerate(self.slot_req)
             if r is not None and s not in self._prefilling
             and r.arrival_seq > head.arrival_seq),
            key=lambda s: (self.slot_req[s].admit_tick, s))
        if not victims:
            return 0
        # what-if headroom across all victims: their private blocks that no
        # cache reference holds, plus cache blocks that become evictable
        # once every victim chain is unpinned, minus the head's own matched
        # chain (about to be pinned: never both reused and evictable)
        _, matched, _, _, _ = self._match_prefix(head)
        chains: List[Any] = []
        direct = 0
        for s in victims:
            rs = self.slot_req[s]
            chains.extend(rs.radix_nodes)
            published_own = max(0, rs.published_blocks
                                - len(rs.cached_blocks))
            direct += len(rs.blocks) - published_own
        headroom = 0
        if self.radix is not None:
            headroom = max(0, self.radix.evictable_after_unpin(chains)
                           - len(matched))
        if (self._blocks_needed(head) - len(matched)
                > self.allocator.free_blocks + direct + headroom):
            return 0
        sched.waiting.popleft()
        n = 0
        while victims and not self._can_admit(head):
            self._preempt_slot(victims.pop())
            n += 1
        sched.waiting.appendleft(head)
        return n

    # --- cancellation -----------------------------------------------------

    def cancel(self, rid: int) -> bool:
        """Cancel a live request wherever it is — queued, mid-chunked-
        prefill or mid-decode — releasing its blocks and pins. True if it
        was cancelled; False if it is unknown or already finished (pending
        ticks are drained first, so a stream that just completed keeps its
        tokens). The request retires with reason "cancelled" and poll()
        returns it with the tokens it produced."""
        if rid not in self._requests:
            return False
        self._drain()
        now = time.perf_counter()
        tick = self.stats["ticks"]
        for rs in self.scheduler.waiting:
            if rs.rid == rid:
                self.scheduler.waiting.remove(rs)
                self._retire_unslotted(rs, "cancelled", now, tick)
                return True
        for slot, rs in enumerate(self.slot_req):
            if rs is not None and rs.rid == rid:
                if slot in self._prefilling:
                    self._prefilling.remove(slot)
                self._retire(slot, rs, "cancelled", now, tick)
                return True
        return False

    # --- decode tick ------------------------------------------------------

    def _decode_bucket(self, active: List[int]) -> int:
        """Smallest decode block bucket covering every live context (+1 for
        the token written this tick). `_host_len` keeps counting for
        device-finished-but-undrained slots, which can only round up."""
        need = max(kvc.blocks_for(int(self._host_len[s]) + 1,
                                  self.ecfg.page_size) for s in active)
        return kvc.bucket_for(min(need, self.blocks_per_slot),
                              self.decode_buckets)

    def step(self) -> int:
        """Admissions + prefill chunks + one enqueued decode tick; returns
        the number of live slots advanced. Tokens and termination flags stay
        on the device until the next drain."""
        if self.scheduler.waiting:
            # admission needs an up-to-date view of free slots
            self._drain()
            free = self.slot_req.count(None)
            if free and self.ecfg.preemption:
                # head blocked on blocks (not slots): evict last-admitted
                # decode slots so it admits instead of stalling the queue
                if self._maybe_preempt():
                    free = self.slot_req.count(None)
            if free:
                not_admitted = [
                    rs for rs in self.scheduler.pick(
                        free, self.stats["ticks"], self._can_admit)
                    if not self._admit(rs)]
                for rs in reversed(not_admitted):
                    self.scheduler.requeue_front(rs)

        self._run_prefill_chunks()

        active = [s for s, r in enumerate(self.slot_req)
                  if r is not None and not r.pending_chunks]
        if not active:
            return 0
        nxt, done = self._decode_tick(self._decode_bucket(active))
        self._pending.append(_TickRecord(self.stats["ticks"], tuple(active),
                                         nxt, done))
        self._host_len[active] += 1
        self.stats["ticks"] += 1
        if len(self._pending) >= self.ecfg.max_pending_ticks:
            self._drain()
        return len(active)

    def _drain(self) -> None:
        """Deliver every pending decode tick: one device -> host copy for
        the whole batch. Ticks are replayed in order so retirement lands
        where a per-tick loop would have put it."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        toks = torch.stack([r.tokens for r in pending]).cpu().numpy()
        done = torch.stack([r.done for r in pending]).cpu().numpy()
        now = time.perf_counter()
        for i, rec in enumerate(pending):
            for slot in rec.slots:
                rs = self.slot_req[slot]
                if rs is None:
                    # ghost tick: the slot finished at an earlier (buffered)
                    # tick; its masked decode output is dropped
                    continue
                tok = int(toks[i, slot])
                rs.out_tokens.append(tok)
                if rs.first_token_time is None:
                    rs.first_token_time = now
                self.stats["decode_tokens"] += 1
                if done[i, slot]:
                    reason = ("eos" if tok == self.ecfg.eos_id
                              else "max_tokens")
                    self._retire(slot, rs, reason, now, rec.tick)

    # --- warmup / driver ----------------------------------------------------

    def warmup(self) -> int:
        """Run one decode tick per decode bucket and one prefill chunk per
        reachable chunk-table width on idle slots (every write lands in the
        null block), so the kernels are built and loaded and the libraries
        initialised before the first request. Returns the calls made."""
        assert all(r is None for r in self.slot_req) and not self._pending, \
            "warmup() requires an idle engine"
        calls = 0
        for nb in self.decode_buckets:
            self._decode_tick(nb)
            calls += 1
        toks = np.zeros((1, self.prefill_chunk), np.int32)
        for w in self.chunk_widths:
            self._chunk(toks, np.full((1, w), kvc.NULL_BLOCK, np.int32), 0, 0)
            calls += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return calls

    def run(self, requests: List[Request],
            max_ticks: int = 100000) -> List[Request]:
        """Serve `requests` to completion; returns them in completion order
        (each Request's out_tokens is also filled in place)."""
        for req in requests:
            self.submit(req)
        completed: List[Request] = []
        ticks = 0
        while ((self.scheduler.waiting or any(r is not None
                                              for r in self.slot_req))
               and ticks < max_ticks):
            made_progress = self.step() > 0 or not self.scheduler.waiting
            completed.extend(self.poll())
            ticks += 1
            if not made_progress and not any(r is not None
                                             for r in self.slot_req):
                break    # queue head can never be admitted — bail, don't spin
        return completed

    def metrics(self) -> Dict[str, Any]:
        m = {**self.scheduler.metrics(), **self.stats,
             **self._static_metrics,
             "paged_impl": self.paged_impl,
             "device": str(self.device),
             "decode_buckets": list(self.decode_buckets),
             "prefill_chunk": self.prefill_chunk,
             "total_blocks": self.allocator.num_blocks,
             "free_blocks": self.allocator.free_blocks}
        # the prefix-cache counters are present with the cache off too
        cached = self.stats["cached_prefix_tokens"]
        m["prefix_hit_rate"] = cached / max(
            cached + self.stats["prefill_tokens"], 1)
        m["evictions"] = self.radix.evictions if self.radix else 0
        if self.radix is not None:
            m["prefix_cache_nodes"] = self.radix.num_nodes()
            m["prefix_cache_hits"] = self.radix.hits
            m["prefix_cache_misses"] = self.radix.misses
        return m
