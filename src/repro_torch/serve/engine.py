"""Continuous-batching serving engine over the paged KV pool: chunked prefill
on the absolute grid, decode block buckets, on-device termination and
deferred drains — the main path of the JAX package's serve/engine.py.

Request lifecycle: `submit()` enqueues; each `step()` admits waiting
requests into free slots (reserving their blocks), advances mid-prefill
slots by whole chunks under the prefill token budget (round-robin), and
runs one decode tick for every activated slot. The tick's sampled tokens
and EOS/max-token flags are computed on the device and stay there: the host
learns about them only when the pending ticks are drained — at `poll()`,
before an admission, or at `max_pending_ticks` — so the decode loop never
waits on the device per token.

Each decode tick slices the block table to the smallest decode bucket that
covers the longest live context, and attention runs through the CUDA
kernels (`paged_impl=None` or "kernel"; a CPU engine runs their plain
versions) or the gathered dense view ("gather", the comparison path).

Precision: one quant/policy.PrecisionPolicy (`precision`, or the uniform
`kv_bits` / `weight_bits` shorthands) assigns per-layer KV-pool bits (8/4:
packed pools with power-of-two block exponents, read by the same kernels)
and serving-weight bits (8/4: the parameter tree is packed once at
construction; the MLP runs through the matmul_wq kernel).

Left out of this slice (ROADMAP A5/A7/A8): the prefix cache, preemption,
cancel, deadlines, fault injection and containment, the journal,
snapshots, telemetry, the mesh, the dense backend and sampled decoding. A
failing chunk or tick raises to the caller.
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
    precision: Optional[Any] = None   # quant/policy.PrecisionPolicy: per-
    # layer KV-pool bits (16 float; 8/4 packed int pools with power-of-two
    # block exponents) and serving-weight bits (16 float; 8/4 packed planes)
    kv_bits: Optional[int] = None     # shorthand: uniform KV precision;
    # mutually exclusive with `precision`
    weight_bits: Optional[int] = None  # shorthand: uniform weight precision
    # (<16 packs the parameter tree once at construction); composes with
    # kv_bits into one policy; mutually exclusive with `precision`
    policy: str = "fcfs"          # "fcfs" | "prefill" (serve/scheduler.py)
    max_pending_ticks: int = 32   # force a host drain after this many
    # undelivered decode ticks (bounds ghost decode past an unseen EOS)
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
        self.scheduler = Scheduler(ecfg.policy, prefill_token_budget=budget)
        self.stats: Dict[str, Any] = {"ticks": 0, "decode_tokens": 0,
                                      "prefill_tokens": 0, "chunks": 0}
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
        the null block) and their state is held frozen by `active`."""
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

    def _can_admit(self, rs: RequestState) -> bool:
        return self.allocator.can_alloc(self._blocks_needed(rs))

    def _admit(self, rs: RequestState) -> bool:
        """Reserve blocks and arm the chunk-grid prefill; False means the
        reservation no longer fits (same-tick over-commit) and the caller
        requeues it. The decode-visible table row stays NULL until
        activation, so ghost decode writes keep landing in trash."""
        slot = self.slot_req.index(None)
        ctx = rs.prompt_len - 1       # prompt[-1] is fed by the first decode
        total = self._blocks_needed(rs)
        blocks = self.allocator.alloc(total)
        if blocks is None:
            return False
        rs.blocks = blocks
        row = np.zeros(self._chunk_cols, np.int32)
        row[:total] = blocks
        rs.table_row = row
        rs.slot = slot
        self.slot_req[slot] = rs
        rs.prefill_pos = 0
        rs.prefill_ctx = ctx
        rs.pending_chunks = list(kvc.chunk_starts(0, ctx, self.prefill_chunk))
        if not rs.pending_chunks:
            self._activate(slot, rs)
        else:
            self._prefilling.append(slot)
        return True

    def _activate(self, slot: int, rs: RequestState) -> None:
        """Prefill complete: make the slot decode-visible (install its table
        row, arm the device slot state)."""
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

    def _run_prefill_chunks(self) -> int:
        """Advance mid-prefill slots on the absolute chunk grid, spending at
        most the per-tick prefill token budget; grants rotate round-robin
        across prefilling slots (one chunk per slot per pass). A failing
        chunk raises: containment belongs to the robustness slice.
        Returns the number of chunks run."""
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

    def _retire(self, slot: int, rs: RequestState, reason: str,
                now: float, tick: int) -> None:
        self.scheduler.retire(rs, tick, now, reason)
        self.slot_req[slot] = None
        self._host_len[slot] = 0
        self.allocator.free(rs.blocks)
        rs.blocks = []
        self._set_table_row(slot, np.full(self._chunk_cols, kvc.NULL_BLOCK,
                                          np.int32))
        self._finished_unpolled.append(rs)

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
        return {**self.scheduler.metrics(), **self.stats,
                **self._static_metrics,
                "paged_impl": self.paged_impl,
                "device": str(self.device),
                "decode_buckets": list(self.decode_buckets),
                "prefill_chunk": self.prefill_chunk,
                "total_blocks": self.allocator.num_blocks,
                "free_blocks": self.allocator.free_blocks}
