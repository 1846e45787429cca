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

Sampling: each slot's draw comes from a threefry key derived on the
device from (request id, draws so far) — never from the tick — bit for bit
the reference's keys (serve/prng.py), so sampled streams are the same under
the prefix cache and preemption. A batch of greedy slots skips the sampler.

Telemetry (`telemetry`): a ServingMetrics registry (Prometheus text, an
HTTP /metrics and /healthz endpoint), a lifecycle TraceRecorder (JSONL) and
tick-phase histograms, all host-side: the flag changes no token and adds no
device sync. The port launches no jit, so `serve_jit_traces_total` stays in
the schema and reports 0.

Fault containment: per-request deadlines; a FaultPlan's injection sites
(serve/faults.py); a per-slot finite-logits flag that rides the drain's one
device -> host copy and quarantines a non-finite slot (its private blocks
scrubbed, reason "numeric_error"); a tick watchdog; health states; an
ownership audit that reclaims leaked block references and pins. A failing
chunk or an injected step fault costs its own request, never the engine.

Left out of this slice (ROADMAP A6, A8, A10): the journal, snapshots and
recovery, the mesh and the dense backend.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.nn.attention import AttnQuant, PagedState
from repro_torch.quant import weights as wq_lib
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import faults as faults_lib
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import prng
from repro_torch.serve import sampling as samp_lib
from repro_torch.serve import telemetry as tel
from repro_torch.serve import trace as trace_lib
from repro_torch.serve.radix_cache import RadixCache
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import RequestState, Scheduler

# Engine health states. HEALTHY serves normally; DEGRADED keeps in-flight
# streams running (watchdog trip, contained untargeted fault) and recovers;
# DRAINING is terminal — no new admissions (begin_draining, close()).
# Exported as the serve_health gauge (0/1/2; the reference's 3, handoff,
# comes with live handoff) and on /healthz (200 only when healthy).
HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
_HEALTH_CODE = {HEALTHY: 0, DEGRADED: 1, DRAINING: 2}
# the reference's jitted engine functions: the port launches none, so each
# reports 0 in serve_jit_traces_total and metrics()["compiles_by_fn"]
_JIT_FNS = ("decode", "prefill", "reset_slot", "prefill_chunk", "cow_copy",
            "scrub_block")


@dataclasses.dataclass
class Request:
    """User-facing request record. `out_tokens` is filled in as the engine
    generates (it aliases the live RequestState token list)."""
    rid: int
    prompt: np.ndarray            # (len,) int
    max_new_tokens: int = 32
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    out_tokens: Optional[List[int]] = None
    deadline_ms: Optional[float] = None   # wall-clock budget from submit();
    # an expired request retires with reason "deadline" at the next tick
    # boundary, releasing blocks and pins as cancel() does


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
    watchdog_ticks: Optional[float] = 8.0   # a drained tick's device wait
    # above watchdog_ticks x the rolling p99 (and the floor) degrades the
    # engine; None disables the watchdog
    watchdog_floor_s: float = 0.25    # absolute minimum trip threshold
    watchdog_recovery: int = 8    # in-threshold ticks after a trip before
    # the engine recovers to HEALTHY
    faults: Optional[Any] = None  # serve/faults.FaultPlan (tests and chaos
    # runs); None keeps every injection site a single None check
    audit_interval: Optional[int] = None  # run audit() every N ticks
    telemetry: bool = True        # metrics registry + lifecycle traces +
    # tick-phase timing, host-side only: streams are the same either way
    trace_capacity: int = 8192    # lifecycle-trace ring-buffer bound
    seed: int = 0                 # base PRNG key of sampled decoding


class _SlotState(NamedTuple):
    """Device-resident per-slot decode state."""
    last_tok: torch.Tensor    # (slots, 1) int64 — token fed to the next decode
    lengths: torch.Tensor     # (slots,) int32 — valid context length
    remaining: torch.Tensor   # (slots,) int32 — decode budget left
    active: torch.Tensor      # (slots,) bool — slot is generating
    sample_seed: torch.Tensor  # (slots,) int64 — per-request PRNG stream id
    sample_step: torch.Tensor  # (slots,) int64 — draws made for the request;
    # keys fold (seed, step), never the tick: sampled streams are the same
    # under any schedule


class _TickRecord(NamedTuple):
    """One enqueued decode tick awaiting host-side delivery."""
    tick: int
    slots: Tuple[int, ...]   # host-believed active slots at enqueue time
    out: torch.Tensor        # (3, slots) int64 on the device: the sampled
    # tokens, the fused EOS/max-token flags and the finite-logits flags, so
    # the drain brings all three to the host in its one copy


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
        # telemetry first, so every component below can publish into it;
        # all of it is host-side bookkeeping
        self._requests: Dict[int, Request] = {}   # live, by rid (the
        # trace's leak check reads it)
        self.telemetry_enabled = bool(ecfg.telemetry)
        if self.telemetry_enabled:
            self.registry: Optional[tel.MetricsRegistry] = \
                tel.MetricsRegistry()
            self._tel: Optional[tel.ServingMetrics] = \
                tel.ServingMetrics(self.registry)
            self.trace = trace_lib.TraceRecorder(ecfg.trace_capacity)
            for fn in _JIT_FNS:
                self._tel.jit_traces.labels(fn=fn)     # 0: no jit here
            # unsharded: every mesh axis is size 1
            self._tel.mesh_devices.set(1.0, axis="data")
            self._tel.mesh_devices.set(1.0, axis="model")
        else:
            self.registry = None
            self._tel = None
            self.trace = trace_lib.NullTraceRecorder()
        self.trace.attach_owner(self)
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
        self._pack_sampler()
        dev = self.device
        i64 = dict(dtype=torch.int64, device=dev)
        self._state = _SlotState(
            last_tok=torch.zeros((ecfg.slots, 1), **i64),
            lengths=torch.zeros(ecfg.slots, dtype=torch.int32, device=dev),
            remaining=torch.zeros(ecfg.slots, dtype=torch.int32, device=dev),
            active=torch.zeros(ecfg.slots, dtype=torch.bool, device=dev),
            sample_seed=torch.zeros(ecfg.slots, **i64),
            sample_step=torch.zeros(ecfg.slots, **i64),
        )
        self._key = prng.prng_key(ecfg.seed, device=dev)
        self._pending: List[_TickRecord] = []
        self._prefilling: List[int] = []     # slots mid-chunked-prefill,
        # admission order; chunk grants rotate round-robin across them
        self._prefill_rr = 0
        if ecfg.preempt_after_ticks < 1:
            raise ValueError("preempt_after_ticks must be >= 1, got "
                             f"{ecfg.preempt_after_ticks}")
        self._prefill_budget = budget
        self.scheduler = Scheduler(ecfg.policy, ecfg.max_prefills_per_tick,
                                   prefill_token_budget=budget,
                                   metrics=self._tel)
        # per delivered token hook (rid, token), called at drain time (host
        # code); None = no-op
        self.token_sink: Optional[Callable[[int, int], None]] = None
        self._metrics_server: Optional[Any] = None
        self.faults: Optional[faults_lib.FaultPlan] = ecfg.faults
        if ecfg.audit_interval is not None and ecfg.audit_interval < 1:
            raise ValueError("audit_interval must be >= 1, got "
                             f"{ecfg.audit_interval}")
        self._audit_interval = ecfg.audit_interval
        self._last_audit_tick = 0
        self._health = HEALTHY
        self.health_reason = ""
        self._has_deadlines = False   # sticky: set by the first deadline
        # submit, so deadline-free serving never scans for expiry
        if ecfg.watchdog_recovery < 1:
            raise ValueError("watchdog_recovery must be >= 1, got "
                             f"{ecfg.watchdog_recovery}")
        # rolling window of per-tick device waits; the watchdog arms once it
        # holds enough samples for a stable p99 and trips on
        # max(floor, watchdog_ticks * p99)
        self._tick_window: deque = deque(maxlen=128)
        self._watchdog_arm = 16
        self._watchdog_ok_streak = 0
        self.stats: Dict[str, Any] = {"ticks": 0, "decode_tokens": 0,
                                      "prefill_tokens": 0, "chunks": 0,
                                      "cached_prefix_tokens": 0}
        self._finished_unpolled: List[RequestState] = []
        wbits = sorted(set(wq_lib.weight_bits_by_layer(
            cfg, self.precision).values()))
        kbits = sorted({b for grp in kvc.kv_bits_by_layer(cfg, self.precision)
                        for b in grp})
        self._static_metrics: Dict[str, Any] = {
            "backend": "paged",
            "telemetry": self.telemetry_enabled,
            "weight_bits": wbits[0] if len(wbits) == 1 else wbits,
            "weights_quantized": self._wq,
            "weight_bytes": wq_lib.packed_param_bytes(self.params),
            "paged_impl": self.paged_impl,
            "device": str(self.device),
            "kv_bits": kbits[0] if len(kbits) == 1 else kbits,
            "kv_quantized": self._kv_quant,
            "decode_buckets": list(self.decode_buckets),
            "total_blocks": self.allocator.num_blocks,
            "prefill_chunk": self.prefill_chunk,
            "prefill_token_budget": budget,
            "prefix_cache": self.radix is not None,
        }
        if self._tel is not None:
            self._tel.pool_blocks_total.set(self.allocator.num_blocks)
            self._tel.health.set(_HEALTH_CODE[self._health])
        self._publish_gauges()

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


    def _pack_sampler(self) -> None:
        """Pack the per-slot SamplingParams (on activation only, never per
        tick): host arrays, their device copies, and whether any slot
        samples (a wholly greedy batch skips the sampler)."""
        self._sp_packed = samp_lib.pack(self._samp)
        self._sp_dev = samp_lib.SamplerBatch(
            *(self._h2d(a) for a in self._sp_packed))
        self._any_sampled = not bool(np.all(self._sp_packed.greedy))

    # --- device steps -----------------------------------------------------

    def _decode_tick(self, width: int) -> torch.Tensor:
        """Fused decode step + sampling + termination, all on the device.
        Inactive slots decode masked garbage (their writes land in the null
        block) and their state is held frozen by `active`. The bucket is a
        column slice of the one table, whose row stride sizes the kernel's
        sequence parts, so a slot's output does not depend on the bucket
        `width`. Returns the (3, slots) record: tokens, done flags and the
        per-slot finite-logits flags (an inactive slot's garbage is exempt;
        its output is dropped at drain anyway)."""
        st = self._state
        paged = PagedState(self._table_dev[:, :width], st.lengths)
        logits, _ = lm.decode_step(self.params, self.cfg, st.last_tok,
                                   self.caches, paged=paged, act=self._act,
                                   paged_impl=self.paged_impl,
                                   attn_quant=self._attn_quant)
        last = logits[:, -1].float()
        if self._any_sampled:
            # per-slot keys from (request stream id, draws so far): a pure
            # function of the request and its progress, not of the tick
            keys = prng.fold_in(prng.fold_in(self._key, st.sample_seed),
                                st.sample_step)
            nxt = samp_lib.sample(last, self._sp_dev, keys)
        else:
            nxt = torch.argmax(last, dim=-1)
        ok = ~st.active | torch.isfinite(last).all(dim=-1)
        act_i = st.active.to(torch.int32)
        remaining = st.remaining - act_i
        done = st.active & ((nxt == self.ecfg.eos_id) | (remaining <= 0))
        self._state = _SlotState(
            last_tok=torch.where(st.active[:, None], nxt[:, None],
                                 st.last_tok),
            lengths=st.lengths + act_i,
            remaining=remaining,
            active=st.active & ~done,
            sample_seed=st.sample_seed,
            sample_step=st.sample_step + 1,
        )
        return torch.stack([nxt, done.long(), ok.long()])

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
        if req.deadline_ms is not None and req.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got "
                             f"{req.deadline_ms}")
        rs = RequestState(rid=req.rid,
                          prompt=np.asarray(req.prompt, np.int32),
                          max_new_tokens=int(req.max_new_tokens),
                          sampling=req.sampling,
                          deadline_ms=req.deadline_ms)
        if req.deadline_ms is not None:
            self._has_deadlines = True
        req.out_tokens = rs.out_tokens          # live alias
        self._requests[req.rid] = req
        self.scheduler.submit(rs, self.stats["ticks"], time.perf_counter())
        self.trace.record(req.rid, "submit", prompt_len=plen,
                          max_new_tokens=int(req.max_new_tokens))
        self.trace.record(req.rid, "queued",
                          queue_depth=len(self.scheduler.waiting))
        return req.rid

    def poll(self) -> List[Request]:
        """Requests finished since the last poll, in completion order.
        Draining happens here: every pending tick's tokens and flags come to
        the host in one copy, and slots/blocks are recycled."""
        self._drain()
        return self.reap()

    def reap(self) -> List[Request]:
        """Deliver already-drained finished requests without forcing a
        drain (poll() is drain() + reap())."""
        out = [self._requests.pop(rs.rid) for rs in self._finished_unpolled]
        self._finished_unpolled = []
        return out

    # --- health and fault containment -------------------------------------

    @property
    def health(self) -> str:
        """Current health state: HEALTHY / DEGRADED / DRAINING."""
        return self._health

    def _set_health(self, state: str, reason: str) -> None:
        if state == self._health:
            return
        self._health = state
        self.health_reason = reason
        # rid -1: an engine-level event, not a request span
        self.trace.record(-1, "health", state=state, reason=reason)
        if self._tel is not None:
            self._tel.health.set(_HEALTH_CODE[state])

    def mark_degraded(self, reason: str) -> None:
        """Degrade the engine (watchdog trip, contained untargeted fault,
        operator action). In-flight work keeps running; /healthz turns 503
        until recovery."""
        if self._health == HEALTHY:
            self._set_health(DEGRADED, reason)

    def mark_healthy(self, reason: str = "recovered") -> None:
        """Explicit recovery from DEGRADED (the watchdog also recovers after
        `watchdog_recovery` in-threshold ticks). DRAINING never recovers."""
        if self._health == DEGRADED:
            self._watchdog_ok_streak = 0
            self._set_health(HEALTHY, reason)

    def begin_draining(self, reason: str = "drain") -> None:
        """Stop admitting new work: slotted requests run to completion,
        waiting requests stay queued. DRAINING is terminal."""
        self._set_health(DRAINING, reason)

    def _fault(self, site: str, rid: Optional[int] = None,
               tick: Optional[int] = None) -> Optional[faults_lib.FaultSpec]:
        """Fire one injection site against the attached FaultPlan (callers
        check `self.faults is not None` first: that check is a site's whole
        cost without a plan)."""
        spec = self.faults.fire(
            site, rid=rid,
            tick=self.stats["ticks"] if tick is None else tick)
        if spec is not None and self._tel is not None:
            self._tel.faults_injected(site=site).inc()
        return spec

    def _retire_anywhere(self, rid: int, reason: str) -> bool:
        """Retire a live request wherever it is — queued, mid-prefill or
        mid-decode — releasing what it holds as cancel() does; the shared
        path of cancel, deadlines and step-level containment. False if the
        rid is not live."""
        now = time.perf_counter()
        tick = self.stats["ticks"]
        for rs in self.scheduler.waiting:
            if rs.rid == rid:
                self.scheduler.waiting.remove(rs)
                self._retire_unslotted(rs, reason, now, tick)
                return True
        for slot, rs in enumerate(self.slot_req):
            if rs is not None and rs.rid == rid:
                if slot in self._prefilling:
                    self._prefilling.remove(slot)
                self._retire(slot, rs, reason, now, tick)
                return True
        return False

    def _enforce_deadlines(self) -> int:
        """Retire every live request whose deadline has expired (reason
        "deadline") at a tick boundary. Pending ticks are drained first, so
        tokens generated before expiry are delivered and a request that
        finished in flight keeps its real reason. Returns retirements."""
        if not self._has_deadlines:
            return 0

        def expired(rs: RequestState, now: float) -> bool:
            return (rs.deadline_ms is not None
                    and (now - rs.submit_time) * 1e3 >= rs.deadline_ms)

        now = time.perf_counter()
        hit = [rs for rs in self.scheduler.waiting if expired(rs, now)]
        hit += [rs for rs in self.slot_req
                if rs is not None and expired(rs, now)]
        if not hit:
            return 0
        self._drain()
        n = 0
        for rs in hit:
            # the drain may have retired it (EOS won the race)
            if rs.finish_tick < 0 and self._retire_anywhere(rs.rid,
                                                            "deadline"):
                n += 1
        return n

    def audit(self) -> Dict[str, Any]:
        """Invariant audit: cross-check allocator refcounts against slot
        reservations and radix pins, reclaim provably leaked references and
        refresh the leak gauge. Drains first, so it is safe on a live
        engine.

        Ownership: a block is owed one reference per live slot listing it
        in `blocks` or `cached_blocks`, plus one if a radix node holds it;
        a node is owed one pin per live slot listing it in `radix_nodes`.
        An excess refcount or pin has no possible owner and is freed or
        clamped; a deficit cannot be fixed safely and is only reported.
        `leaked_after` == 0 is the invariant."""
        if self._tel is not None:
            self._tel.audit_runs.inc()
        self._drain()
        report: Dict[str, Any] = {
            "reclaimed_blocks": 0, "reclaimed_refs": 0,
            "reclaimed_pins": 0, "mismatches": [],
            "leaked_before": 0, "leaked_after": 0,
        }
        alloc = self.allocator
        expected: Counter = Counter()
        pin_owners: Counter = Counter()
        for rs in self.slot_req:
            if rs is None:
                continue
            expected.update(rs.blocks)
            expected.update(rs.cached_blocks)
            for node in rs.radix_nodes:
                pin_owners[id(node)] += 1
        nodes = self.radix.nodes() if self.radix is not None else []
        for node in nodes:
            expected[node.block] += 1
        live = alloc.live_block_ids()
        report["leaked_before"] = sum(1 for b in live if expected[b] == 0)
        # excess pins first: an unpinned node keeps its (cache-owned) block,
        # so pin reclamation never cascades into block reclamation
        for node in nodes:
            owed = pin_owners[id(node)]
            if node.pins > owed:
                report["reclaimed_pins"] += node.pins - owed
                report["mismatches"].append(
                    f"node {node.tokens[:4]}...: pins {node.pins} > "
                    f"owners {owed} (clamped)")
                node.pins = owed
            elif node.pins < owed:
                report["mismatches"].append(
                    f"node {node.tokens[:4]}...: pins {node.pins} < "
                    f"owners {owed} (unfixable deficit)")
        for b in live:
            actual = alloc.refcount(b)
            owed = expected[b]
            if actual > owed:
                excess = actual - owed
                alloc.free([b] * excess)
                report["reclaimed_refs"] += excess
                if owed == 0:
                    report["reclaimed_blocks"] += 1
            elif actual < owed:
                report["mismatches"].append(
                    f"block {b}: refcount {actual} < owners {owed} "
                    "(unfixable deficit)")
        report["leaked_after"] = sum(
            1 for b in alloc.live_block_ids() if expected[b] == 0)
        self._publish_gauges()
        return report

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
        if (self.faults is not None
                and self._fault("alloc_exhausted", rid=rs.rid)):
            # injected pool exhaustion: a structured retirement
            # ("resource_exhausted"), not the requeue-retry a same-tick
            # over-commit gets; nothing was reserved yet
            self.scheduler.revert_admission(rs)
            self._retire_unslotted(rs, "resource_exhausted",
                                   time.perf_counter(), self.stats["ticks"])
            return True
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
        self.trace.record(rs.rid, "admit", slot=slot,
                          cached_prefix_tokens=cached_tokens,
                          suffix_tokens=ctx - cached_tokens,
                          blocks_reserved=total)
        if self._tel is not None:
            self._tel.requests_admitted.inc()
            if cached_tokens:
                self._tel.prefill_cached.inc(cached_tokens)
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
        self._pack_sampler()
        st = self._state
        st.last_tok[slot, 0] = int(rs.prompt[-1])
        st.lengths[slot] = ctx
        st.remaining[slot] = int(rs.max_new_tokens)
        st.active[slot] = True
        st.sample_seed[slot] = int(rs.rid) & 0x7FFFFFFF
        # draws already made for this request: 0 on a fresh admission,
        # len(out_tokens) when resuming after preemption — the stream
        # continues with exactly the keys it would have used
        st.sample_step[slot] = len(rs.out_tokens)
        self.trace.record(rs.rid, "activate", slot=slot, context_tokens=ctx)

    def _run_chunk(self, rs: RequestState) -> None:
        if (self.faults is not None
                and self._fault("chunk_error", rid=rs.rid)):
            # raised before any state moves, so containment in
            # _run_prefill_chunks sees a consistent request
            raise faults_lib.InjectedFault("chunk_error", rs.rid,
                                           self.stats["ticks"])
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
        self.trace.record(rs.rid, "prefill_chunk", p0=p0, tokens=n,
                          kind="computed")
        if self._tel is not None:
            self._tel.prefill_computed.inc(n)
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
        order is invisible in the values. A failing chunk costs its own
        request ("internal_error"), never the engine. Returns the chunks
        run."""
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
                if rs is None or not rs.pending_chunks:
                    # None: retired by chunk containment earlier this pass
                    continue
                try:
                    self._run_chunk(rs)
                except Exception:
                    # chunk containment: _retire frees its blocks and unpins
                    # its published chain; co-prefilling slots keep their
                    # grants
                    self._retire(slot, rs, "internal_error",
                                 time.perf_counter(), self.stats["ticks"])
                    continue
                budget -= C
                ran += 1
                progressed = True
        still: List[int] = []
        for slot in self._prefilling:
            rs = self.slot_req[slot]
            if rs is None:
                continue        # retired by chunk containment this tick
            if not rs.pending_chunks:
                self._activate(slot, rs)
            else:
                still.append(slot)
        self._prefilling = still
        return ran

    def _free_slot(self, slot: int, rs: RequestState,
                   leak_blocks: bool = False, leak_pins: bool = False) -> None:
        """Drop a slotted request's pool holds — its private blocks, its
        references to shared cached blocks (the cache's own reference keeps
        them warm) and its radix pins — and NULL the slot's table row, so
        the ghost-active device slot writes to trash. `leak_blocks` /
        `leak_pins` model a release path that forgets its cleanup (the
        block_leak / radix_pin_leak fault sites): the bookkeeping lists are
        cleared all the same, and audit() must find the leak."""
        self.slot_req[slot] = None
        self._host_len[slot] = 0
        if not leak_blocks:
            self.allocator.free(rs.blocks)
        rs.blocks = []
        if rs.cached_blocks:
            if not leak_pins:
                self.allocator.free(rs.cached_blocks)
            rs.cached_blocks = []
        if rs.radix_nodes:
            if not leak_pins:
                self.radix.unpin(rs.radix_nodes)
            rs.radix_nodes = []
        self._set_table_row(slot, np.full(self._chunk_cols, kvc.NULL_BLOCK,
                                          np.int32))

    def _retire(self, slot: int, rs: RequestState, reason: str,
                now: float, tick: int) -> None:
        self.scheduler.retire(rs, tick, now, reason)
        decode_s = (now - rs.first_token_time
                    if rs.first_token_time is not None else 0.0)
        self.trace.record(rs.rid, "finish", reason=reason,
                          tokens=len(rs.out_tokens), decode_s=decode_s,
                          tpot_s=rs.tpot or 0.0)
        leak_blocks = (self.faults is not None
                       and self._fault("block_leak", rid=rs.rid) is not None)
        leak_pins = (self.faults is not None
                     and self._fault("radix_pin_leak", rid=rs.rid)
                     is not None)
        self._free_slot(slot, rs, leak_blocks, leak_pins)
        self._finished_unpolled.append(rs)

    def _retire_unslotted(self, rs: RequestState, reason: str, now: float,
                          tick: int) -> None:
        """Retire a request that holds no slot and no blocks (still queued,
        or an admission aborted before reserving): close its span; it
        becomes deliverable at the next poll()."""
        self.scheduler.retire(rs, tick, now, reason)
        self.trace.record(rs.rid, "finish", reason=reason,
                          tokens=len(rs.out_tokens), decode_s=0.0,
                          tpot_s=0.0)
        self._finished_unpolled.append(rs)

    # --- preemption -------------------------------------------------------

    def _preempt_slot(self, slot: int) -> None:
        """Evict one decoding slot under KV-pool pressure and requeue its
        request at the queue head (scheduler.preempt). Its generated tokens
        fold into the prompt, so re-admission recomputes the whole context
        through the absolute-grid chunked prefill, and _activate re-arms
        sample_step at len(out_tokens), so a sampled stream continues with
        the keys it would have drawn; prefill-computed full blocks it
        published stay cached (unpinned: evictable headroom, a cheap
        re-match at resume), decode-written blocks are dropped. The device
        slot goes ghost-active (see `_free_slot`)."""
        rs = self.slot_req[slot]
        self.trace.record(rs.rid, "preempt", slot=slot,
                          tokens_generated=len(rs.out_tokens),
                          blocks_freed=len(rs.blocks) + len(rs.cached_blocks))
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
        return self._retire_anywhere(rid, "cancelled")

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
        on the device until the next drain.

        Containment: deadlines are enforced first (tick boundaries are the
        deadline grid), and an InjectedFault escaping the tick body retires
        its target with reason "internal_error" (an untargeted one degrades
        the engine), so a step-level failure costs one request, never the
        process. Other exceptions propagate."""
        if (self.faults is not None
                and self._fault("process_crash") is not None):
            # simulated process death at a tick boundary: escapes every
            # containment layer by design (recovery is not ported yet)
            raise faults_lib.ProcessCrash(self.stats["ticks"])
        if self._has_deadlines:
            self._enforce_deadlines()
        try:
            n = self._step_impl()
        except faults_lib.InjectedFault as e:
            if e.rid is not None and self._retire_anywhere(
                    e.rid, "internal_error"):
                # a retirement is progress: 0 would make run() read one
                # contained tick as a permanently stuck queue head
                return 1
            self.mark_degraded(f"injected:{e.site}")
            return 1
        if (self._audit_interval is not None
                and self.stats["ticks"] - self._last_audit_tick
                >= self._audit_interval):
            self._last_audit_tick = self.stats["ticks"]
            self.audit()
        return n

    def _step_impl(self) -> int:
        # tick-phase timing brackets host code the tick already runs; the
        # device's own time is observed in _drain, at its one host copy
        t = self._tel
        t0 = time.perf_counter() if t is not None else 0.0
        if self.faults is not None:
            spec = self._fault("step_error")
            if spec is not None:
                # fired before any state moves this tick, so containment in
                # step() sees a consistent engine
                raise faults_lib.InjectedFault("step_error", spec.rid,
                                               self.stats["ticks"])
        if self.scheduler.waiting and self._health != DRAINING:
            # admission needs an up-to-date view of free slots (a DRAINING
            # engine admits nothing: queued requests wait)
            self._drain()
            if t is not None:
                t0 = time.perf_counter()   # the drain timed itself
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
        if t is not None:
            t1 = time.perf_counter()
            t.phase_schedule.observe(t1 - t0)
        if not active:
            return 0
        out = self._decode_tick(self._decode_bucket(active))
        self._pending.append(_TickRecord(self.stats["ticks"], tuple(active),
                                         out))
        self._host_len[active] += 1
        self.stats["ticks"] += 1
        if t is not None:
            # dispatch = host cost of enqueueing the tick's kernels
            t.phase_dispatch.observe(time.perf_counter() - t1)
            t.ticks.inc()
        if len(self._pending) >= self.ecfg.max_pending_ticks:
            self._drain()
        return len(active)

    def drain(self, keep: int = 0) -> None:
        """Deliver pending decode ticks to the host, leaving the newest
        `keep` enqueued (keep=1 delivers what the device has finished while
        it computes the tick just dispatched)."""
        self._drain(keep)

    def _drain(self, keep: int = 0) -> None:
        """Deliver every pending decode tick (all but the newest `keep`):
        one device -> host copy of the stacked (tokens, done, finite)
        records. Ticks are replayed in order so retirement lands where a
        per-tick loop would have put it.

        The watchdog sees one time per record: the copy's time is charged
        to the first record (the copy waits for all of them), and an
        injected slow_step sleeps inside the record's own bracket, where a
        slow device step would show."""
        if len(self._pending) <= keep:
            return
        if keep:
            pending = self._pending[:-keep]
            self._pending = self._pending[-keep:]
        else:
            pending, self._pending = self._pending, []
        t = self._tel
        t_start = time.perf_counter()
        arr = torch.stack([r.out for r in pending]).cpu().numpy()
        copy_s = time.perf_counter() - t_start
        sync_s = 0.0          # time blocked on the device (and on injected
        # stalls): the device-step phase, measured at the one host copy
        delivered = 0
        for i, rec in enumerate(pending):
            s0 = time.perf_counter()
            if self.faults is not None:
                spec = self._fault("slow_step", tick=rec.tick)
                if spec is not None:
                    time.sleep(spec.delay_s)
            now = time.perf_counter()
            step_s = (now - s0) + (copy_s if i == 0 else 0.0)
            sync_s += step_s
            self._watchdog(step_s)
            toks, done, oks = arr[i]
            for slot in rec.slots:
                rs = self.slot_req[slot]
                if rs is None:
                    # ghost tick: the slot finished at an earlier (buffered)
                    # tick; its masked decode output is dropped
                    continue
                if (not oks[slot]
                        or (self.faults is not None
                            and self._fault("nan_logits", rid=rs.rid,
                                            tick=rec.tick))):
                    self._quarantine(slot, rs, now, rec.tick)
                    continue
                tok = int(toks[slot])
                rs.out_tokens.append(tok)
                if self.token_sink is not None:
                    try:
                        if (self.faults is not None
                                and self._fault("sink_error", rid=rs.rid,
                                                tick=rec.tick)):
                            raise faults_lib.InjectedFault(
                                "sink_error", rs.rid, rec.tick)
                        self.token_sink(rs.rid, tok)
                    except Exception:
                        # sink containment: a failing consumer costs its own
                        # request, never the engine or its co-batched
                        # streams; the token stays on out_tokens
                        self._retire(slot, rs, "sink_error", now, rec.tick)
                        continue
                if rs.first_token_time is None:
                    rs.first_token_time = now
                    self.trace.record(rs.rid, "first_token",
                                      ttft_s=now - rs.submit_time)
                self.stats["decode_tokens"] += 1
                delivered += 1
                if done[slot]:
                    reason = ("eos" if tok == self.ecfg.eos_id
                              else "max_tokens")
                    self._retire(slot, rs, reason, now, rec.tick)
        if t is not None:
            if delivered:
                t.decode_tokens.inc(delivered)
            t.phase_device_step.observe(sync_s)
            t.phase_drain.observe(
                max(0.0, time.perf_counter() - t_start - sync_s))
            self._publish_gauges()

    def _publish_gauges(self) -> None:
        """Refresh the point-in-time gauges (slot and pool occupancy,
        sharing, refcount leaks, radix size) and mirror the prefix-cache
        lifetime counters into the registry, at drain boundaries (where
        slots and blocks change), never per token."""
        t = self._tel
        if t is None:
            return
        t.slots_active.set(sum(r is not None for r in self.slot_req))
        alloc = self.allocator
        t.pool_blocks_free.set(alloc.free_blocks)
        t.pool_blocks_live.set(alloc.live_blocks)
        t.pool_blocks_shared.set(alloc.shared_blocks)
        # leak detection: every live block must be reachable from a slot's
        # reservation or from a radix node; one nobody accounts for is a
        # reference taken and never released
        reachable = set()
        for rs in self.slot_req:
            if rs is not None:
                reachable.update(rs.blocks)
                reachable.update(rs.cached_blocks)
        if self.radix is not None:
            reachable.update(self.radix.block_ids())
            t.radix_nodes.set(self.radix.num_nodes())
            # the radix cache keeps its own lifetime counts: mirror them
            t.prefix_hits.set(self.radix.hits)
            t.prefix_misses.set(self.radix.misses)
            t.prefix_evictions.set(self.radix.evictions)
        leaked = [b for b in alloc.live_block_ids() if b not in reachable]
        t.pool_blocks_leaked.set(len(leaked))

    def _watchdog(self, step_s: float) -> None:
        """Tick watchdog: one tick's device wait above max(watchdog_floor_s,
        watchdog_ticks x rolling p99) degrades the engine instead of letting
        a hung device wedge it silently; `watchdog_recovery` consecutive
        in-threshold ticks recover it. Breaching samples stay out of the
        window, so a burst of hangs cannot inflate the baseline."""
        mult = self.ecfg.watchdog_ticks
        if mult is None:
            return
        win = self._tick_window
        if len(win) >= self._watchdog_arm:
            thresh = max(self.ecfg.watchdog_floor_s,
                         mult * float(np.percentile(np.asarray(win), 99)))
            if step_s > thresh:
                self._watchdog_ok_streak = 0
                self.mark_degraded("watchdog")
                return
            if self._health == DEGRADED and self.health_reason == "watchdog":
                self._watchdog_ok_streak += 1
                if self._watchdog_ok_streak >= self.ecfg.watchdog_recovery:
                    self.mark_healthy("watchdog_recovered")
        win.append(step_s)

    def _quarantine(self, slot: int, rs: RequestState, now: float,
                    tick: int) -> None:
        """Numeric quarantine: this slot's decode logits went non-finite.
        Only it retires (reason "numeric_error"); co-batched slots go on
        unchanged, since per-slot rows never mix in the decode. Its
        exclusively owned blocks (refcount 1: the ones only its prefill and
        decode wrote) are scrubbed before _retire frees them — recycled
        bytes are still read before masking, and NaN survives a `0 *` mask.
        Shared blocks were read-only for it and stay as they are."""
        for b in rs.blocks:
            if self.allocator.refcount(b) == 1:
                kvc.scrub_pool_block(self.caches, b)
        self._retire(slot, rs, "numeric_error", now, tick)

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

    # --- introspection ------------------------------------------------------

    def metrics(self) -> Dict[str, Any]:
        """Snapshot of the serving metrics, merged over the scheduler's
        lifecycle aggregates: the reference engine's key set (the port has
        no jit, so `compiles` is 0) plus `chunks` and `device`. Cheap and
        side-effect free: no device sync, no walk over requests."""
        m = {**self.scheduler.metrics(), **self.stats,
             **self._static_metrics}
        m["compiles"] = 0
        m["compiles_by_fn"] = {fn: 0 for fn in _JIT_FNS}
        m["health"] = self._health
        m["faults_injected"] = (dict(self.faults.injected)
                                if self.faults is not None else {})
        # the prefix-cache counters are present with the cache off too
        cached = self.stats["cached_prefix_tokens"]
        m["prefix_hit_rate"] = cached / max(
            cached + self.stats["prefill_tokens"], 1)
        m["evictions"] = self.radix.evictions if self.radix else 0
        m["free_blocks"] = self.allocator.free_blocks
        if self.radix is not None:
            m["prefix_cache_nodes"] = self.radix.num_nodes()
            m["prefix_cache_hits"] = self.radix.hits
            m["prefix_cache_misses"] = self.radix.misses
        return m

    def prometheus_text(self) -> str:
        """Prometheus text exposition of the registry (an empty string with
        telemetry off)."""
        if self.registry is None:
            return ""
        self._publish_gauges()      # gauges current as of the scrape
        return self.registry.to_prometheus_text()

    def export_trace(self, path) -> int:
        """Write the lifecycle-trace ring as JSONL (an epoch header, then
        one event per line; schema in serve/trace.py); returns the lines."""
        return self.trace.export_jsonl(path)

    # --- lifecycle ----------------------------------------------------------

    def serve_metrics(self, port: int = 0):
        """Start an HTTP /metrics, /metrics.json and /healthz endpoint on
        127.0.0.1 for this engine and own it: close() stops the socket and
        joins its thread. Returns the server (`server_address[1]` is the
        bound port when 0 was asked for); a second call returns the running
        one."""
        if self.registry is None:
            raise ValueError("serve_metrics() requires telemetry=True")
        if self._metrics_server is None:
            self._metrics_server = tel.start_metrics_server(
                self.registry, port, health_cb=lambda: self._health)
        return self._metrics_server

    def close(self) -> None:
        """Enter DRAINING, deliver pending ticks and stop the owned metrics
        endpoint. Idempotent; the endpoint is stopped even when the final
        drain raises. The engine stays readable (metrics(), export_trace())
        afterwards."""
        try:
            self._set_health(DRAINING, "close")
            self._drain()
        finally:
            server, self._metrics_server = self._metrics_server, None
            if server is not None:
                server.stop()

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
