"""Continuous-batching serving engine: the paged KV pool with chunked prefill
on the absolute grid, the radix prefix cache, preemption and cancel and
decode block buckets, or the dense backend; on-device termination and
deferred drains; tensor-parallel over a serving mesh — the JAX package's
serve/engine.py.

Backends (`paged`: None picks the paged one wherever the arch allows it):
  * paged: block-pool storage with slot -> block-table indirection, the
    CUDA paged-attention kernels; plain GQA/MHA decoders only.
  * dense (SSM, MLA and enc-dec archs, or paged=False): the (slots,
    max_seq) caches of models/lm.init_caches, SSM state and cross-attention
    K/V. Admission runs one prefill of the whole prompt into a fresh (1,
    bucket) cache — bucket-padded (`prefill_buckets`), or at exact length
    when the arch has SSM layers, whose recurrent state would absorb the
    padding — and inserts it as the slot's row; an enc-dec request's
    encoder runs there, once, over its `encoder_frames`. Decode runs over
    the dense caches (attention through the flash kernel only where the
    reference's is a chunked attention: prefill, the encoder and
    cross-attention). The paged-only machinery (blocks, the prefix cache,
    preemption, the audit's block accounting, the pool gauges) is off.

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

Durability (`journal`, serve/journal.py): a write-ahead JSONL ledger of
what clients were promised — each submit before the scheduler sees it,
each token at drain before the token sink, each retirement. `recover()`
replays it into a fresh engine after a crash and resumes every live request
by replay (the prompt's chunked prefill, then the delivered tokens fed back
through decode ticks: the uninterrupted run's kernel calls again, see
_readmit), so every stream finishes with exactly the tokens an
uninterrupted run gives, on the card too. The
record schema is the JAX package's, so either package recovers the other's
journal. `snapshot()` / `restore()` carry the engine config and the live
request records (never the KV pool) through ckpt/checkpoint.py, whose
shard is this port's own format (a torch.save file; the reference writes
msgpack, which the port does not read): a snapshot is read back by the
package that wrote it. `handoff()` moves every live request to another
engine (the same or another configuration) with the journal, passing
through the HANDOFF health state; serve/frontdoor.py drives the engine
from asyncio through the token and retire sinks.

Mesh (`mesh`, launch/mesh.make_serve_mesh): a (data, model) mesh of rank
processes, one engine a rank. The model axis is tensor parallelism: each
rank holds its shard of the weights (heads padded first where they do not
divide the axis, launch/steps.pad_heads_for) and its KV heads of the pools
or dense caches (serve/sharding.py); the model code sums and gathers
across ranks (nn/shard_ctx.py), so every rank computes the same full
logits. The data axis splits the decode slots: data rank d computes its
contiguous range (shard_ctx.data_slots; all of them where the axis does
not divide the slots), and one all-gather a tick brings every rank the
whole (tokens, done, finite) record. On the paged backend every rank keeps
every block of the pool: a rank's forward runs its own slots alone (the
decode kernel planned for every slot, so each slot's attention is the
unsharded launch's bits) and writes their new K/V, and one all-gather of
every layer's new rows lets each rank write every slot's through the same
write (lm.decode_step's write-back), so every data rank's pool holds the
same bytes; a prefill chunk runs replicated on every data rank. The
GEMMs run at S/D rows, which on the card may round apart from the
unsharded engine's S rows. On the dense backend a data rank holds its
slots' rows and prefills only its own slots. An MoE layer in a data
rank's decode gathers its input over the data axis and routes the whole
batch (shard_ctx.split_rows), so its drops are the unsharded engine's.
Every rank thus runs the same scheduler, allocator, radix cache and
sampler on the same host state. The clock is the one rank-local input:
global rank 0 takes the deadline and watchdog decisions and broadcasts
them each tick (one small integer tensor when nothing expires), with the
front door's admissions and cancels since the last tick (an enc-dec
request's frames as bytes beside them), so every rank issues the same
collectives and submits alike. Only global rank 0 writes the journal, the
trace file, the snapshot and the /metrics endpoint, and runs the front
door (the other ranks follow: serve/frontdoor.follow). The CUDA kernels run under the mesh on each
rank's local heads and slots (the reference refuses its Pallas kernel
there: ROADMAP C, D4). Every registered arch is served under a mesh: MoE
by experts, MLA by heads (its latent cache replicated over the model
axis), Mamba-2 by SSM heads, Whisper's encoder and cross-attention by
heads; a config with no attention layer pads and splits no heads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from collections import Counter, deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.nn import shard_ctx
from repro_torch.nn.attention import AttnQuant, KVCache, MLACache, PagedState
from repro_torch.nn.common import tree_flatten
from repro_torch.nn.mamba2 import SSMState
from repro_torch.quant import weights as wq_lib
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import faults as faults_lib
from repro_torch.serve import journal as journal_lib
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import prng
from repro_torch.serve import sampling as samp_lib
from repro_torch.serve import sharding
from repro_torch.serve import telemetry as tel
from repro_torch.serve import trace as trace_lib
from repro_torch.serve.radix_cache import RadixCache
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import RequestState, Scheduler

# Engine health states. HEALTHY serves normally; DEGRADED keeps in-flight
# streams running (watchdog trip, contained untargeted fault) and recovers;
# DRAINING is terminal — no new admissions (begin_draining, close()); HANDOFF
# is the transient state while live requests move to another engine, ending
# in DRAINING. Exported as the serve_health gauge (0/1/2/3) and on /healthz
# (200 only when healthy).
HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
HANDOFF = "handoff"
_HEALTH_CODE = {HEALTHY: 0, DEGRADED: 1, DRAINING: 2, HANDOFF: 3}
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
    encoder_frames: Optional[np.ndarray] = None   # (frames, d_model), enc-dec
    out_tokens: Optional[List[int]] = None
    deadline_ms: Optional[float] = None   # wall-clock budget from submit();
    # an expired request retires with reason "deadline" at the next tick
    # boundary, releasing blocks and pins as cancel() does


@dataclasses.dataclass
class EngineConfig:
    slots: int = 8                # decode batch size
    max_seq: int = 512            # per-slot prompt+generation capacity
    eos_id: int = 1
    paged: Optional[bool] = None  # None = auto (paged where the arch allows)
    page_size: int = 16           # tokens per KV block
    num_blocks: Optional[int] = None   # pool size; None = no oversubscription
    prefill_buckets: Optional[Tuple[int, ...]] = None   # dense backend's
    # prompt buckets; None = power-of-two ladder up to max_seq
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
    journal: Optional[Any] = None  # serve/journal.RequestJournal: the
    # write-ahead ledger of submits, drained tokens and retirements; the
    # engine appends an epoch header at construction, and recover() replays
    # the file after a crash
    audit_interval: Optional[int] = None  # run audit() every N ticks
    telemetry: bool = True        # metrics registry + lifecycle traces +
    # tick-phase timing, host-side only: streams are the same either way
    trace_capacity: int = 8192    # lifecycle-trace ring-buffer bound
    seed: int = 0                 # base PRNG key of sampled decoding


# EngineConfig fields that hold live objects (or a policy built from them)
# and cannot go through a JSON snapshot: snapshot() lists the non-None ones
# under "non_serializable", and restore() takes them back through
# `overrides`
_ECFG_SKIP = ("faults", "journal", "attn_grau", "precision")


def _ecfg_to_dict(ecfg: EngineConfig) -> Tuple[Dict[str, Any], List[str]]:
    """(JSON-safe field dict, names of the skipped non-serializable
    fields)."""
    d: Dict[str, Any] = {}
    skipped: List[str] = []
    for f in dataclasses.fields(EngineConfig):
        v = getattr(ecfg, f.name)
        if f.name in _ECFG_SKIP:
            if v is not None:
                skipped.append(f.name)
            continue
        d[f.name] = list(v) if isinstance(v, tuple) else v
    return d, skipped


def _ecfg_from_dict(d: Dict[str, Any],
                    overrides: Optional[Dict[str, Any]] = None
                    ) -> EngineConfig:
    """EngineConfig from this port's _ecfg_to_dict."""
    kw = dict(d)
    for k in ("prefill_buckets", "decode_buckets"):
        if kw.get(k) is not None:
            kw[k] = tuple(kw[k])
    if overrides:
        kw.update(overrides)
    return EngineConfig(**kw)


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
    forced: Tuple[int, ...] = ()  # slots replaying a delivered token this
    # tick (see _readmit): their output was delivered before, not again


# control messages global rank 0 sends its followers in a mesh sync
# (serve/frontdoor.py): none, the door closed, a handoff
_CONTROL = (None, "close", "handoff")


def _mesh_ranks(mesh) -> int:
    """The ranks an engine spans: its mesh's, or this process alone."""
    if mesh is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, *,
                 dtype: Optional[torch.dtype] = None, device=None,
                 mesh=None):
        """`params` must live on `device` (default: CUDA; see
        lm.resolve_device). `dtype` is the float KV pool dtype (default: the
        activations', lm.compute_dtype). `mesh` (launch/mesh.make_serve_mesh,
        in every rank process with the same arguments and traffic) serves
        the model tensor-parallel: `params` is either the full tree, of
        which this rank keeps its shard (sharding.shard_params), or a
        sharding.Draw, which this rank draws on `device` a piece at a time,
        keeping only its shard (sharding.draw_shard): the launcher's way,
        with which no card or host holds a model too large for it. Either
        way each piece is padded, packed by the engine's precision and
        sliced."""
        self.device = lm.resolve_device(device)
        drawn = isinstance(params, sharding.Draw)
        if drawn and mesh is None:
            raise ValueError("a sharding.Draw is drawn a shard at a time "
                             "under a mesh; without one pass "
                             "lm.init_lm's tree")
        if not drawn and params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.mesh = mesh
        self.rank = mesh_lib.global_rank(mesh)
        self._cache_kw: Dict[str, Any] = {}    # a rank's local shares
        # this data rank's decode slots [lo, hi): all of them without a
        # data axis (or where it does not divide the slots)
        self._dslots = shard_ctx.data_slots(ecfg.slots, mesh)
        draw_cfg = cfg      # a Draw's tree is the unpadded config's
        if mesh is not None:
            # a pure SSM stack has no heads to pad or split
            cfg = sharding.serving_config(cfg, mesh)
            self._cache_kw = sharding.local_caches(
                cfg, shard_ctx.model_size(mesh))
            self._host_group = mesh_lib.host_group(mesh)
        self._dsharded = self._dslots != (0, ecfg.slots)
        # global rank 0 alone writes host outputs (journal, trace file,
        # snapshot, /metrics) and takes the clock's decisions
        self.is_writer = self.rank == 0
        self._leader = False      # global rank 0 under a front door: its
        # submits and cancels ride the next mesh sync (_outbox)
        self._outbox: List[list] = []
        self._outbox_frames: List[bytes] = []   # its submits' frames
        self._control: Optional[str] = None   # a follower's last control
        paged_ok = kvc.paged_supported(cfg)
        self.paged = paged_ok if ecfg.paged is None else bool(ecfg.paged)
        if self.paged and not paged_ok:
            raise ValueError(f"{cfg.name}: paged KV cache unsupported "
                             "(SSM/MLA/enc-dec arch); use paged=False")
        # recurrent SSM state absorbs padding: such archs prefill at exact
        # prompt length, the others in buckets
        self.bucketed = not any(spec.kind == "mamba"
                                for period, _ in cfg.groups
                                for spec in period)
        if ecfg.paged_impl not in (None, "kernel", "gather"):
            raise ValueError(f"unknown paged_impl {ecfg.paged_impl!r}")
        if not self.paged:
            for on, what in ((ecfg.paged_impl is not None, "paged_impl"),
                             (ecfg.attn_grau is not None,
                              "attn_grau epilogue"),
                             (ecfg.prefix_cache, "prefix_cache")):
                if on:
                    raise ValueError(f"{what} requires the paged backend")
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
            # every mesh axis is size 1 without a mesh
            sharding.publish_mesh_metrics(self._tel, mesh)
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
        if self._kv_quant and not self.paged:
            raise ValueError("quantized KV (kv_bits < 16) requires the paged "
                             "backend: dense/SSM/MLA caches stay float")
        # packed once here (int4 evenness validated eagerly); leaves that
        # are already packed are kept as they are
        pack = ((lambda t: wq_lib.pack_params(t, cfg, self.precision))
                if self._wq else None)
        if drawn:
            params = sharding.draw_shard(draw_cfg, mesh, params,
                                         self.device, pack)
        elif mesh is not None:
            # packed leaves are sliced, never re-packed
            params = sharding.shard_params(params, cfg, mesh, pack)
        elif pack is not None:
            params = pack(params)
        self.dtype = dtype or lm.compute_dtype(params)
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        self.paged_impl = ecfg.paged_impl or "kernel"
        self._act = lm.make_act(cfg, self.device)
        self._attn_quant = None
        if ecfg.attn_grau is not None:
            g = ecfg.attn_grau
            self._attn_quant = AttnQuant(spec=g.spec.to(self.device),
                                         s_in=float(g.s_in),
                                         s_out=float(g.s_out))

        budget = None
        if self.paged:
            # paged prefill is chunked: `prefill_buckets` is not read
            budget = self._init_paged(cfg, ecfg)
        else:
            self.allocator = self.radix = None
            # a data rank holds its own slots' rows
            lo, hi = self._dslots
            self.caches = lm.init_caches(cfg, hi - lo, ecfg.max_seq,
                                         dtype=self.dtype, device=self.device,
                                         **self._cache_kw)
            self.decode_buckets = ()
            self.buckets = (tuple(sorted(ecfg.prefill_buckets))
                            if ecfg.prefill_buckets is not None
                            else kvc.default_buckets(ecfg.max_seq,
                                                     multiple=1))
            if self.bucketed and max(self.buckets) < ecfg.max_seq - 1:
                # any admissible context (<= max_seq - 1 tokens) must fit
                raise ValueError(
                    f"largest prefill bucket {max(self.buckets)} does not "
                    f"cover max_seq - 1 = {ecfg.max_seq - 1}")

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
        # front-door hooks, called at drain time (host code): per delivered
        # token (rid, token) and per retirement (rid, reason); None = no-op
        self.token_sink: Optional[Callable[[int, int], None]] = None
        self.retire_sink: Optional[Callable[[int, str], None]] = None
        self._metrics_server: Optional[Any] = None
        self.faults: Optional[faults_lib.FaultPlan] = ecfg.faults
        # the write-ahead journal: appends happen only where the engine runs
        # host code already (submit, drain, retire)
        self.journal = ecfg.journal if self.is_writer else None
        self._owns_journal = False   # recover() builds and owns its writer
        if self.journal is not None:
            # one epoch header per engine attach: replay counts restarts
            self.journal.begin_epoch({"reason": "attach"})
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
        self._static_metrics: Dict[str, Any] = {
            "backend": "paged" if self.paged else "dense",
            "telemetry": self.telemetry_enabled,
            "weight_bits": wbits[0] if len(wbits) == 1 else wbits,
            "weights_quantized": self._wq,
            "weight_bytes": wq_lib.packed_param_bytes(self.params),
            "device": str(self.device),
        }
        if mesh is not None:
            self._static_metrics.update(mesh=sharding.mesh_summary(mesh),
                                        rank=self.rank)
        if self.paged:
            kbits = sorted({b for grp in kvc.kv_bits_by_layer(
                cfg, self.precision) for b in grp})
            self._static_metrics.update({
                "paged_impl": self.paged_impl,
                "kv_bits": kbits[0] if len(kbits) == 1 else kbits,
                "kv_quantized": self._kv_quant,
                "decode_buckets": list(self.decode_buckets),
                "total_blocks": self.allocator.num_blocks,
                "prefill_chunk": self.prefill_chunk,
                "prefill_token_budget": budget,
                "prefix_cache": self.radix is not None,
            })
        if self._tel is not None:
            if self.paged:
                self._tel.pool_blocks_total.set(self.allocator.num_blocks)
            self._tel.health.set(_HEALTH_CODE[self._health])
        self._publish_gauges()

    def _init_paged(self, cfg: ModelConfig, ecfg: EngineConfig) -> int:
        """The paged backend's pool, allocator, prefix cache, chunk grid,
        block table and decode buckets; returns the prefill token
        budget."""
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
                                            policy=self.precision,
                                            kv_heads=self._cache_kw.get(
                                                "kv_heads"))
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
        return budget

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
        lo, hi = self._dslots
        self._sp_dev = samp_lib.SamplerBatch(
            *(self._h2d(a[lo:hi]) for a in self._sp_packed))
        self._any_sampled = not bool(np.all(self._sp_packed.greedy))

    # --- device steps -----------------------------------------------------

    def _sharded(self):
        """The mesh context of this engine's forwards (none without a
        mesh): the paged kernels plan for the unsharded KV heads and
        slots."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return shard_ctx.use(self.mesh, self.cfg.kv_heads_phys,
                             plan_batch=self.ecfg.slots)

    def _local_slot(self, slot: int) -> Optional[int]:
        """`slot`'s row in this rank's dense caches (None: another data
        rank holds it)."""
        lo, hi = self._dslots
        return slot - lo if lo <= slot < hi else None

    def _decode_tick(self, width: Optional[int],
                     force: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fused decode step + sampling + termination, all on the device.
        Inactive slots decode masked garbage (their writes land in the null
        block, or in their own dense rows past every live position) and
        their state is held frozen by `active`. On the paged backend the
        bucket is a column slice of the one table, whose row stride sizes
        the kernel's sequence parts, so a slot's output does not depend on
        the bucket `width` (None on the dense backend). `force` (slots,)
        holds, for a slot replaying its delivered tokens, the token to
        output and feed next (-1 elsewhere): its sampled token is dropped
        and cannot end it. Returns the (3, slots)
        record: tokens, done flags and the per-slot finite-logits flags (an
        inactive slot's garbage is exempt; its output is dropped at drain
        anyway).

        A data rank computes its range of the slots (their tokens, lengths,
        table rows and sampler state) and the record is all-gathered over
        the data axis, so every rank advances the whole slot state alike.
        On the paged backend the write-back then gives its pools every
        slot's new K/V (lm.decode_step)."""
        st = self._state
        sl = slice(*self._dslots)
        paged = write_back = None
        if self.paged:
            # rows of the whole table: its row stride sizes the kernel's
            # sequence parts (kernels/paged_attention.decode_plan)
            paged = PagedState(self._table_dev[sl, :width], st.lengths[sl])
            if self._dsharded:
                write_back = PagedState(self._table_dev[:, :width],
                                        st.lengths)
        with self._sharded(), shard_ctx.split_rows(self._dsharded):
            logits, _ = lm.decode_step(self.params, self.cfg,
                                       st.last_tok[sl], self.caches,
                                       paged=paged, act=self._act,
                                       paged_impl=self.paged_impl,
                                       attn_quant=self._attn_quant,
                                       write_back=write_back)
        last = logits[:, -1].float()
        if self._any_sampled:
            # per-slot keys from (request stream id, draws so far): a pure
            # function of the request and its progress, not of the tick
            keys = prng.fold_in(prng.fold_in(self._key, st.sample_seed[sl]),
                                st.sample_step[sl])
            nxt = samp_lib.sample(last, self._sp_dev, keys)
        else:
            nxt = torch.argmax(last, dim=-1)
        live = st.active[sl]
        ok = ~live | torch.isfinite(last).all(dim=-1)
        eos = nxt == self.ecfg.eos_id
        if force is not None:
            forced = force[sl] >= 0
            nxt = torch.where(forced, force[sl], nxt)
            eos &= ~forced
        done = live & (eos | (st.remaining[sl] - live.to(torch.int32) <= 0))
        record = torch.stack([nxt, done.long(), ok.long()])
        if self._dsharded:
            with self._sharded():
                record = shard_ctx.gather_data(record, dim=1)
            nxt, done = record[0], record[1].bool()
        act_i = st.active.to(torch.int32)
        remaining = st.remaining - act_i
        self._state = _SlotState(
            last_tok=torch.where(st.active[:, None], nxt[:, None],
                                 st.last_tok),
            lengths=st.lengths + act_i,
            remaining=remaining,
            active=st.active & ~done,
            sample_seed=st.sample_seed,
            sample_step=st.sample_step + 1,
        )
        return record

    def _chunk(self, toks: np.ndarray, row: np.ndarray, p0: int,
               ctx: int) -> None:
        """One chunk of the chunked-prefill state machine: tokens (1, C) at
        absolute positions p0..p0+C-1, written through the slot's (bucket-
        sliced) table row and attending the already-resident prefix. `ctx`
        (the prompt's real context) keeps chunk padding out of a quantized
        block's exponent."""
        st = PagedState(self._h2d(row), self._h2d(np.array([p0], np.int32)),
                        self._h2d(np.array([ctx], np.int32)))
        with self._sharded():
            lm.prefill_step(self.params, self.cfg, self._h2d(toks),
                            self.caches, paged=st, act=self._act,
                            paged_impl=self.paged_impl,
                            attn_quant=self._attn_quant, want_logits=False)

    def _prefill_dense(self, toks: np.ndarray, true_len: int, slot: int,
                       frames: Optional[np.ndarray]) -> None:
        """One admitted prompt on the dense backend: prefill_step on a
        fresh (1, len) cache, then the filled cache inserted as the slot's
        row of every leaf (positions past it keep stale values, masked by
        the lengths). Under a data axis only the slot's data rank runs it
        (its model group's collectives stay among its own ranks)."""
        row = self._local_slot(slot)
        if row is None:
            return
        small = lm.init_caches(self.cfg, 1, toks.shape[1], dtype=self.dtype,
                               device=self.device, **self._cache_kw)
        with self._sharded():
            lm.prefill_step(
                self.params, self.cfg, self._h2d(toks), small,
                true_length=self._h2d(np.array([true_len], np.int32)),
                act=self._act, want_logits=False,
                encoder_frames=(None if frames is None else
                                self._h2d(frames[None].astype(np.float32))))
        for (_, big), (_, new) in zip(tree_flatten(self.caches),
                                      tree_flatten(small)):
            big[(slice(None), row) + tuple(
                slice(0, n) for n in new.shape[2:])].copy_(new[:, 0])

    def _reset_slot(self, slot: int) -> None:
        """Zero one slot's recurrent state and cache lengths (an empty
        context on the exact-length SSM path) on its data rank."""
        row = self._local_slot(slot)
        if row is None:
            return
        for c in lm.dense_leaves(self.caches):
            if isinstance(c, (KVCache, MLACache)):
                c.length[:, row] = 0
            elif isinstance(c, SSMState):
                c.conv[:, row] = 0
                c.ssm[:, row] = 0

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
        if self.paged and (kvc.blocks_for(plen + req.max_new_tokens,
                                          self.ecfg.page_size)
                           > self.allocator.num_blocks - 1):
            raise ValueError("request exceeds total KV pool capacity")
        if self.cfg.encoder is not None and req.encoder_frames is None:
            raise ValueError("enc-dec arch requires encoder_frames")
        if req.rid in self._requests:
            raise ValueError(f"duplicate rid {req.rid}")
        if req.deadline_ms is not None and req.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got "
                             f"{req.deadline_ms}")
        rs = RequestState(rid=req.rid,
                          prompt=np.asarray(req.prompt, np.int32),
                          max_new_tokens=int(req.max_new_tokens),
                          sampling=req.sampling,
                          encoder_frames=req.encoder_frames,
                          deadline_ms=req.deadline_ms)
        if req.deadline_ms is not None:
            self._has_deadlines = True
        req.out_tokens = rs.out_tokens          # live alias
        self._requests[req.rid] = req
        if self.journal is not None:
            # write-ahead: the submission is recorded before the engine acts
            # on it, so a crash after this line recovers the request
            self.journal.record_submit(
                req.rid, rs.prompt, rs.max_new_tokens,
                sampling={"temperature": req.sampling.temperature,
                          "top_k": req.sampling.top_k,
                          "top_p": req.sampling.top_p},
                deadline_ms=req.deadline_ms)
        self.scheduler.submit(rs, self.stats["ticks"], time.perf_counter())
        if self._leader:
            # the other ranks submit it at the next mesh sync; an enc-dec
            # request's frames ride it as bytes (shape and dtype here)
            sp = req.sampling
            frames = None
            if req.encoder_frames is not None:
                a = np.ascontiguousarray(req.encoder_frames)
                frames = [list(a.shape), a.dtype.str]
                self._outbox_frames.append(a.tobytes())
            self._outbox.append(["submit", int(req.rid), rs.prompt.tolist(),
                                 rs.max_new_tokens,
                                 [sp.temperature, sp.top_k, sp.top_p],
                                 req.deadline_ms, frames])
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
        """Current health state: HEALTHY / DEGRADED / DRAINING / HANDOFF."""
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
        waiting requests stay queued (for a final snapshot). DRAINING is
        terminal: the launcher's signal path and a handoff's source end
        there."""
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

    def _live_states(self) -> List[RequestState]:
        """Every live request, queued then slotted: the same list on every
        rank of a mesh (the host schedule is the same)."""
        return (list(self.scheduler.waiting)
                + [rs for rs in self.slot_req if rs is not None])

    def _expired(self) -> List[bool]:
        """Per _live_states entry: its deadline has passed (this process's
        clock)."""
        now = time.perf_counter()
        return [rs.deadline_ms is not None
                and (now - rs.submit_time) * 1e3 >= rs.deadline_ms
                for rs in self._live_states()]

    def _mesh_sync(self, control: Optional[str] = None
                   ) -> List[RequestState]:
        """Global rank 0's decisions, broadcast to every rank over the
        mesh's gloo host group: one int64 header (its health — the watchdog
        runs on rank 0 alone —, the bytes that follow and a `control`
        message, _CONTROL), then, only when there is any, a JSON payload:
        the rids whose deadlines have expired by rank 0's clock and the
        front door's submits and cancels since the last sync (_outbox),
        which every other rank applies here, in order, before it schedules,
        and, in a second broadcast, the submitted enc-dec requests' frame
        bytes. So no host branch depends on a rank's own clock and every
        rank's host state stays the same. A follower keeps the control in
        `_control`. Returns the expired requests."""
        import torch.distributed as dist
        header = torch.zeros(4, dtype=torch.int64)
        blob = frames = b""
        if self.rank == 0:
            expired = []
            if control is None and self._has_deadlines:
                expired = [rs.rid for rs, f in zip(self._live_states(),
                                                   self._expired()) if f]
            if expired or self._outbox:
                blob = json.dumps({"expired": expired,
                                   "ops": self._outbox}).encode()
            frames = b"".join(self._outbox_frames)
            self._outbox, self._outbox_frames = [], []
            header[0] = _HEALTH_CODE[self._health]
            header[1] = len(blob)
            header[2] = _CONTROL.index(control)
            header[3] = len(frames)
        dist.broadcast(header, src=0, group=self._host_group)

        def bytes_of(data: bytes, n: int) -> bytes:
            buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
                   if self.rank == 0 else torch.empty(n, dtype=torch.uint8))
            dist.broadcast(buf, src=0, group=self._host_group)
            return buf.numpy().tobytes()
        msg = {"expired": [], "ops": []}
        if int(header[1]):
            msg = json.loads(bytes_of(blob, int(header[1])).decode())
        if int(header[3]):
            frames = bytes_of(frames, int(header[3]))
        if self.rank != 0:
            state = {v: k for k, v in _HEALTH_CODE.items()}[int(header[0])]
            self._set_health(state, "rank 0")
            at = 0
            for op in msg["ops"]:
                at = self._apply_op(op, frames, at)
            self._control = _CONTROL[int(header[2])]
        expired = set(msg["expired"])
        return [rs for rs in self._live_states() if rs.rid in expired]

    def _apply_op(self, op: list, frames: bytes, at: int) -> int:
        """A follower replays one of global rank 0's front-door calls; a
        submit's encoder frames are read from `frames` at byte `at`.
        Returns the offset past them."""
        if op[0] == "cancel":
            self.cancel(int(op[1]))
            return at
        _, rid, prompt, max_new, (temp, top_k, top_p), deadline_ms, fr = op
        enc = None
        if fr is not None:
            shape, dtype = fr
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            enc = np.frombuffer(frames, dtype=dtype, count=int(np.prod(
                shape)), offset=at).reshape(shape).copy()
            at += n
        self.submit(Request(rid=int(rid), prompt=np.asarray(prompt, np.int32),
                            max_new_tokens=int(max_new),
                            sampling=SamplingParams(temperature=temp,
                                                    top_k=top_k, top_p=top_p),
                            encoder_frames=enc, deadline_ms=deadline_ms))
        return at

    def send_control(self, control: str) -> None:
        """Global rank 0 under a front door: a mesh sync that carries
        `control` ("close", "handoff") and the submits and cancels not yet
        sent; each follower's pending step() returns at it with the control
        in `_control` (serve/frontdoor.follow)."""
        assert self.rank == 0 and self.mesh is not None
        self._mesh_sync(control)

    def _enforce_deadlines(self, hit: Optional[List[RequestState]] = None
                           ) -> int:
        """Retire every live request whose deadline has expired (reason
        "deadline") at a tick boundary: `hit`, rank 0's decision under a
        mesh, else this process's clock. Pending ticks are drained first, so
        tokens generated before expiry are delivered and a request that
        finished in flight keeps its real reason. Returns retirements."""
        if hit is None:
            if not self._has_deadlines:
                return 0
            hit = [rs for rs, f in zip(self._live_states(), self._expired())
                   if f]
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
        if not self.paged:
            return report
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
        if not self.paged:
            return True
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
        if not self.paged:
            self._admit_dense(slot, rs, ctx)
            return True
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

    def _admit_dense(self, slot: int, rs: RequestState, ctx: int) -> None:
        """Dense backend: one prefill of the whole context at admission
        (bucketed, or at exact length for recurrent SSM state), then
        activation at once."""
        if self.bucketed:
            toks = np.zeros((1, kvc.bucket_for(max(ctx, 1), self.buckets)),
                            np.int32)
            toks[0, :ctx] = rs.prompt[:ctx]
            self._prefill_dense(toks, ctx, slot, rs.encoder_frames)
        elif ctx == 0:
            self._reset_slot(slot)
        else:
            # exact length: padding would corrupt the recurrent SSM state
            self._prefill_dense(rs.prompt[None, :ctx].astype(np.int32), ctx,
                                slot, None)
        self.stats["prefill_tokens"] += ctx
        rs.computed_prefill_tokens = ctx
        rs.prefill_pos = rs.prefill_ctx = ctx
        rs.slot = slot
        self.slot_req[slot] = rs
        self.trace.record(rs.rid, "admit", slot=slot,
                          cached_prefix_tokens=0, suffix_tokens=ctx,
                          blocks_reserved=0)
        if self._tel is not None:
            self._tel.requests_admitted.inc()
            self._tel.prefill_computed.inc(ctx)
        self._activate(slot, rs)

    def _activate(self, slot: int, rs: RequestState) -> None:
        """Prefill complete: make the slot decode-visible (install its table
        row, arm the device slot state — also a ghost-active slot's, left by
        a preemption, cancel or undrained finish)."""
        ctx = rs.prefill_ctx
        if self.paged:
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
        # draws already made for this request: 0 on a fresh admission or a
        # replaying readmission (its replayed ticks take steps 0..k-1),
        # len(out_tokens) when resuming after preemption — the stream
        # continues with exactly the keys it would have used
        st.sample_step[slot] = len(rs.out_tokens) - rs.replay
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
        if not self.paged:
            return
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
        # the leak sites model a paged release path that forgets its cleanup
        leak_blocks = (self.paged and self.faults is not None
                       and self._fault("block_leak", rid=rs.rid) is not None)
        leak_pins = (self.paged and self.faults is not None
                     and self._fault("radix_pin_leak", rid=rs.rid)
                     is not None)
        self._free_slot(slot, rs, leak_blocks, leak_pins)
        if self.journal is not None:
            self.journal.record_retire(rs.rid, reason)
        self._finished_unpolled.append(rs)
        if self.retire_sink is not None:
            self.retire_sink(rs.rid, reason)

    def _retire_unslotted(self, rs: RequestState, reason: str, now: float,
                          tick: int) -> None:
        """Retire a request that holds no slot and no blocks (still queued,
        or an admission aborted before reserving): close its span; it
        becomes deliverable at the next poll()."""
        self.scheduler.retire(rs, tick, now, reason)
        self.trace.record(rs.rid, "finish", reason=reason,
                          tokens=len(rs.out_tokens), decode_s=0.0,
                          tpot_s=0.0)
        if self.journal is not None:
            self.journal.record_retire(rs.rid, reason)
        self._finished_unpolled.append(rs)
        if self.retire_sink is not None:
            self.retire_sink(rs.rid, reason)

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
            rs.replay = 0           # a replay cut short: folded instead
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
        if self._leader:
            self._outbox.append(["cancel", int(rid)])
        self._drain()
        return self._retire_anywhere(rid, "cancelled")

    # --- durability: snapshot / restore / recovery / handoff ---------------

    def _live_records(self) -> List[dict]:
        """Every live request (waiting or slotted, mid-prefill included) as
        a durable record (RequestState.to_record: the original submission
        and the delivered stream, folds undone), in arrival order: what
        snapshot() writes and handoff() moves."""
        recs = [rs.to_record() for rs in self.scheduler.waiting]
        recs += [rs.to_record() for rs in self.slot_req if rs is not None]
        recs.sort(key=lambda r: r["arrival_seq"])
        return recs

    def _validate_readmit(self, records: List[dict],
                          encoder_frames=None) -> None:
        """Check that every record could be admitted on this engine without
        touching any state: no live rid (nor a duplicate within the batch),
        and prompt + original budget within max_seq. handoff() runs it on
        the target before the source releases anything, so a refused
        handoff leaves the source serving."""
        seen = set()
        for rec in records:
            rid = int(rec["rid"])
            if rid in self._requests or rid in seen:
                raise ValueError(f"readmit of live rid {rid}")
            seen.add(rid)
            if self.cfg.encoder is not None and (
                    encoder_frames is None or rid not in encoder_frames):
                raise ValueError(f"rid {rid}: an enc-dec readmission needs "
                                 "its encoder_frames (records carry none)")
            plen = len(rec["prompt"])
            budget = int(rec["max_new_tokens"])
            if plen + budget > self.ecfg.max_seq:
                raise ValueError(
                    f"rid {rid}: prompt ({plen}) + max_new_tokens "
                    f"({budget}) exceeds this engine's max_seq "
                    f"({self.ecfg.max_seq})")

    def _readmit(self, records: List[dict],
                 journal_known_rids=frozenset(),
                 encoder_frames=None) -> int:
        """Re-admit durable request records through the normal queue: each
        becomes a waiting RequestState with its original prompt and budget
        and its delivered tokens on out_tokens, to be replayed: after the
        prompt's chunked prefill, the first decode ticks feed the delivered
        tokens back one a tick (their sampled outputs dropped, sample_step
        from 0), and new tokens follow. The replay makes the uninterrupted
        run's kernel calls again — prefill chunks on the same grid, decode
        ticks of the same shape, whose rows do not depend on the other
        slots — so a resumed stream is the uninterrupted one's bits on the
        card too. (The reference folds the delivered tokens into the
        prompt, as preemption does here, and recomputes them by prefill:
        the same tokens on the CPU, but on the card a 32-row prefill chunk
        and an 8-row decode tick round bf16 sums apart, and a resumed
        stream can leave the uninterrupted one.) Replay costs one decode
        tick a delivered token, batched with the other slots; the fold, a
        chunk per 32.

        Records whose rid is not in `journal_known_rids` are written to the
        attached journal (submit, then every delivered token), so a fresh
        journal is a whole ledger; rids the journal already holds live
        (recovery reopens the same file, a handoff moves it) are not
        written again — a second submit for a live rid is corruption.

        A record whose budget is spent or whose last delivered token is EOS
        lost its retire record with the journal's tail: it retires at once
        (repairing the journal). A deadline carries over as the residual
        budget (deadline_ms less deadline_elapsed_ms); one already spent
        retires with reason "deadline". An enc-dec model's records carry no
        frames (a journal does not hold them): `encoder_frames` maps each
        rid to its (frames, d_model) array. Returns the records
        processed."""
        self._validate_readmit(records, encoder_frames)
        now = time.perf_counter()
        tick = self.stats["ticks"]
        n = 0
        for rec in sorted(records, key=lambda r: r.get("arrival_seq", 0)):
            rid = int(rec["rid"])
            prompt = np.asarray(rec["prompt"], np.int32)
            budget = int(rec["max_new_tokens"])
            delivered = [int(t) for t in rec.get("delivered") or ()]
            sd = rec.get("sampling") or {}
            sp = SamplingParams(
                temperature=float(sd.get("temperature", 0.0)),
                top_k=int(sd.get("top_k", 0)),
                top_p=float(sd.get("top_p", 1.0)))
            deadline_ms = rec.get("deadline_ms")
            elapsed_ms = rec.get("deadline_elapsed_ms")
            if deadline_ms is not None and elapsed_ms:
                # time spent before the snapshot, handoff or crash (downtime
                # included) stays charged
                deadline_ms = float(deadline_ms) - float(elapsed_ms)
            if self.journal is not None and rid not in journal_known_rids:
                self.journal.record_submit(rid, prompt, budget,
                                           sampling=dict(sd) or None,
                                           deadline_ms=deadline_ms)
                for tok in delivered:
                    self.journal.record_token(rid, tok)
            frames = (None if encoder_frames is None
                      else encoder_frames.get(rid))
            rs = RequestState(rid=rid, prompt=prompt,
                              max_new_tokens=budget, sampling=sp,
                              encoder_frames=frames, deadline_ms=deadline_ms)
            rs.out_tokens.extend(delivered)
            rs.replay = len(delivered)
            remaining = budget - len(delivered)
            req = Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                          sampling=sp, encoder_frames=frames,
                          deadline_ms=deadline_ms)
            req.out_tokens = rs.out_tokens          # live alias
            if deadline_ms is not None:
                self._has_deadlines = True
            self._requests[rid] = req
            self.scheduler.submit(rs, tick, now)
            self.trace.record(rid, "submit", prompt_len=len(prompt),
                              max_new_tokens=budget)
            self.trace.record(rid, "restore",
                              delivered_tokens=len(delivered))
            if self._tel is not None:
                self._tel.restored_requests.inc()
            n += 1
            if remaining <= 0 or (delivered
                                  and delivered[-1] == self.ecfg.eos_id):
                # its retirement was lost with the journal's tail
                reason = ("eos" if delivered
                          and delivered[-1] == self.ecfg.eos_id
                          else "max_tokens")
                self.scheduler.waiting.remove(rs)
                self._retire_unslotted(rs, reason, now, tick)
                continue
            if deadline_ms is not None and deadline_ms <= 0:
                # the residual ran out while the request was down or in
                # transit: the reason _enforce_deadlines would give, without
                # a prefill first
                self.scheduler.waiting.remove(rs)
                self._retire_unslotted(rs, "deadline", now, tick)
                continue
            self.trace.record(rid, "queued",
                              queue_depth=len(self.scheduler.waiting))
        return n

    def snapshot(self, ckpt_dir, step: Optional[int] = None,
                 keep: int = 3):
        """Write a snapshot through ckpt/checkpoint.py (a staged directory
        committed by its MANIFEST.json): the EngineConfig, every live
        request record and the radix cache's pin summary, as a JSON payload
        stored in a uint8 tensor. The KV pool is not written: restore
        re-admits every request through chunked prefill, which recomputes
        it. Returns the committed checkpoint path; `step` defaults to the
        engine tick. Under a mesh every rank calls it: global rank 0 writes
        the payload it writes without one (every rank holds the same
        records), the others wait for it and return the same path."""
        self._drain()
        path = (self._write_snapshot(ckpt_dir, step, keep)
                if self.is_writer else None)
        if self.mesh is not None:
            path = mesh_lib.host_broadcast(self.mesh, path)
        return path

    def _write_snapshot(self, ckpt_dir, step: Optional[int], keep: int):
        from repro_torch.ckpt import checkpoint as ckpt
        if self.journal is not None:
            self.journal.sync()
        records = self._live_records()
        ecfg_dict, skipped = _ecfg_to_dict(self.ecfg)
        payload = {
            "format": 1,
            "tick": self.stats["ticks"],
            "engine_config": ecfg_dict,
            "non_serializable": skipped,
            "requests": records,
            "radix": (self.radix.pin_summary()
                      if self.radix is not None else None),
        }
        blob = torch.frombuffer(bytearray(json.dumps(payload).encode()),
                                dtype=torch.uint8)
        path = ckpt.save(ckpt_dir,
                         self.stats["ticks"] if step is None else int(step),
                         {"snapshot": blob}, keep=keep,
                         extra={"kind": "serve_snapshot",
                                "tick": self.stats["ticks"],
                                "live_requests": len(records)})
        if self._tel is not None:
            self._tel.snapshots.inc()
        return path

    @staticmethod
    def _load_snapshot(ckpt_dir, step: Optional[int]) -> dict:
        from repro_torch.ckpt import checkpoint as ckpt
        if step is None:
            step = ckpt.latest_step(ckpt_dir)
            if step is None:
                raise ValueError(f"no committed snapshot under {ckpt_dir}")
        blob = ckpt.load_flat(ckpt_dir, int(step))["snapshot"]
        return json.loads(blob.numpy().tobytes().decode())

    @classmethod
    def _rank0_snapshot(cls, mesh, ckpt_dir, step: Optional[int]) -> dict:
        """The snapshot payload, read by global rank 0 and broadcast under
        a mesh."""
        if mesh is None:
            return cls._load_snapshot(ckpt_dir, step)
        rank0 = mesh_lib.global_rank(mesh) == 0
        return mesh_lib.host_broadcast(
            mesh, cls._load_snapshot(ckpt_dir, step) if rank0 else None)

    @classmethod
    def restore(cls, cfg: ModelConfig, params, ckpt_dir, *,
                step: Optional[int] = None,
                dtype: Optional[torch.dtype] = None, device=None,
                overrides: Optional[Dict[str, Any]] = None,
                journal=None, encoder_frames=None,
                mesh=None) -> "ServeEngine":
        """A fresh engine from a snapshot() checkpoint, with every captured
        request re-admitted. `overrides` patches EngineConfig fields (among
        them the non-serializable ones the snapshot could not carry: a
        GRAU-epilogue engine restores with {"attn_grau": ...}); `journal`
        attaches a write-ahead journal; `encoder_frames` ({rid: frames})
        supplies an enc-dec model's frames. The seed round-trips as a plain
        field, so sampled streams resume on the same keys. Under a `mesh`
        every rank calls it: global rank 0 reads the payload and broadcasts
        it, and only its engine keeps `journal`."""
        payload = cls._rank0_snapshot(mesh, ckpt_dir, step)
        ecfg = _ecfg_from_dict(payload["engine_config"], overrides)
        if journal is not None:
            ecfg = dataclasses.replace(ecfg, journal=journal)
        eng = cls(cfg, params, ecfg, dtype=dtype, device=device, mesh=mesh)
        known = frozenset()
        if eng.journal is not None:
            # resuming onto an existing journal: rids already live in it
            # are not journaled again
            known = frozenset(journal_lib.replay(journal.path).live.keys())
        eng._readmit(payload["requests"], journal_known_rids=known,
                     encoder_frames=encoder_frames)
        return eng

    @classmethod
    def recover(cls, cfg: ModelConfig, params, journal_path, *,
                ecfg: Optional[EngineConfig] = None, snapshot_dir=None,
                snapshot_step: Optional[int] = None,
                dtype: Optional[torch.dtype] = None, device=None,
                overrides: Optional[Dict[str, Any]] = None,
                fsync_every: int = 16,
                encoder_frames=None, mesh=None) -> "ServeEngine":
        """Crash recovery: replay the journal, build a fresh engine and
        resume every request that was live at the kill, each with exactly
        its undelivered suffix (only drain-delivered tokens were journaled;
        the replay recomputes the rest).

        The config comes from `ecfg` or from a snapshot under
        `snapshot_dir`; either must keep the killed engine's seed. The same
        file is reopened for appending under a new epoch header, so one
        journal spans every crash / recover cycle and replay stays
        idempotent. The recovered engine owns the writer (close() closes
        it). An enc-dec model needs `encoder_frames` ({rid: frames}): the
        journal does not hold them. Under a `mesh` every rank replays the
        journal and global rank 0 alone reopens it for appending; the
        deadlines' elapsed time is rank 0's clock."""
        state = journal_lib.replay(journal_path)
        if ecfg is None:
            if snapshot_dir is None:
                raise ValueError("recover() needs ecfg or snapshot_dir "
                                 "for the engine config")
            payload = cls._rank0_snapshot(mesh, snapshot_dir, snapshot_step)
            ecfg = _ecfg_from_dict(payload["engine_config"], overrides)
        jr = None
        if mesh_lib.global_rank(mesh) == 0:
            jr = journal_lib.RequestJournal(journal_path,
                                            fsync_every=fsync_every)
        eng = cls(cfg, params, dataclasses.replace(ecfg, journal=jr),
                  dtype=dtype, device=device, mesh=mesh)
        eng._owns_journal = jr is not None
        now_wall = time.time()
        if mesh is not None:
            now_wall = mesh_lib.host_broadcast(mesh, now_wall)
        records = [{"rid": lr.rid, "prompt": lr.prompt,
                    "max_new_tokens": lr.max_new_tokens,
                    "sampling": lr.sampling, "deadline_ms": lr.deadline_ms,
                    # wall time since the journaled submit: the deadline
                    # keeps running through the outage
                    "deadline_elapsed_ms": (
                        max(0.0, (now_wall - lr.submit_wall_time_s) * 1e3)
                        if (lr.deadline_ms is not None
                            and lr.submit_wall_time_s is not None)
                        else None),
                    "delivered": lr.delivered, "arrival_seq": i}
                   for i, lr in enumerate(state.live.values())]
        eng._readmit(records,
                     journal_known_rids=frozenset(state.live.keys()),
                     encoder_frames=encoder_frames)
        return eng

    def handoff(self, target: "ServeEngine") -> Dict[str, Any]:
        """Live handoff: drain, take every live request, release this
        engine's pool holds and re-admit the requests on `target`, which
        may run another configuration (kv_bits, weight_bits, slots, pool
        size). Streams go on under the same rids, by replay (_readmit) —
        hence eos_id and seed must match (the seed is folded into every
        sampling key). Every record is validated on the target before this
        engine releases anything, so a refused handoff raises with the
        source untouched and serving.

        The source passes through HANDOFF (the gauge's 3; /healthz answers
        503) and ends DRAINING. If it holds the journal and the target has
        none, the journal moves with the requests under a handoff epoch.

        Under a mesh every rank calls it in lockstep on its own source and
        target, which may run another mesh shape over the same ranks
        ((2, 1) -> (1, 2)); the journal moves on global rank 0. An engine
        without a mesh pairs with a mesh only in a one-process group."""
        if _mesh_ranks(self.mesh) != _mesh_ranks(target.mesh):
            raise ValueError(
                "handoff between engines over different ranks: a mesh "
                f"of {_mesh_ranks(self.mesh)} ranks, a target over "
                f"{_mesh_ranks(target.mesh)}")
        if target is self:
            raise ValueError("handoff target must be a different engine")
        if target._health == DRAINING:
            raise ValueError("handoff target is draining/closed")
        if int(target.ecfg.eos_id) != int(self.ecfg.eos_id):
            raise ValueError("handoff target must keep eos_id")
        if int(target.ecfg.seed) != int(self.ecfg.seed):
            raise ValueError("handoff target must keep seed: sampled "
                             "resume folds it into every per-request key")
        self._drain()
        records = self._live_records()
        frames = {rs.rid: rs.encoder_frames
                  for rs in list(self.scheduler.waiting) + self.slot_req
                  if rs is not None and rs.encoder_frames is not None}
        target._validate_readmit(records, frames)
        self._set_health(HANDOFF, "handoff")
        for slot, rs in enumerate(self.slot_req):
            if rs is None:
                continue
            if slot in self._prefilling:
                self._prefilling.remove(slot)
            self._release_slot_resources(slot, rs)
        self.scheduler.waiting.clear()
        for rec in records:
            # closes the span here; the target opens a fresh one
            self.trace.record(rec["rid"], "handoff",
                              tokens_generated=len(rec["delivered"]))
            self._requests.pop(rec["rid"], None)
        known = frozenset()
        if self.journal is not None and target.journal is None:
            target.journal = self.journal
            target._owns_journal = self._owns_journal
            self.journal = None
            self._owns_journal = False
            target.journal.begin_epoch({"reason": "handoff"})
            known = frozenset(rec["rid"] for rec in records)
        # (a decoder-only model's requests carry no frames to pass on)
        target._readmit(records, journal_known_rids=known,
                        **({"encoder_frames": frames} if frames else {}))
        if self._tel is not None:
            self._tel.handoffs.inc()
        self._set_health(DRAINING, "handoff_complete")
        self._publish_gauges()
        return {"transferred": len(records),
                "source_tick": self.stats["ticks"],
                "target_tick": target.stats["ticks"]}

    # --- decode tick ------------------------------------------------------

    def _decode_bucket(self, active: List[int]) -> int:
        """Smallest decode block bucket covering every live context (+1 for
        the token written this tick). `_host_len` keeps counting for
        device-finished-but-undrained slots, which can only round up."""
        need = max(kvc.blocks_for(int(self._host_len[s]) + 1,
                                  self.ecfg.page_size) for s in active)
        return kvc.bucket_for(min(need, self.blocks_per_slot),
                              self.decode_buckets)

    def _check_disjoint_writes(self, active: List[int]) -> None:
        """A data rank writes its own slots' new K/V before the others'
        arrive (lm.decode_step's write-back), which is the unsharded write
        only if a tick's slots write disjoint blocks: each slot's write
        lands in a block it alone holds (refcount 1: never a shared radix
        block) or in the null block (past its reservation)."""
        bs = self.ecfg.page_size
        seen = set()
        for s in active:
            col = min(int(self._host_len[s]) // bs, self._chunk_cols - 1)
            blk = int(self.block_table[s, col])
            if blk == kvc.NULL_BLOCK:
                continue
            assert blk not in seen and self.allocator.refcount(blk) == 1, \
                f"slot {s} writes block {blk}, shared in this tick"
            seen.add(blk)

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
            # containment layer by design (recovery is journal replay in a
            # fresh engine, ServeEngine.recover, not an except path here)
            raise faults_lib.ProcessCrash(self.stats["ticks"])
        if self.mesh is not None:
            hit = self._mesh_sync()
            if self._control is not None:
                # global rank 0 sent a control, not a tick (frontdoor.follow)
                return 0
            self._enforce_deadlines(hit)
        elif self._has_deadlines:
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
            if free and self.paged and self.ecfg.preemption:
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
        forced = tuple(s for s in active if self.slot_req[s].replay)
        force = None
        if forced:
            # readmitted slots feed their delivered tokens back, one a tick
            f = np.full(self.ecfg.slots, -1, np.int64)
            for s in forced:
                rs = self.slot_req[s]
                f[s] = rs.out_tokens[len(rs.out_tokens) - rs.replay]
                rs.replay -= 1
            force = self._h2d(f)
        if self._dsharded and self.paged:
            self._check_disjoint_writes(active)
        out = self._decode_tick(
            self._decode_bucket(active) if self.paged else None, force)
        self._pending.append(_TickRecord(self.stats["ticks"], tuple(active),
                                         out, forced))
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
            if self.rank == 0:
                # under a mesh the other ranks adopt rank 0's health
                self._watchdog(step_s)
            toks, done, oks = arr[i]
            for slot in rec.slots:
                rs = self.slot_req[slot]
                if rs is None:
                    # ghost tick: the slot finished at an earlier (buffered)
                    # tick; its masked decode output is dropped
                    continue
                if slot in rec.forced and oks[slot]:
                    continue        # a replayed token, delivered before
                if (not oks[slot]
                        or (self.faults is not None
                            and self._fault("nan_logits", rid=rs.rid,
                                            tick=rec.tick))):
                    self._quarantine(slot, rs, now, rec.tick)
                    continue
                tok = int(toks[slot])
                rs.out_tokens.append(tok)
                if self.journal is not None:
                    # write-ahead: the token is recorded before any client
                    # can see it, and tokens still in the pending device
                    # buffer never are, so recovery neither drops a token a
                    # client saw nor replays one it did not
                    self.journal.record_token(rs.rid, tok)
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
        if not self.paged:
            return
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
        Shared blocks were read-only for it and stay as they are. On the
        dense backend the slot's rows of every cache leaf are zeroed, for
        the same reason: a later request's prefill rewrites only its own
        prefix of them (the reference scrubs nothing there)."""
        row = self._local_slot(slot)
        if not self.paged and row is not None:
            for _, leaf in tree_flatten(self.caches):
                leaf[:, row] = 0
        for b in rs.blocks:
            if self.allocator.refcount(b) == 1:
                kvc.scrub_pool_block(self.caches, b)
        self._retire(slot, rs, "numeric_error", now, tick)

    # --- warmup / driver ----------------------------------------------------

    def warmup(self, prefill: bool = True) -> int:
        """Run one decode tick per decode bucket (one on the dense backend)
        and, with `prefill`, one prefill chunk per reachable chunk-table
        width (paged; every write lands in the null block) or one prefill
        per bucket into slot 0's row (dense, bucketed; the row is
        overwritten at its first admission) on idle slots, so the kernels
        are built and loaded and the libraries initialised before the first
        request. Returns the calls made."""
        assert all(r is None for r in self.slot_req) and not self._pending, \
            "warmup() requires an idle engine"
        calls = 0
        for nb in (self.decode_buckets if self.paged else (None,)):
            self._decode_tick(nb)
            calls += 1
        if prefill and self.paged:
            toks = np.zeros((1, self.prefill_chunk), np.int32)
            for w in self.chunk_widths:
                self._chunk(toks, np.full((1, w), kvc.NULL_BLOCK, np.int32),
                            0, 0)
                calls += 1
        elif prefill and self.bucketed:
            enc = self.cfg.encoder
            frames = (None if enc is None else
                      np.zeros((enc.num_frames, self.cfg.d_model), np.float32))
            for b in self.buckets:
                self._prefill_dense(np.zeros((1, b), np.int32), 1, 0, frames)
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

    def meta_copy(self) -> "ServeEngine":
        """A shallow copy of the engine whose parameters, caches, slot state,
        sampler state and block table are meta tensors of the same shapes
        and dtypes: it holds no device memory, and its decode_cost is this
        engine's, at any later time. Its host bookkeeping is this engine's
        own (shared): run nothing on it but decode_cost."""
        import copy
        probe = copy.copy(self)
        meta = wq_lib.to_meta
        probe.device = torch.device("meta")
        probe.params, probe.caches = meta(self.params), meta(self.caches)
        probe._state = meta(self._state)
        probe._key = meta(self._key)
        probe._sp_dev = meta(self._sp_dev)
        probe._act = lm.make_act(self.cfg, "meta")
        if self._attn_quant is not None:
            probe._attn_quant = self._attn_quant._replace(
                spec=self._attn_quant.spec.to("meta"))
        if self.paged:
            probe._table_dev = meta(self._table_dev)
        return probe

    def decode_cost(self, bucket: Optional[int] = None) -> Dict[str, Any]:
        """The work of one decode tick at decode bucket `bucket` (default
        the widest; the dense backend has none), counted by
        roofline/count.py on meta copies of the engine's parameters,
        caches, slot state and block table: no device work, no host sync,
        and the engine's state as it was. The tick is the engine's own
        (_decode_tick), with its sampler setting and, under a mesh, this
        rank's shard and the collectives it issues (recorded, not issued).

        `gather_bytes` is the paged K/V read traffic (the blocks the bucket
        maps, never the pool's capacity); `bytes` the read-once plus
        written-once proxy at every counted op (an upper bound);
        `weight_bytes` the parameter tree as stored (packed payloads and
        exponent planes at weight_bits < 16: quant/weights.py's
        packed_param_bytes); `param_bytes` every tensor the tick receives
        (parameters, caches, slot state, table), by dtype. Beyond the
        reference's keys: `collective_bytes`, `collectives` (by op, and
        `collective_count`), `launches` by kernel (launch_counts()'s
        names) and `roofline` (roofline/analyze.py's terms against the
        H100's peaks, with the dominant one)."""
        from repro_torch import kernels
        from repro_torch.roofline import analyze
        from repro_torch.roofline import count as rcount
        width = None
        if self.paged:
            width = bucket or self.decode_buckets[-1]
        probe = self.meta_copy()
        with rcount.count() as t:
            ServeEngine._decode_tick(probe, width)
        rcount.add_params(t, probe.params, probe.caches, probe._state,
                          probe._table_dev[:, :width] if self.paged
                          else None)
        launches = {k: 0 for k in kernels.launch_counts()}
        launches.update(t.launches)
        out = rcount.decode_keys(t)
        out.update(
            weight_bytes=float(wq_lib.packed_param_bytes(self.params)),
            collective_bytes=t.collective,
            collectives=dict(t.collective_by_op),
            collective_count=t.collectives, launches=launches,
            roofline=analyze.roofline_terms(
                flops=t.flops, bytes_accessed=t.bytes,
                collective_bytes=t.collective, chips=_mesh_ranks(self.mesh),
                ops_by_kind=t.ops_by_kind))
        return out

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
        if self.paged:
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
        one event per line; schema in serve/trace.py); returns the lines.
        Under a mesh only rank 0 writes (the others return 0)."""
        if not self.is_writer:
            return 0
        return self.trace.export_jsonl(path)

    # --- lifecycle ----------------------------------------------------------

    def serve_metrics(self, port: int = 0):
        """Start an HTTP /metrics, /metrics.json and /healthz endpoint on
        127.0.0.1 for this engine and own it: close() stops the socket and
        joins its thread. Returns the server (`server_address[1]` is the
        bound port when 0 was asked for); a second call returns the running
        one. Under a mesh only rank 0 serves (the others return None)."""
        if self.registry is None:
            raise ValueError("serve_metrics() requires telemetry=True")
        if not self.is_writer:
            return None
        if self._metrics_server is None:
            self._metrics_server = tel.start_metrics_server(
                self.registry, port, health_cb=lambda: self._health)
        return self._metrics_server

    def close(self) -> None:
        """Enter DRAINING, deliver pending ticks, sync the journal (closing
        it if the engine owns it) and stop the owned metrics endpoint.
        Idempotent; the journal and the endpoint are released even when the
        final drain raises. The engine stays readable (metrics(),
        export_trace()) afterwards."""
        try:
            self._set_health(DRAINING, "close")
            self._drain()
        finally:
            if self.journal is not None:
                self.journal.sync()
                if self._owns_journal:
                    self.journal.close()
            server, self._metrics_server = self._metrics_server, None
            if server is not None:
                server.stop()

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
