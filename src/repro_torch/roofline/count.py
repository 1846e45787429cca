"""The count of the work an eager function does: products' FLOPs, bytes
read and written, collective bytes, kernel launches — the counterpart of
the JAX package's roofline/hlo.py, which reads the same totals off a
compiled module's HLO text.

    with count() as t:
        fn(*args)          # on CUDA, CPU or meta tensors
    t.flops, t.bytes, t.bytes_by_op["gather"], t.collective_by_op, ...

Inside the block every aten op that runs is counted through a torch
dispatch mode, on whatever device it runs:

  * flops: the products' FLOPs from torch.utils.flop_counter's registered
    formulas (mm, bmm, addmm, baddbmm, attention, convolution), and
    2 M K N for torch._int_mm; elementwise work is not counted (it shows
    in the memory term), as hlo.py counts only dot and convolution;
  * bytes: each op's tensor inputs read once and its outputs written once,
    at the op's boundary — the eager counterpart of hlo.py's instruction-
    boundary proxy, and like it an upper bound on the device's traffic (an
    intermediate a fused implementation keeps on chip counts here). Views
    and allocations move nothing. A gather (indexing, index_select,
    embedding, gather) reads what it outputs, and its output bytes also go
    to `bytes_by_op["gather"]`; a scatter (index_put_, index_copy_,
    scatter) reads and writes its values, never the whole destination, so
    a KV pool's capacity never enters the count;
  * dot_bytes: the operand and output bytes of every mm / bmm / addmm /
    baddbmm / _int_mm;
  * collectives: every c10d op but barriers, its output bytes under the
    reference's op names ("all-reduce", "all-gather", ...).

The port's kernels are bound through ctypes (kernels/build.py): the
dispatcher never sees them. Each of the six kernel wrappers therefore
records its own cost (`kernel`): its products' FLOPs, each input byte
read once and each output byte written once (K/V blocks of the paged
kernels under `bytes_by_op["gather"]` too), and a launch under its
launch_counts() name. While it records, nothing its body runs is counted
again — on the card the launch, on the CPU its plain version, on the meta
device an empty output of the kernel's shape — so a function counts the
same on every route. Collectives on meta tensors (nn/shard_ctx.py's
count-only path) record their bytes through `collective`.

hlo.py's trip-count walk has no counterpart: eager code runs every repeat
of a loop, and every repeat is counted as it runs. Nor is there an
entry-parameter walk: `param_bytes` is filled by the caller from the trees
the counted function receives (`add_params`).

The count is process-wide while a block is open (a backward that autograd
runs on a thread of its own is counted too), so count one function at a
time.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional

import torch

# the reference's HLO dtype names, for param_bytes_by_dtype
DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float32: "f32", torch.float64: "f64",
               torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
               torch.int32: "s32", torch.int64: "s64", torch.bool: "pred"}
# the peak a product of this operand type runs at (the keys of
# analyze.H100.ops_per_s)
OP_KIND = {torch.bfloat16: "bf16", torch.float16: "bf16",
           torch.float32: "f32", torch.float64: "f64", torch.int8: "int8",
           torch.int32: "int32"}


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0          # read-once + written-once (upper bound)
    dot_bytes: float = 0.0      # products' operand + output bytes
    collective: float = 0.0
    collective_by_op: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # bytes by aten op ("aten.mm", ...) or kernel name ("paged_attention",
    # ...); "gather" is the class of gathered (table-indexed) reads: the
    # paged decode's K/V traffic
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the bytes of the trees the counted function receives (add_params)
    param_bytes: float = 0.0
    param_bytes_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # beyond hlo.Totals: operations by the peak they run at (products'
    # FLOPs, and the GRAU unit's integer operations), the number of
    # collectives, and kernel launches by launch_counts() name
    ops_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    collectives: int = 0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    def _bytes(self, op: str, n: float) -> None:
        self.bytes += n
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + n

    def _ops(self, kind: str, n: float) -> None:
        if n:
            self.ops_by_kind[kind] = self.ops_by_kind.get(kind, 0.0) + n


@dataclasses.dataclass(frozen=True)
class Cost:
    """One kernel call's work: its products' FLOPs (at operand type
    `kind`), other operations of that type (`ops`: the GRAU datapath's
    integer operations), the bytes it must read and write (each input once,
    each output once) and, of the reads, the K/V blocks it reads through a
    block table (`gather`)."""
    flops: float = 0.0
    kind: str = "bf16"
    ops: float = 0.0
    reads: float = 0.0
    writes: float = 0.0
    gather: float = 0.0

    @property
    def nbytes(self) -> float:
        return self.reads + self.writes


_OPEN: List[Totals] = []     # the open counts, outermost first
_QUIET = [0]                 # > 0: inside a kernel's recorded body


def nbytes(t: Optional[torch.Tensor]) -> int:
    """A tensor's bytes (0 for None)."""
    return 0 if t is None else t.numel() * t.element_size()


def active() -> bool:
    """Whether a count is open (and not inside a kernel's recorded
    body)."""
    return bool(_OPEN) and _QUIET[0] == 0


def _record(name: str, c: Cost, subcounts, launch: bool) -> None:
    for t in _OPEN:
        t.flops += c.flops
        t._ops(c.kind, c.flops + c.ops)
        t._bytes(name, c.nbytes)
        if c.flops:
            t.dot_bytes += c.nbytes
        if c.gather:
            t.bytes_by_op["gather"] = (t.bytes_by_op.get("gather", 0.0)
                                       + c.gather)
        if launch:
            for key in (name,) + tuple(f"{name}_{s}" for s in subcounts):
                t.launches[key] = t.launches.get(key, 0) + 1


@contextlib.contextmanager
def kernel(name: str, cost: Callable[[], Cost], subcounts=(),
           launch: bool = True) -> Iterator[None]:
    """Around a kernel wrapper's body: while a count is open, record
    `cost()` (called only then) and one launch of `name` (with the
    launch_counts() sub-counts `name`_s for s in `subcounts`), and count
    nothing the body runs."""
    if not active():
        yield
        return
    _record(name, cost(), subcounts, launch)
    _QUIET[0] += 1
    try:
        yield
    finally:
        _QUIET[0] -= 1


def collective(op: str, nbytes_out: float) -> None:
    """Record one collective of `op` (the reference's name) moving
    `nbytes_out` output bytes: a collective the count-only path of
    nn/shard_ctx.py does not issue."""
    if not active():
        return
    for t in _OPEN:
        t.collective += nbytes_out
        t.collective_by_op[op] = t.collective_by_op.get(op, 0.0) + nbytes_out
        t.collectives += 1


def add_params(t: Totals, *trees) -> None:
    """Add the bytes of every tensor in `trees` (nested dicts, lists,
    tuples, NamedTuples and dataclasses of tensors) to t.param_bytes, by
    dtype."""
    for x in _tensors(trees):
        b = nbytes(x)
        name = DTYPE_NAMES.get(x.dtype, str(x.dtype))
        t.param_bytes += b
        t.param_bytes_by_dtype[name] = t.param_bytes_by_dtype.get(name, 0.0) + b


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


# ---------------------------------------------------------------------------
# the dispatch mode
# ---------------------------------------------------------------------------

# ops that move no bytes: allocations, and metadata ops that are not views
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "_reshape_alias", "lift_fresh",
         "detach", "alias", "resize_", "set_", "record_stream",
         "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
         "is_same_size", "_has_compatible_shallow_copy_type"}
_GATHERS = {"index", "index_select", "embedding", "gather"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "index_copy",
             "index_copy_", "scatter", "scatter_", "scatter_add",
             "scatter_add_", "index_add", "index_add_"}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "_int_mm"}
# c10d op -> the reference's (HLO) collective name
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute", "broadcast_": "broadcast",
    "reduce_": "reduce", "gather_": "gather", "scatter_": "scatter"}


def _flat(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _flat(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _flat(v)


def _sum_bytes(x) -> int:
    return sum(nbytes(t) for t in _flat(x))


def _flops(func, packet, args, kwargs, out) -> float:
    from torch.utils.flop_counter import flop_registry
    if packet in flop_registry:
        return float(flop_registry[packet](*args, **kwargs, out_val=out))
    if packet.__name__ == "_int_mm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2.0 * m * k * n
    return 0.0


def _op(totals: List[Totals], func, args, kwargs, out) -> None:
    name = func._overloadpacket.__name__
    if func.namespace == "c10d":
        if "barrier" in name or name not in _COLLECTIVES:
            return
        b = _sum_bytes(args[0])
        for t in totals:
            op = _COLLECTIVES[name]
            t.collective += b
            t.collective_by_op[op] = t.collective_by_op.get(op, 0.0) + b
            t.collectives += 1
        return
    if func.namespace != "aten" or func.is_view or name in _FREE:
        return
    flops = _flops(func, func._overloadpacket, args, kwargs, out)
    first = next(_flat(args), None)
    kind = OP_KIND.get(first.dtype, "f32") if first is not None else "f32"
    gather = 0
    if name in _GATHERS:
        out_b = _sum_bytes(out)
        idx = args[1:] if name != "index_select" else args[2:]
        reads, writes, gather = out_b + _sum_bytes(idx), out_b, out_b
    elif name in _SCATTERS:
        src = list(_flat(args[1:]))
        reads, writes = _sum_bytes(src), nbytes(src[-1]) if src else 0
    else:
        reads = _sum_bytes(args) + _sum_bytes(kwargs)
        writes = _sum_bytes(out)
    for t in totals:
        t.flops += flops
        t._ops(kind, flops)
        t._bytes(f"aten.{name}", reads + writes)
        if gather:
            t.bytes_by_op["gather"] = t.bytes_by_op.get("gather", 0.0) + gather
        if name in _DOTS:
            t.dot_bytes += reads + writes


def _mode(totals: Totals):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if _QUIET[0] == 0:
                _op([totals], func, args, kwargs, out)
            return out
    return _Count()


@contextlib.contextmanager
def count() -> Iterator[Totals]:
    """Count everything the block runs (see the module's docstring) into
    the Totals it yields. Counts nest: an inner block's work is counted in
    the outer one's too."""
    t = Totals()
    _OPEN.append(t)
    try:
        with _mode(t):
            yield t
    finally:
        del _OPEN[next(i for i, x in enumerate(_OPEN) if x is t)]


def decode_keys(t: Totals) -> Dict[str, float]:
    """The reference's decode_cost keys of a count."""
    return {"flops": t.flops, "bytes": t.bytes, "dot_bytes": t.dot_bytes,
            "gather_bytes": t.bytes_by_op.get("gather", 0.0),
            "param_bytes": t.param_bytes,
            "param_bytes_by_dtype": dict(t.param_bytes_by_dtype)}
