"""The serving mesh's context: which mesh the model code runs under, the
model-axis collectives it calls there, and the data axis's one.

`use(mesh)` makes a launch/mesh.py serving mesh active on this thread (the
reference's thread-local `shard_ctx.use`); `active_mesh()` reads it. Under
it the weights and KV storage are this rank's shards (serve/sharding.py),
and the model code calls:

  * `reduce_model(x)`: the sum of a row-parallel product's partials (the
    attention's and MLA's `wo`, the MLP's `w_down`, an MoE layer's routed
    and shared experts together, Mamba-2's `out_proj`, the vocab-parallel
    embedding lookup) over the model group, in f32, cast back to x's dtype
    once (`row_partial` gives a partial in f32);
  * `sum_model(s)`: an f32 statistic summed over the model group: the sum
    of squares of Mamba-2's gated RMSNorm, whose d_inner the ranks split;
  * `gather_vocab(logits)`: the vocabulary shards of the logits
    concatenated, so every rank holds the full logits and the sampler,
    the argmax and the finite-logits flag decide alike on every rank.

They are no-ops without a context and on a one-rank model axis (a (1, 1)
mesh moves no bytes). On the data axis, which splits the engine's decode
slots, `gather_data(x, dim)` concatenates the data ranks' slot ranges of a
tensor: the tick's new K/V rows (models/lm.decode_step's write-back), its
(tokens, done, finite) record (serve/engine.py) and, inside `split_rows`
(a data rank's decode tick), an MoE layer's input, so every rank routes
and drops over the whole batch as the unsharded engine does; it is a no-op
on a one-rank data axis, so a (1, M) mesh issues the model axis's
collectives alone. Training (launch/steps.make_train_step(mesh=)) runs
the same model code with autograd on: each of these is a
torch.autograd.Function there,
with its backward (reduce_model's and sum_model's the identity,
gather_vocab's the rank's slice of the gradient), and one more marks where
a replicated activation enters a column-parallel product,
`enter_model(x)`: the identity forward, the gradient summed over the
model group backward (Megatron's "f"), so the residual stream's, the
norms' and the embedding's gradients are every rank's contributions, not
this rank's alone. `sum_data(s)` sums an f32 statistic over the data axis
without a gradient (the loss's token count). Under torch.no_grad (serving)
each runs its forward alone: the bits and the collectives are the ones
serving has always issued. These are the model code's and the engine's
only tensor collectives. Under a mesh the paged kernels also plan their
sequence split for the unsharded KV-head count (`plan_kv_heads`) and, in
decode, the unsharded slot count (`plan_batch`), so each head's and each
slot's attention is the unsharded launch's bits. `vocab_splits` /
`mlp_splits` / `experts_split` / `ssm_splits` say whether a tensor is
sharded at all; serve/sharding.py places the weights by the same rules.

The reference's `constrain` and its activation rules instruct GSPMD's
partitioner, which torch has no counterpart of: they are not ported
(ROADMAP C).

Every tensor collective of the port goes through `all_reduce_` and
`all_gather_into` here (train/fsdp.py's too). On meta tensors, or under a
`CountMesh` — a (data, model) mesh's shape and one rank's coordinates,
with no process group behind it (launch/steps.build_cell's dry run) —
they issue nothing: they record the collective's output bytes in the open
roofline count (roofline/count.py) and leave the outputs as they are, so a
rank's count of a mesh step runs in one process, on the meta device.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Tuple

import torch

from repro_torch.quant.weights import QuantWeight
from repro_torch.roofline import count as rcount

_STATE = threading.local()


class _CountGroup:
    """A CountMesh axis's stand-in for a process group."""


class CountMesh:
    """A (data, model) mesh's shape and this rank's place on it, with no
    process group: what the model code reads of a DeviceMesh (sizes, local
    ranks, groups). Collectives under it are recorded, not issued."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data: int, model: int, data_rank: int = 0,
                 model_rank: int = 0):
        self.shape = (data, model)
        self._ranks = (data_rank, model_rank)

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_local_rank(self, name: str) -> int:
        return self._ranks[self.mesh_dim_names.index(name)]

    def get_group(self, name: str) -> _CountGroup:
        return _CountGroup()


def _recorded(group, *tensors) -> bool:
    """Whether a collective on `tensors` over `group` is recorded rather
    than issued: meta tensors, or a CountMesh's group."""
    return isinstance(group, _CountGroup) or any(t.is_meta for t in tensors)


def all_reduce_(y: torch.Tensor, group) -> torch.Tensor:
    """Sum y over `group` in place (recorded only, see the module's
    docstring); returns y."""
    if _recorded(group, y):
        rcount.collective("all-reduce", rcount.nbytes(y))
        return y
    import torch.distributed as dist
    dist.all_reduce(y, group=group)
    return y


def all_gather_into(parts, x: torch.Tensor, group) -> None:
    """Fill `parts` (one tensor like x a rank) with the ranks' x, in rank
    order (recorded only, see the module's docstring)."""
    if _recorded(group, x):
        rcount.collective("all-gather", sum(rcount.nbytes(p) for p in parts))
        return
    import torch.distributed as dist
    dist.all_gather(parts, x, group=group)


def active_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use(mesh, plan_kv_heads: Optional[int] = None,
        plan_batch: Optional[int] = None):
    """Run the block under `mesh` (None: unsharded). `plan_kv_heads`, the
    model's unsharded KV-head count, and `plan_batch`, the engine's
    unsharded slot count, are what the paged kernels size their sequence
    parts for (plan_kv_heads(), plan_batch())."""
    prev = (getattr(_STATE, "mesh", None), getattr(_STATE, "plan", None),
            getattr(_STATE, "batch", None))
    _STATE.mesh, _STATE.plan, _STATE.batch = mesh, plan_kv_heads, plan_batch
    try:
        yield
    finally:
        _STATE.mesh, _STATE.plan, _STATE.batch = prev


_FIELDS = (("mesh", None), ("plan", None), ("batch", None), ("writes", None),
           ("rows", False))


def snapshot() -> tuple:
    """This thread's context (the mesh and every setting above), for
    `restored` on another thread."""
    return tuple(getattr(_STATE, k, d) for k, d in _FIELDS)


@contextlib.contextmanager
def restored(snap: tuple):
    """Run the block under a `snapshot` taken on another thread: autograd
    runs a CUDA backward, and with it activation checkpointing's
    recomputed forward, on a thread of its own, which holds no context."""
    prev = snapshot()
    for (k, _), v in zip(_FIELDS, snap):
        setattr(_STATE, k, v)
    try:
        yield
    finally:
        for (k, _), v in zip(_FIELDS, prev):
            setattr(_STATE, k, v)


def plan_kv_heads() -> Optional[int]:
    """The KV heads the paged kernels plan their sequence parts for under
    the active mesh (None: the pools' own count). A rank's launch holds a
    share of the heads; planned for all of them, it cuts each head's
    sequence where the unsharded launch does, so a head's output is the
    same bits either way."""
    return getattr(_STATE, "plan", None)


def plan_batch() -> Optional[int]:
    """The decode batch the paged decode kernel plans its sequence parts
    for under the active mesh (None: the launch's own). A data rank
    launches its share of the slots; planned for all of them, it cuts each
    slot's sequence where the unsharded launch does."""
    return getattr(_STATE, "batch", None)


@contextlib.contextmanager
def record_writes(log: Optional[list]):
    """Inside the block every paged decode write also appends (pool, k, v)
    to `log` (a data rank's forward: models/lm.decode_step's write-back
    then writes every slot's gathered rows). None: no log."""
    prev = getattr(_STATE, "writes", None)
    _STATE.writes = log
    try:
        yield
    finally:
        _STATE.writes = prev


def write_log() -> Optional[list]:
    """The active record_writes log (None outside one)."""
    return getattr(_STATE, "writes", None)


@contextlib.contextmanager
def split_rows(on: bool = True):
    """Inside the block (with `on`) the forward's rows are this data rank's
    range of the decode slots (data_slots): an MoE layer gathers its input
    over the data axis, routes every slot's rows and keeps its own."""
    prev = getattr(_STATE, "rows", False)
    _STATE.rows = bool(on)
    try:
        yield
    finally:
        _STATE.rows = prev


def rows_split() -> bool:
    """Whether the forward runs inside split_rows on a data axis of
    several ranks."""
    return getattr(_STATE, "rows", False) and data_size() > 1


def model_size(mesh=None) -> int:
    """The model axis' size (1 without a mesh)."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("model"))


def model_rank(mesh=None) -> int:
    """This rank's index on the model axis (0 without a mesh)."""
    mesh = mesh if mesh is not None else active_mesh()
    return 0 if mesh is None else mesh.get_local_rank("model")


def data_size(mesh=None) -> int:
    """The data axis' size (1 without a mesh)."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("data"))


def data_rank(mesh=None) -> int:
    """This rank's index on the data axis (0 without a mesh)."""
    mesh = mesh if mesh is not None else active_mesh()
    return 0 if mesh is None else mesh.get_local_rank("data")


def data_slots(slots: int, mesh=None) -> Tuple[int, int]:
    """[lo, hi): the contiguous range of `slots` decode slots this data
    rank computes — slots / D of them when D divides the slots, else all
    (the decode runs replicated, as the reference replicates an axis that
    does not divide its mesh axis)."""
    d = data_size(mesh)
    if d == 1 or slots % d:
        return 0, slots
    n = slots // d
    r = data_rank(mesh)
    return r * n, (r + 1) * n


def vocab_splits(vocab: int, m: int) -> bool:
    """The vocabulary shards over m ranks in equal contiguous ranges (else
    it is replicated, as the reference replicates an axis that does not
    divide its mesh axis)."""
    return vocab % m == 0


def mlp_splits(d_ff: int, w_down: Any, m: int) -> bool:
    """The MLP shards its d_ff over m ranks: d_ff divides, and a packed
    w_down (its contraction axis is d_ff) splits on whole k-tiles, so the
    shard is a slice of the packed planes, never a re-pack. Otherwise the
    whole MLP is replicated."""
    if d_ff % m:
        return False
    return (not isinstance(w_down, QuantWeight)
            or (d_ff // m) % w_down.tile == 0)


def experts_split(num_experts: int, m: int) -> bool:
    """An MoE layer's experts shard over m ranks in contiguous ranges of
    E / m (else they are replicated, the reference's divisibility
    fallback)."""
    return num_experts % m == 0


def ssm_splits(heads: int, groups: int, m: int) -> Tuple[bool, bool]:
    """(heads split, groups split): a Mamba-2 mixer shards by SSM head
    over m ranks where m divides the heads and every rank's heads keep
    their group — one group (B and C replicated) or m dividing the groups
    (B and C split with them); otherwise the mixer is replicated whole."""
    if m == 1 or heads % m:
        return False, False
    if groups % m == 0:
        return True, True
    return groups == 1, False


class _PartialMM(torch.autograd.Function):
    """a @ w in f32 from bf16 operands on the card (torch.mm's f32 output,
    which has no autograd formula of its own); the backward runs the two
    products in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ w.t(), a.t() @ g


def row_partial(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial a @ w (a 2-D or 3-D, w 2-D) for
    reduce_model to sum: in f32 where the model axis has several ranks (on
    the card through torch.mm's f32 output, so the partials are summed
    before the one rounding to a's dtype), in a's dtype on one rank (the
    unsharded product's bits); on the meta device as on the card."""
    if model_size() == 1 or a.dtype == torch.float32:
        return a @ w
    if a.is_cuda or a.is_meta:
        a2 = a.reshape(-1, a.shape[-1])
        if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
            out = _PartialMM.apply(a2, w)
        else:
            out = torch.mm(a2, w, out_dtype=torch.float32)
        return out.reshape(a.shape[:-1] + (w.shape[-1],))
    return (a @ w).float()


def _grad_on(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _all_reduce(y: torch.Tensor, axis: str, group=None) -> torch.Tensor:
    return all_reduce_(y, group or active_mesh().get_group(axis))


class _SumModel(torch.autograd.Function):
    """Forward: the f32 sum over the model group, cast to x's dtype.
    Backward: the identity (the output is replicated, and so is the
    gradient that reaches it)."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return _all_reduce(x.to(torch.float32, copy=True), "model").to(
            x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


# The Functions' backward runs on autograd's thread (a CUDA backward's is
# its own, with no shard_ctx context): each keeps what it needs in ctx.

class _EnterModel(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient summed over the model
    group (each rank's holds only its shard's contribution)."""

    @staticmethod
    def forward(ctx, x):
        ctx.group = active_mesh().get_group("model")
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), "model", ctx.group)


class _GatherVocab(torch.autograd.Function):
    """Forward: the ranks' vocabulary shards concatenated on the last axis.
    Backward: this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, logits):
        ctx.n, ctx.r = logits.shape[-1], model_rank()
        return _gather_model_last(logits)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.r * ctx.n, ctx.n).contiguous()


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """Sum `x` over the model group (in f32, cast back once); identity
    without a mesh and on a one-rank model axis (no collective: a sum of
    one term). Every rank gets the same bits. With autograd on, its
    backward is the identity."""
    if model_size() == 1:
        return x
    if _grad_on(x):
        return _SumModel.apply(x)
    return _all_reduce(x.to(torch.float32, copy=True), "model").to(x.dtype)


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """Where a replicated activation enters a column-parallel product (a
    model-axis shard of heads, of d_ff or of the vocabulary): x itself
    forward; with autograd on, the gradient summed over the model group
    backward. x itself without a mesh, on a one-rank model axis and
    without autograd (serving)."""
    if model_size() == 1 or not _grad_on(x):
        return x
    return _EnterModel.apply(x)


def sum_model(s: torch.Tensor) -> torch.Tensor:
    """An f32 statistic summed over the model group (a fresh tensor; s
    itself without a mesh and on a one-rank model axis). Every rank gets
    the same bits. With autograd on, its backward is the identity."""
    if model_size() == 1:
        return s
    if _grad_on(s):
        return _SumModel.apply(s)
    return _all_reduce(s.clone(), "model")


def sum_data(s: torch.Tensor) -> torch.Tensor:
    """An f32 statistic summed over the data group, without a gradient (a
    fresh tensor; s itself without a mesh and on a one-rank data axis):
    the training loss's token count, so each data rank's partial is its
    share of the global mean."""
    if data_size() == 1:
        return s
    return _all_reduce(s.detach().clone(), "data")


def gather_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Concatenate the data ranks' slot ranges of `x` along `dim`, in data
    rank order (each rank's range is data_slots'); identity without a mesh
    and on a one-rank data axis. Every rank gets the same bits."""
    mesh = active_mesh()
    if mesh is None or data_size(mesh) == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(data_size(mesh))]
    all_gather_into(parts, x, mesh.get_group("data"))
    return torch.cat(parts, dim=dim)


def _gather_model_last(x: torch.Tensor) -> torch.Tensor:
    mesh = active_mesh()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(model_size(mesh))]
    all_gather_into(parts, x, mesh.get_group("model"))
    return torch.cat(parts, dim=-1)


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Concatenate the model ranks' vocabulary shards of `logits` along the
    last axis; identity without a mesh and on a one-rank model axis. With
    autograd on, its backward keeps this rank's slice of the gradient."""
    mesh = active_mesh()
    if mesh is None or model_size(mesh) == 1:
        return logits
    if _grad_on(logits):
        return _GatherVocab.apply(logits)
    return _gather_model_last(logits)
