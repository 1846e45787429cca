"""The (data, model) mesh over torch.distributed, for serving and training:
explicit tensor parallelism (and, in training, FSDP).

The JAX package's meshes are `jax.sharding.Mesh`es of devices in one
process, and GSPMD partitions each jitted step over them. Here the mesh is
one process per rank: `make_mesh(data, model)` (`make_serve_mesh` is the
same function) returns a
`torch.distributed.device_mesh.DeviceMesh` with dims ("data", "model") over
the ranks of an initialised process group, every rank holds its shard of the
weights and of the KV storage (serve/sharding.py), every rank runs the same
host schedule, and the model code calls the collectives itself
(nn/shard_ctx.py). The model axis shards the heads, the MLP and the
vocabulary; the data axis shards the decode slot batch, each data rank
computing its contiguous range of slots and all-gathering the tick's new
K/V rows and its (tokens, done, finite) record, so every rank's pool and
host state stay the same (serve/engine.py). Training (launch/steps.py
make_train_step(mesh=)) cuts the same model axis and, FSDP, each leaf's
d_model over the data axis (train/fsdp.py), each data rank training on its
share of the batch's rows.

`spawn_ranks(fn, world)` starts the rank processes (the `spawn` start method,
never `fork`: the parent may hold a CUDA context or other runtimes'
threads), rendezvous through a FileStore in a fresh temporary directory (no
TCP port, so concurrent callers cannot collide), with a collective timeout,
and fails the whole call if any rank raises or the join deadline passes.

The backend is the caller's: nccl (default on CUDA) needs one card a rank
and raises when ranks would share one; gloo (default on the CPU) also takes
CUDA tensors, which is how two ranks share one card.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import weakref
from typing import Any, Callable, List, Optional, Sequence, Tuple

AXES = ("data", "model")
COLLECTIVE_TIMEOUT_S = 60.0

# the gloo group over every rank of a mesh for host-side decisions (the
# engine broadcasts global rank 0's clock-based decisions and the front
# door's admissions over it, on CPU tensors, so the tick never waits on
# the device for them): the world group under gloo, a gloo group of its
# own when the mesh's groups are nccl
_HOST_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_OWNED = {"store": None}       # the FileStore directory of a one-rank
# group make_mesh started (release_mesh ends the group, removes it)


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """'4' -> (1, 4) tensor-parallel; 'DxM' (e.g. '2x2') -> (D, M)."""
    s = spec.lower().strip()
    try:
        if "x" in s:
            d, m = s.split("x")
            d, m = int(d), int(m)
        else:
            d, m = 1, int(s)
    except ValueError as e:
        raise ValueError(f"bad mesh spec {spec!r}; want 'M' or 'DxM'") from e
    if d < 1 or m < 1:
        raise ValueError(f"bad mesh spec {spec!r}: axes must be >= 1")
    return d, m


def default_backend(device) -> str:
    """nccl on CUDA, gloo on the CPU."""
    import torch
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_mesh(data: int, model: int, device, backend: str) -> None:
    """Refuse what a backend cannot do, before any process group exists:
    nccl on the CPU, and nccl with more ranks than cards (nccl refuses two
    ranks on one device; it never silently becomes gloo)."""
    import torch
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model}): axes must be >= 1")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if backend != "nccl":
        return
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("backend nccl needs CUDA devices; use gloo on the "
                         "CPU")
    cards = torch.cuda.device_count()
    if data * model > cards:
        raise ValueError(
            f"mesh ({data}, {model}) over nccl needs {data * model} cards, "
            f"have {cards}: nccl refuses ranks that share a device; use "
            "backend='gloo' when ranks share a card")


def rank_device(rank: int, device, backend: str):
    """The device of `rank`: its own card under nccl, the one card the
    ranks share under gloo (card rank % count), the CPU otherwise."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _init_one_rank(backend: str, timeout_s: float) -> None:
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="repro-mesh-")
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=timeout_s))
    _OWNED["store"] = tmp


def make_mesh(data: int = 1, model: int = 1, *, device=None,
              backend: Optional[str] = None,
              timeout_s: float = COLLECTIVE_TIMEOUT_S):
    """(data, model) mesh over the ranks of the initialised process group
    (spawn_ranks starts them), for serving or training. A (1, 1) mesh in a
    process with no group starts a one-rank group itself (release_mesh ends
    it). `device` defaults to CUDA (models/lm.resolve_device); `backend` to
    nccl there, gloo on the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.lm import resolve_device
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    check_mesh(data, model, dev, backend)
    need = data * model
    if not dist.is_initialized():
        if need != 1:
            raise ValueError(
                f"mesh ({data}, {model}) needs {need} ranks, have none: "
                "start them with launch/mesh.spawn_ranks")
        _init_one_rank(backend, timeout_s)
    have = dist.get_world_size()
    if have != need:
        raise ValueError(f"mesh ({data}, {model}) needs {need} ranks, have "
                         f"{have}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"the mesh asks for {backend}")
    if dev.type == "cuda":
        import torch
        torch.cuda.set_device(rank_device(dist.get_rank(), dev, backend))
    mesh = init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES)
    _HOST_GROUPS[mesh] = (dist.group.WORLD if backend == "gloo"
                          else dist.new_group(backend="gloo"))
    return mesh


make_serve_mesh = make_mesh


def host_group(mesh):
    """The gloo group over every rank of `mesh` for host-side decisions."""
    return _HOST_GROUPS[mesh]


def global_rank(mesh) -> int:
    """This process's rank in `mesh`'s process group (0 without a mesh):
    global rank 0 alone takes the clock's decisions, runs the front door
    and writes the journal, the trace, the snapshot and /metrics."""
    if mesh is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def host_broadcast(mesh, obj: Any) -> Any:
    """Global rank 0's `obj` (any picklable value; the others pass None),
    returned on every rank of `mesh` over its host group."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=host_group(mesh))
    return box[0]


def mesh_sizes(mesh) -> dict:
    """{"data": d, "model": m}."""
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def data_axes(mesh) -> tuple:
    """The axes that shard the decode batch (the reference's data_axes):
    the engine splits its slots over them (nn/shard_ctx.data_size)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def release_mesh() -> None:
    """End the one-rank group make_mesh started (no-op otherwise)."""
    import torch.distributed as dist
    tmp, _OWNED["store"] = _OWNED["store"], None
    if tmp is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, fn: Callable, world: int, tmp: str, backend: str,
               device: str, timeout_s: float, threads: Optional[int],
               args: Sequence[Any]) -> None:
    import torch
    import torch.distributed as dist
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank_device(rank, device, backend))
        out = fn(rank, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *, args: Sequence[Any] = (),
                device="cpu", backend: Optional[str] = None,
                timeout_s: float = COLLECTIVE_TIMEOUT_S,
                join_s: Optional[float] = 600.0,
                threads: Optional[int] = None) -> List[Any]:
    """Run fn(rank, *args) in `world` spawned processes joined in one
    process group and return each rank's result (torch.save-able), in rank
    order. `fn` must be importable by name (a module-level function). A
    rank that raises fails the call (the others are stopped); so does a
    join past `join_s` seconds (None: no deadline, for a server), and a
    collective past `timeout_s` raises inside its rank. `threads` sets each
    rank's torch threads (default on the CPU: the cores shared out)."""
    import torch
    import torch.multiprocessing as tmp_mp
    backend = backend or default_backend(device)
    if threads is None and torch.device(device).type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // world)
    check_mesh(1, world, device, backend)
    tmp = tempfile.mkdtemp(prefix="repro-ranks-")
    try:
        ctx = tmp_mp.start_processes(
            _rank_main, args=(fn, world, tmp, backend, str(device),
                              timeout_s, threads, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if join_s is None else time.monotonic() + join_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks did not finish within {join_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
