"""Rank-side jobs of tests/test_torch_train_mesh.py and
tests/test_torch_elasticity.py, importable by the spawned rank processes
(torch and the port only, no JAX).

`run(rank, shape, work)` runs in each rank of a (data, model) gloo mesh of
`shape` on the CPU: every job of `work` ((name, kind, keyword arguments)
each), by name. One spawn serves every job of one mesh shape. Whole trees
(gathered gradients and parameters) come back from global rank 0 only;
the losses from every rank, so a test can hold them equal.
"""
from __future__ import annotations

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch import steps
from repro_torch.launch.mesh import global_rank, make_mesh
from repro_torch.nn import shard_ctx
from repro_torch.nn.common import tree_flatten
from repro_torch.train import optim


def _batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def loss_and_grads(mesh, cfg, params, batch, remat=None, chunk=16):
    """The loss (the data ranks' shares summed) and the gathered gradients
    of one step's loss on this mesh."""
    shards = steps.shard_train_params(params, cfg, mesh)
    fn = steps.make_loss_and_grads(cfg, remat=remat, q_chunk=chunk,
                                   kv_chunk=chunk, mesh=mesh)
    with shard_ctx.use(mesh):
        loss, grads = fn(shards, steps.data_rows(_batch(batch), mesh))
        loss = shard_ctx.sum_data(loss)
    return loss, steps.unshard(grads, cfg, mesh)


def grads(mesh, cfg, params, batch, remat=None, chunk=16):
    loss, g = loss_and_grads(mesh, cfg, params, batch, remat, chunk)
    return {"loss": float(loss), "grads": g if global_rank(mesh) == 0
            else None}


def remat_bits(mesh, cfg, params, batch, chunk=16):
    """Whether remat "full" and "dots" give remat None's loss and gathered
    gradients bit for bit on this mesh."""
    base = loss_and_grads(mesh, cfg, params, batch, None, chunk)
    out = {}
    for remat in ("full", "dots"):
        loss, g = loss_and_grads(mesh, cfg, params, batch, remat, chunk)
        out[remat] = bool(torch.equal(loss, base[0])) and all(
            torch.equal(a, b) for (_, a), (_, b)
            in zip(tree_flatten(g), tree_flatten(base[1])))
    return out


def thread_bits(mesh, cfg, params, batch, chunk=16):
    """Whether each remat's loss and gathered gradients are the same bits
    with the backward run on another thread (as autograd runs a CUDA
    backward, and with it the remat recomputation, on a thread of its own
    that holds no shard_ctx context)."""
    import threading
    grad = torch.autograd.grad

    def on_thread(*a, **k):
        box = {}
        t = threading.Thread(target=lambda: box.update(out=grad(*a, **k)))
        t.start()
        t.join()
        return box["out"]
    out = {}
    for remat in (None, "full", "dots"):
        base = loss_and_grads(mesh, cfg, params, batch, remat, chunk)
        torch.autograd.grad = on_thread
        try:
            loss, g = loss_and_grads(mesh, cfg, params, batch, remat, chunk)
        finally:
            torch.autograd.grad = grad
        out[str(remat)] = bool(torch.equal(loss, base[0])) and all(
            torch.equal(a, b) for (_, a), (_, b)
            in zip(tree_flatten(g), tree_flatten(base[1])))
    return out


def train(mesh, cfg, params, batches, opt_kw, remat=None, microbatches=1,
          chunk=16):
    """len(batches) steps of make_train_step(mesh=): the losses, the
    gradient norms, and the gathered parameters after the last."""
    shards = steps.shard_train_params(params, cfg, mesh)
    opt = optim.init_opt_state(shards)
    step = steps.make_train_step(cfg, optim.AdamWConfig(**opt_kw),
                                 remat=remat, q_chunk=chunk, kv_chunk=chunk,
                                 microbatches=microbatches, mesh=mesh)
    losses, norms = [], []
    for b in batches:
        shards, opt, m = step(shards, opt, _batch(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = steps.unshard(shards, cfg, mesh)
    return {"losses": losses, "grad_norms": norms,
            "params": full if global_rank(mesh) == 0 else None}


def _state_like(cfg, mesh, params):
    shards = steps.shard_train_params(params, cfg, mesh)
    return {"params": shards, "opt": optim.init_opt_state(shards)}


def _gathered(cfg, mesh, state):
    """The whole training state from this rank's shard of it."""
    return {"params": steps.unshard(state["params"], cfg, mesh),
            "opt": optim.OptState(
                step=state["opt"].step,
                m=steps.unshard(state["opt"].m, cfg, mesh),
                v=steps.unshard(state["opt"].v, cfg, mesh))}


def save_then_step(mesh, cfg, params, batches, opt_kw, ckpt_dir):
    """Train on batches[:-1], save a sharded checkpoint of the state after
    them, then take the step on batches[-1]: the whole saved state and the
    last step's loss."""
    state = _state_like(cfg, mesh, params)
    step = steps.make_train_step(cfg, optim.AdamWConfig(**opt_kw),
                                 remat=None, q_chunk=16, kv_chunk=16,
                                 mesh=mesh)
    p, o = state["params"], state["opt"]
    for b in batches[:-1]:
        p, o, _ = step(p, o, _batch(b))
    placement = steps.state_placement(steps.param_placement(cfg, mesh))
    n = len(batches) - 1
    ckpt.save(ckpt_dir, n, {"params": p, "opt": o}, mesh=mesh,
              placement=placement)
    saved = _gathered(cfg, mesh, {"params": p, "opt": o})
    _, _, m = step(p, o, _batch(batches[-1]))
    return {"state": saved if global_rank(mesh) == 0 else None,
            "next_loss": float(m["loss"])}


def restore_then_step(mesh, cfg, params, batch, opt_kw, ckpt_dir, step_n,
                      total):
    """Restore the checkpoint onto this mesh: the whole restored state, and
    the loss of one more step on `batch` (the schedule at `total` steps)."""
    like = _state_like(cfg, mesh, params)
    placement = steps.state_placement(steps.param_placement(cfg, mesh))
    state = ckpt.restore(ckpt_dir, step_n, like, mesh=mesh,
                         placement=placement)
    whole = _gathered(cfg, mesh, state)
    step = steps.make_train_step(cfg, optim.AdamWConfig(**opt_kw),
                                 remat=None, q_chunk=16, kv_chunk=16,
                                 mesh=mesh)
    _, _, m = step(state["params"], state["opt"], _batch(batch))
    return {"state": whole if global_rank(mesh) == 0 else None,
            "next_loss": float(m["loss"])}


JOBS = {"grads": grads, "remat_bits": remat_bits, "train": train,
        "thread_bits": thread_bits,
        "save_then_step": save_then_step,
        "restore_then_step": restore_then_step}


def run(rank: int, shape, work):
    torch.manual_seed(0)
    mesh = make_mesh(*shape, device="cpu", backend="gloo")
    return {name: JOBS[kind](mesh, **kw) for name, kind, kw in work}
