"""FSDP over a training mesh's data axis: each rank keeps 1/D of a leaf, cut
on its d_model axis (launch/steps.param_placement), and gathers the whole
leaf only while a piece of the model computes with it.

The reference has no such file: under GSPMD a parameter sharded over `data`
on its `embed` axis is all-gathered where a dot reads it and its gradient
reduce-scattered, by the partitioner. Here that is one autograd Function a
leaf: the forward all-gathers the data ranks' shards along the cut axis,
the backward sums the gradient over the data ranks and keeps this rank's
slice (a reduce-scatter). The sum is the data-parallel gradient sum: each
data rank's gradient is of its own rows' share of the global-mean loss
(models/lm.lm_loss). A leaf the data axis does not divide is replicated:
its gradient is all-reduced over the data axis instead.

`gatherer(placement, mesh)` is what models/lm.apply_lm(gather=) calls: the
top-level leaves once a forward, each repeat's layers inside its (remat)
body, so under remat "full" or "dots" a layer is gathered again in the
backward pass and one repeat's whole weights are live at a time. Every rank
runs the same forward and backward, so the collectives come in the same
order on every rank, recomputation included.

The reduce-scatter is an all-reduce that keeps this rank's slice, on
every backend. Over gloo, which two ranks sharing one card use, that beat
gloo's reduce_scatter_tensor on CUDA tensors (PERF.md); nccl's
reduce_scatter_tensor waits for a cell with a card a rank that can test
and time it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.nn import shard_ctx
from repro_torch.nn.common import tree_flatten, tree_map

@dataclasses.dataclass(frozen=True)
class Cut:
    """Where a leaf is cut: `model` and `data` are the (negative) axes cut
    in equal contiguous ranges over the mesh's model and data axes, or None
    where the leaf is replicated over that axis."""
    model: Optional[int] = None
    data: Optional[int] = None


def all_gather(x: torch.Tensor, axis: int, group, n: int) -> torch.Tensor:
    """The n ranks' x concatenated along `axis`, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    shard_ctx.all_gather_into(parts, x, group)
    return torch.cat(parts, dim=axis)


def reduce_scatter(g: torch.Tensor, axis: int, group, n: int,
                   r: int) -> torch.Tensor:
    """This rank's (r of n) slice along `axis` of g summed over `group`."""
    g = g.contiguous().clone()
    shard_ctx.all_reduce_(g, group)
    k = g.shape[axis] // n
    return g.narrow(axis, r * k, k).contiguous()


class _Gather(torch.autograd.Function):
    """Forward: the data ranks' shards gathered along the cut axis.
    Backward: the gradient reduce-scattered back to this rank's shard."""

    @staticmethod
    def forward(ctx, shard, axis, group, n, r):
        ctx.args = (axis, group, n, r)
        return all_gather(shard, axis, group, n)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, *ctx.args),) + (None,) * 4


class _SumGrad(torch.autograd.Function):
    """Forward: the identity (a leaf replicated over the data axis).
    Backward: the gradient summed over the data axis."""

    @staticmethod
    def forward(ctx, leaf, group):
        ctx.group = group
        return leaf.view_as(leaf)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        shard_ctx.all_reduce_(g, ctx.group)
        return g, None


def gatherer(placement, mesh) -> Optional[Callable]:
    """models/lm.apply_lm's `gather` for `placement` (a Cut tree shaped as
    the parameters) on `mesh`: gather(tree, where) gives the whole-d_model
    leaves of a piece, where None for the top-level leaves and "group{i}"
    for one repeat of group i. None on a one-rank data axis (nothing to
    gather)."""
    n = shard_ctx.data_size(mesh)
    if n == 1:
        return None
    group = mesh.get_group("data")
    r = shard_ctx.data_rank(mesh)

    def one(leaf: torch.Tensor, cut: Cut) -> torch.Tensor:
        grad = torch.is_grad_enabled() and leaf.requires_grad
        if cut.data is None:
            return _SumGrad.apply(leaf, group) if grad else leaf
        if grad:
            return _Gather.apply(leaf, cut.data, group, n, r)
        return all_gather(leaf, cut.data, group, n)

    def gather(tree, where: Optional[str]):
        cuts = ({k: placement[k] for k in tree} if where is None
                else placement[where][0])
        return tree_map(one, tree, cuts)
    return gather


def gather_leaf(x: torch.Tensor, cut: Cut, mesh) -> torch.Tensor:
    """The whole leaf from this rank's shard `x` (no gradient), a tensor of
    its own: gathered over the model axis, then the data axis, where it is
    cut on them."""
    out = x
    with torch.no_grad():
        for axis, name in ((cut.model, "model"), (cut.data, "data")):
            n = mesh.size(mesh.mesh_dim_names.index(name))
            if axis is not None and n > 1:
                out = all_gather(out, axis, mesh.get_group(name), n)
    return out.clone() if out is x else out


def local_piece(x: torch.Tensor, cut: Cut, coords, sizes) -> torch.Tensor:
    """The piece of the whole leaf `x` that the rank at `coords` (data
    rank, model rank) of a mesh of `sizes` (data, model) holds, as a tensor
    of its own (x itself where the rank holds it whole)."""
    (d, r), (nd, nm) = coords, sizes
    out = x
    for axis, i, n in ((cut.model, r, nm), (cut.data, d, nd)):
        if axis is not None and n > 1:
            k = out.shape[axis] // n
            out = out.narrow(axis, i * k, k)
    return out if out is x else out.clone()


def cut_sums(tree, placement, mesh) -> torch.Tensor:
    """The sum of every leaf's squares (f32) over its whole tensor: each
    leaf's local sum, summed over the mesh axes it is cut on and only
    those (a replicated leaf's local sum is already its whole). The groups
    of leaves (by the axes they are cut on) are reduced in a fixed order,
    so every rank gets the same bits."""
    m, d = shard_ctx.model_size(mesh), shard_ctx.data_size(mesh)
    cuts = dict(tree_flatten(placement))
    sums: dict = {}
    for path, x in tree_flatten(tree):
        c = cuts[path]
        key = (c.model is not None and m > 1, c.data is not None and d > 1)
        s = x.float().square().sum()
        sums[key] = s if key not in sums else sums[key] + s
    total = None
    for key in sorted(sums):
        s = sums[key]
        for on, name in zip(key, ("model", "data")):
            if on:
                shard_ctx.all_reduce_(s, mesh.get_group(name))
        total = s if total is None else total + s
    return total
