"""The training step (the JAX package's launch/steps.py::make_train_step)
and the head padding of tensor-parallel serving (`pad_heads_for`).

Training's FSDP x TP mesh and the dry-run's cell builders are not ported
(ROADMAP A11); serving's mesh is launch/mesh.py. PyTorch runs eagerly: the
step is a plain function, and its GRAU register file is built once per
device, on the host, as the reference builds it once outside its trace.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.nn.common import tree_flatten, tree_map
from repro_torch.train import optim


def pad_heads_for(cfg: ModelConfig, mesh) -> ModelConfig:
    """Zero-pad the head counts up to multiples of the model axis (`mesh`: a
    serving mesh or the axis size), so attention shards by heads; cfg as it
    is when the heads already divide it (or for MLA).

    The KV heads pad to the next multiple of the axis and the query heads
    to the arch's GQA group times that, so every real query head keeps its
    KV head and the pads (zero weights, nn/blocks.init_attention) read only
    pad KV heads: the padded model computes the unpadded one's function.
    The reference pads the query heads to the next multiple of the padded
    KV count instead, which keeps the group only where that multiple is
    the group times it (llama3-smoke's 4 / 2 heads at 3 ranks, but not
    glm4-smoke's 8 / 2: ROADMAP C, D5)."""
    m = mesh if isinstance(mesh, int) else mesh.size(
        mesh.mesh_dim_names.index("model"))
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if h % m == 0 or cfg.mla is not None:
        return cfg
    kvp = -(-kv // m) * m
    return cfg.replace(attn_pad=(h // kv * kvp, kvp))


def make_loss_and_grads(cfg: ModelConfig, *, remat: Optional[str] = "full",
                        q_chunk: int = 1024, kv_chunk: int = 1024,
                        attn_impl: str = "kernel") -> Callable:
    """(params, batch) -> (loss, grads): lm_loss and its gradient with
    respect to every parameter leaf (grads in the leaves' dtypes). The
    parameters need not require grad: the gradient is taken through
    detached aliases of them."""
    acts = {}

    def loss_and_grads(params, batch):
        dev = batch["tokens"].device
        if dev not in acts:
            acts[dev] = lm.make_act(cfg, dev)
        paths = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for _, p in paths]
        it = iter(leaves)
        alias = tree_map(lambda _: next(it), params)
        loss = lm.lm_loss(alias, cfg, batch, act=acts[dev], q_chunk=q_chunk,
                          kv_chunk=kv_chunk, remat=remat,
                          attn_impl=attn_impl)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    return loss_and_grads


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig, *,
                    remat: Optional[str] = "full", q_chunk: int = 1024,
                    kv_chunk: int = 1024, microbatches: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters and moments are updated in place (train/optim.py). With
    `microbatches` > 1 the batch splits along its first axis, the gradients
    sum in an f32 accumulator and the loss and gradients are averaged."""
    loss_and_grads = make_loss_and_grads(cfg, remat=remat, q_chunk=q_chunk,
                                         kv_chunk=kv_chunk)

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            if batch["tokens"].shape[0] % microbatches:
                raise ValueError(f"batch of {batch['tokens'].shape[0]} does "
                                 f"not split into {microbatches} "
                                 "microbatches")
            parts = {k: v.chunk(microbatches, dim=0) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(microbatches):
                l, g = loss_and_grads(params, {k: v[i]
                                               for k, v in parts.items()})
                tree_map(lambda a, b: a.add_(b), grads, g)
                loss = loss + l
                del g
            grads = tree_map(lambda g: g.div_(microbatches), grads)
            loss = loss / microbatches
        else:
            loss, grads = loss_and_grads(params, batch)
        params, opt_state, metrics = optim.adamw_update(opt_cfg, params,
                                                        grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
