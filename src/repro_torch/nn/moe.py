"""Mixture-of-Experts: top-k routing, capacity-based scatter dispatch (the
JAX package's nn/moe.py, step for step).

  * router logits in f32 -> softmax or sigmoid scores -> the top-k experts
    of each token (ties to the lower index, as jax.lax.top_k) and their
    weights normalized by their sum;
  * the Switch-style load-balancing loss from the first choice's density
    and the mean router probability;
  * a (token, k) slot's place in its expert's queue from a cumsum over the
    token-major (t * k) order; slots at or past the capacity c are dropped
    (their combine weight is zeroed);
  * dispatch: scatter into an (E * c, d) buffer; the experts run as batched
    products on the (E, c, d) buffer; combine: gather per (token, k),
    weight, sum over k, plus the shared experts.

The expert products are plain batched matrix products (the reference's
einsums run outside any Pallas kernel), so MoE brings no kernel of its own.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn import shard_ctx
from repro_torch.nn.common import init_param, trunc_normal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                    # per-expert intermediate size
    num_shared: int = 0
    capacity_factor: float = 1.25
    gate: str = "softmax"        # "softmax" | "sigmoid" (deepseek-v3)
    router_aux_weight: float = 0.001


def _expert_leaf(shape, gen, *, device, dtype) -> torch.Tensor:
    """An (E, a, b) expert leaf with the reference's fan-in rule, whose fan
    in is shape[0] = E: drawn expert by expert into the preallocated
    target, so the f32 transient is one (a, b) slice, not the whole leaf."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:                 # shapes only: nothing to draw
        return out
    std = 1.0 / np.sqrt(max(shape[0], 1))
    for i in range(shape[0]):
        out[i] = trunc_normal(shape[1:], std, gen, device=device, dtype=dtype)
    return out


def init_moe(d_model: int, cfg: MoEConfig, gen: torch.Generator, *, device,
             dtype) -> dict:
    e, f = cfg.num_experts, cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    p = {"router": init_param((d_model, e), gen, **kw),
         "w_gate": _expert_leaf((e, d_model, f), gen, **kw),
         "w_up": _expert_leaf((e, d_model, f), gen, **kw),
         "w_down": _expert_leaf((e, f, d_model), gen, **kw)}
    if cfg.num_shared:
        sf = cfg.d_ff * cfg.num_shared
        for name, shape in (("ws_gate", (d_model, sf)),
                            ("ws_up", (d_model, sf)),
                            ("ws_down", (sf, d_model))):
            p[name] = init_param(shape, gen, **kw)
    return p


def route(params, xt: torch.Tensor, cfg: MoEConfig):
    """(scores (t, E) f32, top-k indices (t, k), normalized top-k weights):
    the top k by a stable descending sort, so equal scores go to the lower
    expert index as jax.lax.top_k's do (torch.topk promises no order)."""
    logits = xt.float() @ params["router"].float()
    if cfg.gate == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    topi = torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[:, :cfg.top_k]
    topw = torch.gather(scores, 1, topi)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return scores, topi, topw


def capacity_for(cfg: MoEConfig, t: int,
                 capacity: Optional[int] = None) -> int:
    """Slots an expert takes: `capacity`, or the capacity factor's share of
    the t * k routed slots (the reference's Python float arithmetic)."""
    return capacity or max(int(cfg.capacity_factor * t * cfg.top_k
                               / cfg.num_experts), 1)


def queue_positions(topi: torch.Tensor, e: int) -> torch.Tensor:
    """Each (token, k) slot's place in its expert's queue, in the flattened
    token-major (t * k) order."""
    flat = topi.reshape(-1)
    onehot = F.one_hot(flat, e).to(torch.int32)
    return (torch.cumsum(onehot, dim=0) - 1).gather(1, flat[:, None])[:, 0]


def apply_moe(params, x: torch.Tensor, cfg: MoEConfig, act: Callable, *,
              capacity: Optional[int] = None, full: bool = False):
    """x (b, s, d) -> (y (b, s, d) in x's dtype, aux_loss f32 scalar).
    `full` (serving): every routed slot is kept, the capacity being the
    routed token count (the reference's capacity=t).

    Under a serving mesh (nn/shard_ctx.py) the router is replicated and
    every rank routes every token, so the queue positions and the drops
    are the same on every rank; inside split_rows (a data rank's decode
    tick) the input is first gathered over the data axis, so the routing,
    the capacity and the drops are the whole batch's, and the rank keeps
    its rows of the output. The expert weights are this rank's contiguous
    range of E / m experts (experts_split; all of them otherwise) and the
    shared experts its d_ff shard (mlp_splits): the rank dispatches only
    its experts' slots, and the routed and shared partial sums go through
    one reduce_model."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    rows = None
    if shard_ctx.rows_split():
        n = xt.shape[0]
        rows = shard_ctx.data_rank() * n, n
        xt = shard_ctx.gather_data(xt, dim=0)
    t = xt.shape[0]
    e, k = cfg.num_experts, cfg.top_k

    scores, topi, topw = route(params, xt, cfg)

    # load-balancing auxiliary loss (Switch-style)
    density = F.one_hot(topi[:, 0], e).to(torch.float32).mean(0)
    router_prob = scores.mean(0)
    aux_loss = cfg.router_aux_weight * e * torch.sum(density * router_prob)

    c = t if full else capacity_for(cfg, t, capacity)
    flat = topi.reshape(-1)                               # (t*k,)
    pos = queue_positions(topi, e)
    keep = pos < c

    # this rank's experts [e0, e0 + el): all of them without a sharded
    # expert axis
    el = params["w_gate"].shape[0]
    e0 = shard_ctx.model_rank() * el if el != e else 0
    if el != e:
        keep = keep & (flat >= e0) & (flat < e0 + el)
    slot = (flat - e0) * c + torch.where(keep, pos, 0)    # (t*k,)

    # dispatch: scatter into (el*c, d); a dropped (or another rank's) slot
    # goes to the extra row el*c, which is cut off (the reference's
    # mode="drop")
    src = torch.repeat_interleave(xt, k, dim=0)           # (t*k, d)
    buf = torch.zeros((el * c + 1, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_add(0, torch.where(keep, slot, el * c), src)
    buf = buf[:el * c].reshape(el, c, d)

    # expert compute: batched products over the leading expert axis
    h = (act(torch.bmm(buf, params["w_gate"]))
         * torch.bmm(buf, params["w_up"]))
    out_buf = torch.bmm(h, params["w_down"]).reshape(el * c, d)

    # combine: gather each (token, k) slot back and weight
    gathered = out_buf[torch.where(keep, slot, 0)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    w = (topw.reshape(-1) * keep.to(topw.dtype)).to(gathered.dtype)

    if rows is not None:
        # this rank's rows of the output (and of the shared experts' input)
        gathered = gathered.reshape(t, k, d)[rows[0]:rows[0] + rows[1]]
        w = w.reshape(t, k)[rows[0]:rows[0] + rows[1]]
        xt = xt[rows[0]:rows[0] + rows[1]]
        t = rows[1]
    m = shard_ctx.model_size()
    shared_split = cfg.num_shared and params["ws_gate"].shape[1] != (
        cfg.d_ff * cfg.num_shared)
    if m == 1 or (el == e and not shared_split):
        # every term on this rank: the unsharded function
        yt = (gathered.reshape(t * k, d) * w.reshape(-1)[:, None]).reshape(
            t, k, d).sum(1)
        if cfg.num_shared:
            hs = act(xt @ params["ws_gate"]) * (xt @ params["ws_up"])
            yt = yt + hs @ params["ws_down"]
    else:
        # partial sums in f32: a replicated term counts on model rank 0
        lead = shard_ctx.model_rank() == 0
        yt = (gathered.reshape(t * k, d).float()
              * w.reshape(-1).float()[:, None]).reshape(t, k, d).sum(1)
        if el == e and not lead:
            yt = torch.zeros_like(yt)
        if cfg.num_shared and (shared_split or lead):
            hs = act(xt @ params["ws_gate"]) * (xt @ params["ws_up"])
            yt = yt + (shard_ctx.row_partial(hs, params["ws_down"])
                       if shared_split else hs @ params["ws_down"]).float()
        yt = shard_ctx.reduce_model(yt)
    return yt.reshape(b, s, d).to(x.dtype), aux_loss
