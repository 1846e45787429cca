"""AdamW + schedules over parameter trees (the JAX package's train/optim.py).

Moments are f32 on the parameters' device. Each leaf is updated in f32 and
cast back to its dtype; gradients are clipped by their global norm; weight
decay applies to every leaf, as in the reference. Where the reference
donates the parameter and moment buffers to its jitted step, the port
updates them in place (at llama3.2-3b a second copy of the bf16 parameters
would be 6.4 GB), and returns them so call sites read the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.nn.common import tree_flatten, tree_map


class OptState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio, in f32 from the int
    step (as the reference divides its int32 step)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * warm * frac


def init_opt_state(params) -> OptState:
    leaves = [p for _, p in tree_flatten(params)]
    dev = leaves[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for _, x in tree_flatten(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step. `params`, `state.m` and `state.v` are updated in
    place (see the module note) and returned with the new step count."""
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        p32 = p.to(torch.float32)
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(p32, alpha=cfg.weight_decay)
        p.copy_(p32.sub_(delta.mul_(lr)))

    for (_, p), (_, g), (_, m), (_, v) in zip(
            tree_flatten(params), tree_flatten(grads),
            tree_flatten(state.m), tree_flatten(state.v)):
        upd(p, g, m, v)
    return params, OptState(step, state.m, state.v), {"lr": lr,
                                                       "grad_norm": gnorm}
