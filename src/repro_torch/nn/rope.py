"""Rotary position embeddings (half-rotation convention, llama-style).

`rope_tables` builds the cos/sin tables for a set of positions once, so a
forward pass shares them across layers and across q and k; `apply_rope` is
the one-call form.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., seq) -> (cos, sin), each (..., seq, 1, head_dim/2)."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim) rotated by precomputed tables."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))
