"""Static-shape token sampling for continuous-batching decode.

Every slot carries its own SamplingParams; the engine packs them into
(slots,)-shaped arrays (rebuilt on activation, never per tick) so one call
serves a heterogeneous batch — greedy next to top-p next to top-k.

temperature <= 0 means greedy; top_k <= 0 disables top-k; top_p >= 1
disables nucleus filtering. Filters compose (top-k mask AND top-p mask).
Draws come from threefry keys (serve/prng.py), so a slot's token is the
reference's token for the same logits and key, bit for bit up to the last
ulp of `log` in the Gumbel noise.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.serve import prng

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode parameters (host-side, hashable)."""
    temperature: float = 0.0      # <= 0 -> greedy
    top_k: int = 0                # <= 0 -> off
    top_p: float = 1.0            # >= 1 -> off

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


class SamplerBatch(NamedTuple):
    """SamplingParams packed per slot (numpy arrays, or tensors on the
    logits' device)."""
    temperature: np.ndarray    # (slots,) f32
    top_k: np.ndarray          # (slots,) i32
    top_p: np.ndarray          # (slots,) f32
    greedy: np.ndarray         # (slots,) bool


def pack(params: Sequence[SamplingParams]) -> SamplerBatch:
    return SamplerBatch(
        temperature=np.array([p.temperature for p in params], np.float32),
        top_k=np.array([p.top_k for p in params], np.int32),
        top_p=np.array([p.top_p for p in params], np.float32),
        greedy=np.array([p.greedy for p in params], bool),
    )


def filter_logits(logits: torch.Tensor, sp: SamplerBatch) -> torch.Tensor:
    """The temperature-scaled logits (slots, vocab) f32 with every token
    outside the top-k and top-p sets at NEG_INF.

    One full-vocab descending sort is shared by the top-k threshold and the
    top-p cumulative cutoff; both reduce to per-slot value thresholds
    applied in token order, so ties never permute token identity."""
    dev = logits.device
    temperature, top_k, top_p = (torch.as_tensor(x, device=dev)
                                 for x in sp[:3])
    logits = logits.float()
    vocab = logits.shape[-1]
    temp = torch.clamp_min(temperature.float(), 1e-6)[:, None]
    scaled = logits / temp
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values

    # top-k: keep everything >= the k-th largest value
    top_k = top_k.long()
    k = torch.where(top_k > 0, top_k.clamp(1, vocab),
                    torch.full_like(top_k, vocab))
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    keep_k = scaled >= kth

    # top-p: keep the smallest prefix of the sorted distribution covering
    # p; the top token is always kept (top_p=0 must not empty the nucleus)
    e = torch.exp(sorted_desc - sorted_desc[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p.float().clamp(0.0, 1.0)[:, None]
    keep_sorted[:, 0] = True
    cutoff = torch.where(keep_sorted, sorted_desc,
                         torch.full_like(sorted_desc, float("inf"))
                         ).min(dim=-1).values
    keep_p = scaled >= cutoff[:, None]
    return torch.where(keep_k & keep_p, scaled,
                       torch.full_like(scaled, NEG_INF))


def sample(logits: torch.Tensor, sp: SamplerBatch,
           keys: torch.Tensor) -> torch.Tensor:
    """Draw one token per slot: logits (slots, vocab) -> (slots,) int64.

    Greedy slots take the first maximal logit; the others draw
    categorically from `filter_logits`. `keys` is one key (2,) for the
    whole batch or per-slot keys (slots, 2); the engine derives per-slot
    keys from the request's identity and its progress, never from the tick,
    so sampled streams do not depend on the schedule."""
    greedy = torch.as_tensor(sp.greedy, device=logits.device).bool()
    greedy_tok = torch.argmax(logits.float(), dim=-1)
    sampled = prng.categorical(keys, filter_logits(logits, sp))
    return torch.where(greedy, greedy_tok, sampled)
