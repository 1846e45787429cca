"""Token sampling for continuous-batching decode (greedy in this slice).

Every slot carries its own SamplingParams; the engine packs them into
(slots,)-shaped arrays. temperature <= 0 means greedy. Sampled decoding
(temperature, top-k, top-p) is still to port: the reference derives its
draws from threefry keys, and matching or replacing that is ROADMAP A5.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch


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
    """SamplingParams packed per slot."""
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


def check_supported(sp: SamplingParams) -> None:
    if not sp.greedy:
        raise NotImplementedError(
            "sampled decoding (temperature > 0) is not ported yet: ROADMAP "
            "A5 (threefry-matched or schedule-invariant sampling)")


def sample(logits: torch.Tensor, sp: SamplerBatch) -> torch.Tensor:
    """One token per slot: logits (slots, vocab) -> (slots,) int64. Greedy
    picks the first maximal index (what jnp.argmax gives)."""
    if not bool(np.all(sp.greedy)):
        raise NotImplementedError("sampled decoding: ROADMAP A5")
    return torch.argmax(logits.float(), dim=-1)
