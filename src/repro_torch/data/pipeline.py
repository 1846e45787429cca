"""Deterministic, seekable synthetic data (the JAX package's
data/pipeline.py): LM token streams and images for the paper-table models.

No datasets are in the repository, so:
  * `TokenPipeline` — LM token streams with a Zipfian unigram distribution
    and a deterministic "grammar" (every 4th token a rolling function of the
    one before), so models have learnable structure;
  * `ImagePipeline` — class-conditional gaussian blobs shaped like
    MNIST/CIFAR images for the vision flow.

`batch(step)` is a pure function of (seed, step): each batch draws from its
own explicit `torch.Generator`, seeded from the pair, on the pipeline's
device, so a restart at step k replays the same stream. The generators of
torch and jax differ, so the data are of the same kind as the reference's,
not the same bits; `zipf_tokens` is the reference's transform of its base
draws, exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.models.lm import resolve_device

_MIX = 0x9E3779B97F4A7C15          # golden-ratio multiplier (splitmix64)


def batch_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed from (seed, step), mixed so that nearby pairs
    give unrelated streams (splitmix64's finalizer)."""
    z = (int(seed) * _MIX + int(step) + 1) % (1 << 64)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    return (z ^ (z >> 31)) >> 1


@dataclasses.dataclass(frozen=True)
class ImagePipeline:
    """Class-conditional gaussian-blob images (paper-benchmark stand-in):
    NHWC float32 images and int64 labels on `device` (default: CUDA, see
    models/lm.resolve_device)."""
    num_classes: int = 10
    hw: int = 32
    channels: int = 3
    global_batch: int = 128
    seed: int = 0
    device: Optional[str] = None

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        dev = resolve_device(self.device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(batch_seed(self.seed, step))
        b, hw, c = self.global_batch, self.hw, self.channels
        labels = torch.randint(0, self.num_classes, (b,), generator=gen,
                               device=dev)
        # per-class blob centre on a circle: linearly separable-ish
        ang = 2 * math.pi * labels.to(torch.float32) / self.num_classes
        cx = hw / 2 + (hw / 4) * torch.cos(ang)
        cy = hw / 2 + (hw / 4) * torch.sin(ang)
        yy, xx = torch.meshgrid(torch.arange(hw, device=dev),
                                torch.arange(hw, device=dev), indexing="ij")
        d2 = ((xx[None] - cx[:, None, None]) ** 2
              + (yy[None] - cy[:, None, None]) ** 2)
        img = torch.exp(-d2 / (2 * (hw / 8) ** 2))
        img = img[..., None].expand(b, hw, hw, c)
        noise = 0.3 * torch.randn((b, hw, hw, c), generator=gen, device=dev)
        return {"image": (img + noise).to(torch.float32), "label": labels}


def zipf_tokens(u: torch.Tensor, vocab_size: int,
                zipf_a: float = 1.2) -> torch.Tensor:
    """The reference TokenPipeline's tokens from its base draws u (b, s + 1)
    in [1e-6, 1), as int64: a Zipf-ish marginal floor(min(u^(-1/a) - 1,
    v - 1)) in f32, then every 4th position (index % 4 == 3) replaced by
    (tok + 31 * previous tok) % v, the previous token taken before the
    replacement and rolled cyclically (position 0 reads the last)."""
    base = torch.clamp(u.float() ** (-1.0 / zipf_a) - 1.0,
                       max=float(vocab_size - 1))
    toks = base.to(torch.int64)
    rolled = (toks + torch.roll(toks, 1, dims=1) * 31) % vocab_size
    mask = torch.arange(u.shape[1], device=u.device) % 4 == 3
    return torch.where(mask[None, :], rolled, toks)


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """LM batches {"tokens", "labels"} (b, s) int64 on `device` (default:
    CUDA, see models/lm.resolve_device); labels are the tokens shifted by
    one."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    device: Optional[str] = None

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure function of step — the seek point for restart."""
        dev = resolve_device(self.device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(batch_seed(self.seed, step))
        u = torch.rand((self.global_batch, self.seq_len + 1), generator=gen,
                       device=dev)
        u = 1e-6 + (1.0 - 1e-6) * u
        toks = zipf_tokens(u, self.vocab_size, self.zipf_a)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_lm_batch_for(cfg, shape, step: int, *, seed: int = 0,
                      device=None) -> Dict[str, torch.Tensor]:
    """A train batch for an arch config at a ShapeSpec. The reference adds
    encoder-frame and patch-embedding stubs for Whisper and LLaVA; those
    architectures (and their config fields) are not ported, so the batch
    is text only."""
    return TokenPipeline(cfg.vocab_size, shape.seq_len, shape.global_batch,
                         seed=seed, device=device).batch(step)
