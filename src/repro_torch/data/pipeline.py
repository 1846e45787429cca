"""Deterministic, seekable synthetic image batches for the paper-table
models (the JAX package's data/pipeline.py::ImagePipeline).

No image datasets are in the repository, so the vision flow trains and
evaluates on class-conditional gaussian blobs shaped like MNIST/CIFAR
images. `batch(step)` is a pure function of (seed, step): each batch draws
from its own explicit `torch.Generator`, seeded from the pair, on the
pipeline's device, so a restart at step k replays the same stream. The
generators of torch and jax differ, so the images are of the same kind as
the reference's, not the same bits.
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
