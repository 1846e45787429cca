"""Assigned input shapes and the per-(arch x shape) applicability matrix
(the JAX package's configs/shapes.py)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.archs import ARCHS, get_config


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_status(arch: str, shape: str) -> Optional[str]:
    """None = runnable; otherwise the reason the cell is skipped."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.supports_long_context:
        return ("skip: pure quadratic full-attention arch; 500k dense KV decode "
                "is out of scope per assignment (see DESIGN.md §Arch-applicability)")
    if cfg.encoder is not None and shape == "long_500k":
        return "skip: whisper decoder context is 448 tokens by construction"
    return None


def all_cells():
    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape, cell_status(arch, shape)
