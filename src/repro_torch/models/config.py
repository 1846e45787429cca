"""ModelConfig for the ported architectures (dense GQA decoders).

The port's own frozen dataclasses, with the JAX package's field names and
values: embedding -> repeated groups of decoder layers (each group a
*period* of LayerSpecs repeated `repeats` times) -> final norm -> LM head.
MoE, MLA, SSM, encoder and vision fields arrive with those layer kinds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.nn.blocks import LayerSpec


@dataclasses.dataclass(frozen=True)
class GRAUConfig:
    """GRAU approximation settings for the model's activation sites."""
    mode: str = "apot"            # "pot" | "apot"
    segments: int = 6
    num_exponents: int = 8
    out_bits: int = 8
    bias_mode: str = "lsq"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int
    groups: Tuple[Tuple[Tuple[LayerSpec, ...], int], ...]
    activation: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    grau: Optional[GRAUConfig] = None

    @property
    def num_layers(self) -> int:
        return sum(len(period) * reps for period, reps in self.groups)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_groups(n_layers: int):
    return (((LayerSpec(kind="attn", mlp="dense"),), n_layers),)
