"""ModelConfig for all ten architectures: GQA or MLA decoders with dense or
Mixture-of-Experts MLPs, Mamba-2 (SSD) and hybrid stacks, Whisper's
encoder-decoder and LLaVA's vision-stub prefix.

The port's own frozen dataclasses, with the JAX package's field names and
values: [vision-stub patch embeddings +] embedding -> repeated groups of
decoder layers (each group a *period* of LayerSpecs repeated `repeats`
times) -> final norm -> LM head, plus an optional encoder stack whose output
the decoder's cross-attention layers read.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.nn.blocks import LayerSpec, MLAConfig
from repro_torch.nn.mamba2 import SSMConfig
from repro_torch.nn.moe import MoEConfig


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    num_layers: int
    num_frames: int = 1500        # whisper stub frontend output length


@dataclasses.dataclass(frozen=True)
class VisionStub:
    num_patches: int = 576        # anyres base tile for llava-next


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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStub] = None
    grau: Optional[GRAUConfig] = None
    # a sub-quadratic decode path exists (latent MLA cache, SSM state)
    supports_long_context: bool = False
    # zero-padded physical head counts (h_phys, kv_phys), so attention
    # shards over the model axis (launch/steps.pad_heads_for); the pads are
    # zero and inert, so the model computes the unpadded arch's function
    attn_pad: Optional[Tuple[int, int]] = None

    @property
    def heads_phys(self) -> int:
        return self.attn_pad[0] if self.attn_pad else self.num_heads

    @property
    def kv_heads_phys(self) -> int:
        return self.attn_pad[1] if self.attn_pad else self.num_kv_heads

    @property
    def num_layers(self) -> int:
        return sum(len(period) * reps for period, reps in self.groups)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_groups(n_layers: int, cross_attn: bool = False):
    return ((
        (LayerSpec(kind="attn", mlp="dense", cross_attn=cross_attn),),
        n_layers,
    ),)


def moe_groups(n_layers: int, first_dense: int = 0, period_moe: int = 1):
    """MoE stack: optional leading dense layers, then MoE every `period_moe`
    (the last layer of each period)."""
    groups = []
    if first_dense:
        groups.append(((LayerSpec("attn", "dense"),), first_dense))
    rest = n_layers - first_dense
    if period_moe == 1:
        groups.append(((LayerSpec("attn", "moe"),), rest))
    else:
        period = tuple(
            LayerSpec("attn", "moe" if (i % period_moe) == period_moe - 1
                      else "dense")
            for i in range(period_moe))
        assert rest % period_moe == 0
        groups.append((period, rest // period_moe))
    return tuple(groups)


def jamba_groups(n_layers: int, period_len: int = 8, attn_at: int = 4):
    """Jamba: one attention layer per `period_len` (1:7), MoE every other
    layer."""
    period = tuple(
        LayerSpec(kind="attn" if i == attn_at else "mamba",
                  mlp="moe" if i % 2 == 1 else "dense")
        for i in range(period_len))
    assert n_layers % period_len == 0
    return ((period, n_layers // period_len),)


def ssm_groups(n_layers: int):
    return (((LayerSpec(kind="mamba", mlp="none"),), n_layers),)
