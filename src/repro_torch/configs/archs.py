"""The ported architectures — exact full configs + reduced smoke configs,
with the JAX package's values (configs/archs.py there)."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig, dense_groups


# ---------------------------------------------------------------------------
# [dense] gemma-7b — GeGLU, head_dim=256
# ---------------------------------------------------------------------------

def gemma_7b() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
        d_ff=24576, vocab_size=256000,
        groups=dense_groups(28),
        activation="gelu", gated_mlp=True, tie_embeddings=True,
    )


def gemma_smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke",
        d_model=128, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512,
        groups=dense_groups(2),
        activation="gelu", gated_mlp=True, tie_embeddings=True,
    )


# ---------------------------------------------------------------------------
# [dense] llama3.2-3b
# ---------------------------------------------------------------------------

def llama3_2_3b() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=128256,
        groups=dense_groups(28),
        activation="silu", rope_theta=500000.0, tie_embeddings=True,
    )


def llama3_smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke",
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        groups=dense_groups(2),
        activation="silu", rope_theta=500000.0, tie_embeddings=True,
    )


ARCHS = {
    "gemma-7b": (gemma_7b, gemma_smoke),
    "llama3.2-3b": (llama3_2_3b, llama3_smoke),
}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    full, small = ARCHS[arch]
    return small() if smoke else full()
