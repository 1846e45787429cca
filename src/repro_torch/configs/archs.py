"""The ten architectures — exact full configs + reduced smoke configs, with
the JAX package's values (configs/archs.py there)."""
from __future__ import annotations

from repro_torch.models.config import (EncoderConfig, ModelConfig,
                                       VisionStub, dense_groups, jamba_groups,
                                       moe_groups, ssm_groups)
from repro_torch.nn.blocks import MLAConfig
from repro_torch.nn.mamba2 import SSMConfig
from repro_torch.nn.moe import MoEConfig


# ---------------------------------------------------------------------------
# [hybrid] jamba-v0.1-52b — Mamba+attn 1:7 interleave, MoE 16e top-2
# ---------------------------------------------------------------------------

def jamba_v0_1_52b() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=65536,
        groups=jamba_groups(32, period_len=8, attn_at=4),
        activation="silu",
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336),
        # Jamba v0.1 uses Mamba-1; the SSD (Mamba-2) block stands in with
        # Jamba's state size, as in the reference
        ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk=256),
        supports_long_context=True,
    )


def jamba_smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        groups=jamba_groups(8, period_len=8, attn_at=4),
        activation="silu",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=256),
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk=64),
        supports_long_context=True,
    )


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


# ---------------------------------------------------------------------------
# [dense] glm4-9b — GQA kv=2 (a 16-query-head group), untied head
# ---------------------------------------------------------------------------

def glm4_9b() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        d_model=4096, num_heads=32, num_kv_heads=2, head_dim=128,
        d_ff=13696, vocab_size=151552,
        groups=dense_groups(40),
        activation="silu",
    )


def glm4_smoke() -> ModelConfig:
    return ModelConfig(
        name="glm4-smoke",
        d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512,
        groups=dense_groups(2),
        activation="silu",
    )


# ---------------------------------------------------------------------------
# [dense] qwen1.5-32b — QKV bias, MHA (kv=40), untied head
# ---------------------------------------------------------------------------

def qwen1_5_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        d_model=5120, num_heads=40, num_kv_heads=40, head_dim=128,
        d_ff=27392, vocab_size=152064,
        groups=dense_groups(64),
        activation="silu", qkv_bias=True,
    )


def qwen_smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke",
        d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        groups=dense_groups(2),
        activation="silu", qkv_bias=True,
    )


# ---------------------------------------------------------------------------
# [ssm] mamba2-1.3b — attention-free SSD
# ---------------------------------------------------------------------------

def mamba2_1_3b() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        d_model=2048, num_heads=1, num_kv_heads=1, head_dim=64,
        d_ff=0, vocab_size=50280,
        groups=ssm_groups(48),
        activation="silu", tie_embeddings=True,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
        supports_long_context=True,
    )


def mamba2_smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        d_model=128, num_heads=1, num_kv_heads=1, head_dim=32,
        d_ff=0, vocab_size=512,
        groups=ssm_groups(2),
        activation="silu", tie_embeddings=True,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk=64),
        supports_long_context=True,
    )


# ---------------------------------------------------------------------------
# [audio] whisper-medium — enc-dec backbone, conv frontend stubbed
# ---------------------------------------------------------------------------

def whisper_medium() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=4096, vocab_size=51865,
        groups=dense_groups(24, cross_attn=True),
        activation="gelu", gated_mlp=False, norm="layernorm", norm_eps=1e-5,
        tie_embeddings=True,
        encoder=EncoderConfig(num_layers=24, num_frames=1500),
    )


def whisper_smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        groups=dense_groups(2, cross_attn=True),
        activation="gelu", gated_mlp=False, norm="layernorm", norm_eps=1e-5,
        tie_embeddings=True,
        encoder=EncoderConfig(num_layers=2, num_frames=64),
    )


# ---------------------------------------------------------------------------
# [vlm] llava-next-mistral-7b — anyres tiling stubbed to patch embeddings
# ---------------------------------------------------------------------------

def llava_next_mistral_7b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=32000,
        groups=dense_groups(32),
        activation="silu",
        vision=VisionStub(num_patches=576),
    )


def llava_smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-smoke",
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        groups=dense_groups(2),
        activation="silu",
        vision=VisionStub(num_patches=16),
    )


# ---------------------------------------------------------------------------
# [moe] llama4-maverick-400b-a17b — 128e top-1, MoE every other layer,
# shared expert; dense interleave d_ff = 2 x expert d_ff
# ---------------------------------------------------------------------------

def llama4_maverick_400b() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=202048,
        groups=moe_groups(48, first_dense=0, period_moe=2),
        activation="silu",
        moe=MoEConfig(num_experts=128, top_k=1, d_ff=8192, num_shared=1),
    )


def llama4_smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke",
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512,
        groups=moe_groups(2, first_dense=0, period_moe=2),
        activation="silu",
        moe=MoEConfig(num_experts=4, top_k=1, d_ff=256, num_shared=1),
    )


# ---------------------------------------------------------------------------
# [moe] deepseek-v3-671b — MLA, 1 shared + 256 routed top-8, sigmoid gate
# ---------------------------------------------------------------------------

def deepseek_v3_671b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        d_model=7168, num_heads=128, num_kv_heads=128, head_dim=192,
        d_ff=18432, vocab_size=129280,
        groups=moe_groups(61, first_dense=3, period_moe=1),
        activation="silu",
        moe=MoEConfig(num_experts=256, top_k=8, d_ff=2048, num_shared=1,
                      gate="sigmoid"),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        supports_long_context=True,   # latent (576/token) cache decode
    )


def deepseek_smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke",
        d_model=128, num_heads=4, num_kv_heads=4, head_dim=48,
        d_ff=256, vocab_size=512,
        groups=moe_groups(3, first_dense=1, period_moe=1),
        activation="silu",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=64, num_shared=1,
                      gate="sigmoid"),
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                      qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32),
        supports_long_context=True,
    )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCHS = {
    "jamba-v0.1-52b": (jamba_v0_1_52b, jamba_smoke),
    "gemma-7b": (gemma_7b, gemma_smoke),
    "llama3.2-3b": (llama3_2_3b, llama3_smoke),
    "glm4-9b": (glm4_9b, glm4_smoke),
    "qwen1.5-32b": (qwen1_5_32b, qwen_smoke),
    "mamba2-1.3b": (mamba2_1_3b, mamba2_smoke),
    "whisper-medium": (whisper_medium, whisper_smoke),
    "llava-next-mistral-7b": (llava_next_mistral_7b, llava_smoke),
    "llama4-maverick-400b-a17b": (llama4_maverick_400b, llama4_smoke),
    "deepseek-v3-671b": (deepseek_v3_671b, deepseek_smoke),
}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    full, small = ARCHS[arch]
    return small() if smoke else full()
