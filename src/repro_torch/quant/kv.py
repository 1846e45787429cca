"""Packed KV-pool quantization with power-of-two scales.

Quantized pools (nn/attention.QuantPagedKVCache) store K/V as int8 words —
one value per byte at kv_bits=8, two split-halves nibbles per byte at
kv_bits=4 (byte i of a position row holds head-dim element i low and
i + head_dim/2 high) — plus one signed-byte exponent per (block, kv_head)
per tensor. The scale arithmetic is quant/pot.py's; this module keeps the
block store/load and the head-dim packing checks of the JAX package's
quant/kv.py.

Exponents are set at write time (whole-block prefill stores, exponent bumps
on decode writes, nn/attention.py); readers never re-derive them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.quant.pot import (EXP_EMPTY, dequantize_pot, exp2i,  # noqa: F401
                                   pack_int4, pot_exponent, pot_qmax,
                                   quantize_pot, requant_shift, unpack_int4)

KV_BITS = (16, 8, 4)


def kv_qmax(bits: int) -> int:
    return pot_qmax(bits)


def validate_kv_bits(bits: int) -> None:
    if bits not in KV_BITS:
        raise ValueError(f"kv_bits must be one of {KV_BITS}, got {bits}")


def packed_head_dim(head_dim: int, bits: int) -> int:
    """Storage width of the head_dim axis (two nibbles per byte at 4-bit)."""
    validate_kv_bits(bits)
    if bits == 4:
        if head_dim % 2:
            raise ValueError(
                f"kv_bits=4 packs two values per byte along head_dim; "
                f"head_dim={head_dim} is odd — pad the model's head_dim to "
                "an even value or use kv_bits >= 8")
        return head_dim // 2
    return head_dim


def store_block(x: torch.Tensor, bits: int,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize whole pool blocks (..., positions, kv_heads, head_dim) ->
    (packed payload, per-head exponent (..., kv_heads)). `valid`
    ((..., positions) bool) keeps rows past the prompt (chunk padding) out
    of the exponent's amax; those rows are still quantized (clipped)."""
    ax = x.to(torch.float32).abs()
    if valid is not None:
        ax = torch.where(valid[..., None, None], ax, 0.0)
    amax = ax.amax(dim=(-3, -1))
    e = pot_exponent(amax, bits)
    q = quantize_pot(x, e[..., None, :, None], bits)
    return (pack_int4(q) if bits == 4 else q), e


def load_block(payload: torch.Tensor, e: torch.Tensor, bits: int
               ) -> torch.Tensor:
    """Inverse of store_block: packed payload + exponent -> f32 block."""
    q = unpack_int4(payload) if bits == 4 else payload
    return dequantize_pot(q, e[..., None, :, None])
