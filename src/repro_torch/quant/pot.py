"""Power-of-two scale arithmetic shared by every packed-integer datapath.

The KV pools (quant/kv.py) and the weight planes (quant/weights.py) store
int8 words — one value per byte at 8 bits, two split-halves nibbles per byte
at 4 bits — scaled by a per-group exponent ``e``, so a stored ``q`` stands
for ``q * 2**e``. Dequantization is an exponent add, never a multiply by an
arbitrary calibrated scale. The port keeps the JAX package's arithmetic bit
for bit (the tests hold every byte to it):

* ``exp2i`` constructs 2^e from the f32 exponent field by bits, never by
  ``torch.exp2``/``ldexp`` on a float, so every dequantized value is exact.
* ``pot_exponent`` reads the exponent of ``frexp`` and clips it to
  ``EXP_EMPTY``: the clip also hides that frexp implementations disagree by
  one on subnormals.
* int4 packing is split-halves along the packed axis: byte ``i`` holds
  element ``i`` (low nibble) and ``i + n//2`` (high nibble), so unpacking is
  a sign-extend + concat, never an interleave.
"""
from __future__ import annotations

import torch

# exponent-plane init: below any write-time exponent, so the first write
# always sets the scale; 2.0**EXP_EMPTY is still a normal f32, so
# dequantizing never-written storage stays finite
EXP_EMPTY = -126


def pot_qmax(bits: int) -> int:
    """Symmetric integer range +/- (2^(bits-1) - 1)."""
    return (1 << (bits - 1)) - 1


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e (f32) for integer e in [-126, 126], built by bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def pot_exponent(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """Smallest exponent e with amax representable as q * 2^e (int8):
    frexp's f (amax = m * 2^f, m in [0.5, 1)) minus (bits - 1), clipped to
    [EXP_EMPTY, 126]."""
    _, f = torch.frexp(amax.to(torch.float32))
    e = f.to(torch.int32) - (bits - 1)
    return torch.clamp(e, EXP_EMPTY, 126).to(torch.int8)


def quantize_pot(x: torch.Tensor, e: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric round-half-even onto the 2^e grid -> int8 (unpacked)."""
    qmax = pot_qmax(bits)
    s = exp2i(-e.to(torch.int32))
    q = torch.clamp(torch.round(x.to(torch.float32) * s), -qmax, qmax)
    return q.to(torch.int8)


def dequantize_pot(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """q * 2^e in f32 (an exact exponent add)."""
    return q.to(torch.float32) * exp2i(e)


def requant_shift(q: torch.Tensor, delta: torch.Tensor, bits: int
                  ) -> torch.Tensor:
    """Re-express stored integers at an exponent raised by ``delta`` >= 0:
    a rounding (half-up) arithmetic right shift in int32, shift count
    clamped to 31, clipped back to the symmetric range."""
    qmax = pot_qmax(bits)
    d = torch.clamp(delta.to(torch.int32), max=31)
    q32 = q.to(torch.int32)
    half = torch.ones_like(d) << torch.clamp(d - 1, min=0)
    shifted = torch.where(d > 0, (q32 + half) >> d, q32)
    return torch.clamp(shifted, -qmax, qmax).to(torch.int8)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., n) int8 nibbles -> (..., n//2) packed bytes: byte i = element i
    (low nibble) | element i + n//2 (high nibble)."""
    n = q.shape[-1]
    u = q.contiguous().view(torch.uint8)
    lo = u[..., : n // 2] & 0xF
    hi = u[..., n // 2:] & 0xF
    return (lo | (hi << 4)).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """(..., n//2) packed bytes -> (..., n) sign-extended int8: the low
    nibble is (p << 4) >> 4 and the high one p >> 4, both in int8."""
    p8 = p.contiguous()
    lo = (p8.view(torch.uint8) << 4).view(torch.int8) >> 4
    hi = p8 >> 4
    return torch.cat([lo, hi], dim=-1)
