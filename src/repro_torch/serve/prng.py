"""Threefry-2x32 counter-based random numbers, bit for bit as jax.random
draws them with `jax_threefry_partitionable` on (the default of JAX 0.9).

The serving engine's sampled decoding derives every draw from a key that is
a pure function of the request and its progress — `fold_in(fold_in(base,
rid & 0x7FFFFFFF), draws_so_far)` — so a sampled stream is the same under
any schedule (prefix-cache hits, chunked prefill, preemption). Reproducing
the reference's bits, not only its distribution, is what lets a stream be
checked (and, later, recovered) token for token.

A key is a (..., 2) int64 tensor holding two uint32 words (hi, lo). Torch
has no unsigned 32-bit arithmetic, so every word lives in int64 and is
masked to 32 bits after each add and shift; the same code runs on the CPU
and on the card, vectorised over a batch of keys (the reference's
`jax.vmap` over per-slot keys).

The functions and the JAX source they follow (jax/_src/prng.py, random.py):
  threefry_2x32   threefry2x32 (20 rounds, 5 key injections)
  prng_key        PRNGKey / threefry_seed: a 32-bit seed -> (0, seed)
  fold_in         threefry_2x32(key, threefry_seed(uint32(d)))
  random_bits     the partitionable 32-bit bits: counters (hi, lo) of each
                  element's flat index within one key's shape, bits1 ^ bits2
  uniform         mantissa fill: bits >> 9 | 0x3F800000, minus 1, scaled
  gumbel          the "low" mode: -log(-log(uniform(minval=tiny)))
  categorical     argmax(gumbel + logits)
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry_2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter pair (x0, x1) under the key (k0, k1):
    int64 tensors of uint32 words, broadcast together. Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as a (2,) int64 tensor. JAX takes the seed
    as a 32-bit integer (x64 off), whose high word is 0."""
    s = int(seed)
    if not -2 ** 31 <= s < 2 ** 32:
        raise ValueError(f"seed {s} does not fit 32 bits")
    return torch.tensor([0, s & M32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in` over a batch: keys (..., 2) and data (an int or
    an integer tensor, taken as uint32) broadcast; returns (..., 2)."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=keys.device)
    d = data.to(torch.int64) & M32
    y0, y1 = threefry_2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32 words in int64) for each key of
    `keys` (..., 2): returns (..., *shape). The counters index within one
    key's own shape, as the partitionable scheme does under vmap."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    batch = keys.shape[:-1]
    k0 = keys[..., 0].reshape(*batch, 1)
    k1 = keys[..., 1].reshape(*batch, 1)
    y0, y1 = threefry_2x32(k0, k1, idx >> 32, idx & M32)
    return (y0 ^ y1).reshape(*batch, *shape)


def uniform(bits: torch.Tensor, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 in [minval, maxval) from 32-bit words, as jax.random.uniform
    builds them: 23 mantissa bits under exponent 0, minus 1, scaled, then
    clamped below at minval."""
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.gumbel(key, shape, mode="low")` (f32) per key."""
    u = uniform(random_bits(keys, shape), minval=F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical` along the last axis: one key (2,) for the
    whole of `logits`, or one key per row (rows, 2) as under jax.vmap.
    Returns the int64 argmax of gumbel + logits (first maximal index)."""
    logits = logits.float()
    if keys.dim() == 1:
        g = gumbel(keys, logits.shape)
    else:
        g = gumbel(keys, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
