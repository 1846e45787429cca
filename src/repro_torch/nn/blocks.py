"""Decoder-layer assembly for dense GQA layers: full-sequence (training) or
paged attention + gated MLP.

A layer is described by a LayerSpec(kind, mlp). This slice of the port
serves kind="attn" with mlp="dense" (the dense GQA decoders); MoE, Mamba-2
and MLA layers are still to be ported (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.nn import attention as attn_lib
from repro_torch.nn.attention import AnyPagedKVCache, PagedState
from repro_torch.nn.common import init_param, layernorm, rmsnorm
from repro_torch.nn.rope import rotate
from repro_torch.quant import weights as wq_lib


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"        # "attn" ("mamba" still to port)
    mlp: str = "dense"        # "dense" ("moe" / "none" still to port)
    cross_attn: bool = False  # whisper decoder (still to port)


# ---------------------------------------------------------------------------
# Norm dispatch
# ---------------------------------------------------------------------------

def init_norm(params: dict, name: str, dim: int, kind: str, *, device,
              dtype) -> None:
    if kind == "rmsnorm":
        params[f"{name}_w"] = init_param((dim,), None, init="zeros",
                                         device=device, dtype=dtype)
    else:
        params[f"{name}_w"] = init_param((dim,), None, init="ones",
                                         device=device, dtype=dtype)
        params[f"{name}_b"] = init_param((dim,), None, init="zeros",
                                         device=device, dtype=dtype)


def apply_norm(params, name: str, x, kind: str, eps: float):
    if kind == "rmsnorm":
        return rmsnorm(x, params[f"{name}_w"], eps)
    return layernorm(x, params[f"{name}_w"], params[f"{name}_b"], eps)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(cfg, gen: torch.Generator, *, device, dtype) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p = {name: init_param(shape, gen, device=device, dtype=dtype)
         for name, shape in (("wq", (d, h, hd)), ("wk", (d, kv, hd)),
                             ("wv", (d, kv, hd)), ("wo", (h, hd, d)))}
    if cfg.qkv_bias:
        for name, shape in (("bq", (h, hd)), ("bk", (kv, hd)),
                            ("bv", (kv, hd))):
            p[name] = init_param(shape, gen, init="zeros", device=device,
                                 dtype=dtype)
    return p


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one (b*s, d) x (d, h*k) matrix product.
    A packed projection is dequantized first (wq_lib.dense, as the
    reference's _qkv does), in x's dtype: the values are exact in bf16."""
    w = wq_lib.dense(w, x.dtype)
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(
        b, s, w.shape[1], w.shape[2])


def _out(o, wo):
    """einsum("bshk,hkd->bsd") as one matrix product (packed wo through
    wq_lib.dense)."""
    wo = wq_lib.dense(wo, o.dtype)
    b, s, h, k = o.shape
    return (o.reshape(b * s, h * k) @ wo.reshape(h * k, -1)).reshape(b, s, -1)


def _qkv(params, x, cfg):
    q, k, v = (_proj(x, params["wq"]), _proj(x, params["wk"]),
               _proj(x, params["wv"]))
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return q, k, v


def _rope_qk(q, k, rope):
    """Rotate q and k in one pass with the shared (cos, sin) tables."""
    qk = rotate(torch.cat([q, k], dim=2), *rope)
    q, k = qk.split([q.shape[2], k.shape[2]], dim=2)
    return q.contiguous(), k


def apply_attention(params, x, cfg, *, rope, causal: bool = True,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    attn_impl: str = "kernel") -> torch.Tensor:
    """Training path (full sequence, no cache): x (b, s, d) -> (b, s, d).
    `rope` holds the (cos, sin) tables at positions [0, s); attention is
    nn/attention.chunked_attention (the flash kernel on the card with
    attn_impl="kernel", the plain scan with "plain")."""
    q, k, v = _qkv(params, x, cfg)
    q, k = _rope_qk(q, k, rope)
    o = attn_lib.chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk, impl=attn_impl)
    return _out(o, params["wo"])


def decode_attention_block(
    params, x, cfg, *, rope, cache: AnyPagedKVCache, paged: PagedState,
    paged_impl: str = "kernel", attn_quant=None,
) -> Tuple[torch.Tensor, AnyPagedKVCache]:
    """One-token decode through the paged pool. x: (b, 1, d); `rope` holds
    the (cos, sin) tables at positions paged.length (nn/rope.rope_tables).

    The new position is written through the block table, then attention
    runs over the mapped blocks via the CUDA decode kernel
    (paged_impl="kernel") or the gathered dense view ("gather");
    `attn_quant` fuses the GRAU output epilogue on either path."""
    q, k, v = _qkv(params, x, cfg)
    q, k = _rope_qk(q, k, rope)
    cache = attn_lib.paged_update(cache, k, v, paged)
    o = attn_lib.paged_decode_attention(q, cache, paged, impl=paged_impl,
                                        quant=attn_quant)
    return _out(o, params["wo"]), cache


def paged_prefill_attention_block(
    params, x, cfg, *, rope, cache: AnyPagedKVCache, paged: PagedState,
    paged_impl: str = "kernel", attn_quant=None,
) -> Tuple[torch.Tensor, AnyPagedKVCache]:
    """One prefill chunk through the paged pool. x: (b, C, d); `rope`
    holds the (cos, sin) tables at the chunk's absolute positions
    paged.length + [0, C).

    The chunk's K/V are scattered into the pool through the block table
    first, then multi-query attention runs over the already-written prefix
    blocks plus the chunk itself (write-then-attend, like decode)."""
    q, k, v = _qkv(params, x, cfg)
    q, k = _rope_qk(q, k, rope)
    cache = attn_lib.paged_prefill_update(cache, k, v, paged)
    o = attn_lib.paged_prefill_attention(q, cache, paged, impl=paged_impl,
                                         quant=attn_quant)
    return _out(o, params["wo"]), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(d_model: int, d_ff: int, gated: bool, gen: torch.Generator, *,
             device, dtype) -> dict:
    p = {}
    if gated:
        p["w_gate"] = init_param((d_model, d_ff), gen, device=device,
                                 dtype=dtype)
    p["w_up"] = init_param((d_model, d_ff), gen, device=device, dtype=dtype)
    p["w_down"] = init_param((d_ff, d_model), gen, device=device, dtype=dtype)
    return p


def apply_mlp(params, x, act: Callable, gated: bool = True):
    """The MLP through wq_lib.matmul: plain `@` on float weights; packed
    2-D weights go to the matmul_wq kernel (its plain version on the
    CPU)."""
    if gated:
        h = (act(wq_lib.matmul(x, params["w_gate"]))
             * wq_lib.matmul(x, params["w_up"]))
    else:
        h = act(wq_lib.matmul(x, params["w_up"]))
    return wq_lib.matmul(h, params["w_down"])


# ---------------------------------------------------------------------------
# Full decoder layer
# ---------------------------------------------------------------------------

def init_layer(spec: LayerSpec, cfg, gen: torch.Generator, *, device,
               dtype) -> dict:
    _check_spec(spec)
    p: dict = {}
    init_norm(p, "ln1", cfg.d_model, cfg.norm, device=device, dtype=dtype)
    p["attn"] = init_attention(cfg, gen, device=device, dtype=dtype)
    init_norm(p, "ln2", cfg.d_model, cfg.norm, device=device, dtype=dtype)
    p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.gated_mlp, gen,
                        device=device, dtype=dtype)
    return p


def _check_spec(spec: LayerSpec) -> None:
    if spec.kind != "attn" or spec.mlp != "dense" or spec.cross_attn:
        raise NotImplementedError(
            f"{spec}: only dense attention layers are ported (ROADMAP A9)")


def apply_layer(
    params, x, spec: LayerSpec, cfg, *, rope, act: Callable,
    cache: Optional[AnyPagedKVCache] = None, mode: str = "train",
    paged: Optional[PagedState] = None, paged_impl: str = "kernel",
    attn_quant=None, q_chunk: int = 1024, kv_chunk: int = 1024,
    attn_impl: str = "kernel",
) -> Tuple[torch.Tensor, Optional[AnyPagedKVCache]]:
    """One dense decoder layer in "train" mode (the full sequence, no
    cache), "decode" or paged "prefill" mode, with the (cos, sin) rope
    tables of its positions. Returns (x, cache); the pool is updated in
    place."""
    _check_spec(spec)
    h = apply_norm(params, "ln1", x, cfg.norm, cfg.norm_eps)
    if mode == "train":
        a = apply_attention(params["attn"], h, cfg, rope=rope,
                            q_chunk=q_chunk, kv_chunk=kv_chunk,
                            attn_impl=attn_impl)
    elif mode == "decode":
        a, cache = decode_attention_block(params["attn"], h, cfg, rope=rope,
                                          cache=cache, paged=paged,
                                          paged_impl=paged_impl,
                                          attn_quant=attn_quant)
    elif mode == "prefill":
        a, cache = paged_prefill_attention_block(
            params["attn"], h, cfg, rope=rope, cache=cache,
            paged=paged, paged_impl=paged_impl, attn_quant=attn_quant)
    else:
        raise NotImplementedError(f"mode {mode!r}: the dense-cache prefill "
                                  "is not ported (ROADMAP)")
    x = x + a
    h = apply_norm(params, "ln2", x, cfg.norm, cfg.norm_eps)
    return x + apply_mlp(params["mlp"], h, act, cfg.gated_mlp), cache
