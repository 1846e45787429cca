"""Decoder-layer assembly: attention (GQA or MLA) or a Mamba-2 block, an
optional cross-attention over the encoder's output (Whisper's decoder), then
a gated MLP, a Mixture-of-Experts or no MLP.

A layer is described by a LayerSpec(kind, mlp, cross_attn): kind in
{"attn", "mamba"}, mlp in {"dense", "moe", "none"}. Heterogeneous stacks
(jamba 1:7, deepseek 3-dense-then-MoE) are repeated *periods* of LayerSpecs
(models/lm.py). Each layer runs in "train" mode (the full sequence, no
cache), "prefill" (the full prompt into a dense cache, or one chunk into the
paged pool) or "decode" (one token over a dense cache or the paged pool).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.nn import attention as attn_lib
from repro_torch.nn import shard_ctx
from repro_torch.nn.attention import (AnyPagedKVCache, CrossKV, KVCache,
                                      MLACache, PagedState)
from repro_torch.nn.common import init_param, layernorm, rmsnorm
from repro_torch.nn.mamba2 import apply_mamba2, decode_mamba2, init_mamba2
from repro_torch.nn.moe import apply_moe, init_moe
from repro_torch.nn.rope import rotate
from repro_torch.quant import weights as wq_lib


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"        # "attn" | "mamba"
    mlp: str = "dense"        # "dense" | "moe" | "none"
    cross_attn: bool = False  # whisper decoder


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
    """wq/wk/wv/wo (and the qkv biases) at the physical head counts
    (cfg.heads_phys / kv_heads_phys); padded heads are zeroed, so the pad
    is inert (see ModelConfig.attn_pad)."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.heads_phys, cfg.kv_heads_phys
    p = {name: init_param(shape, gen, device=device, dtype=dtype)
         for name, shape in (("wq", (d, h, hd)), ("wk", (d, kv, hd)),
                             ("wv", (d, kv, hd)), ("wo", (h, hd, d)))}
    if cfg.attn_pad is not None:
        hl, kvl = cfg.num_heads, cfg.num_kv_heads
        p["wq"][:, hl:] = 0
        p["wk"][:, kvl:] = 0
        p["wv"][:, kvl:] = 0
        p["wo"][hl:] = 0
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


def _out(o, wo, reduce: bool = True):
    """einsum("bshk,hkd->bsd") as one matrix product (packed wo through
    wq_lib.dense). Under a serving mesh o holds this rank's heads and wo
    their rows: the partial products are summed over the model axis
    (unless `reduce` is False: heads the mesh replicates)."""
    wo = wq_lib.dense(wo, o.dtype)
    b, s, h, k = o.shape
    a, w = o.reshape(b * s, h * k), wo.reshape(h * k, -1)
    if shard_ctx.active_mesh() is None or not reduce:
        return (a @ w).reshape(b, s, -1)
    return shard_ctx.reduce_model(shard_ctx.row_partial(a, w)).to(
        o.dtype).reshape(b, s, -1)


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


def apply_attention(params, x, cfg, *, rope,
                    cache: Union[KVCache, CrossKV, None] = None,
                    kv_source: Optional[torch.Tensor] = None,
                    causal: bool = True, q_chunk: int = 1024,
                    kv_chunk: int = 1024, attn_impl: str = "kernel"
                    ) -> Tuple[torch.Tensor, Any]:
    """Training / dense-prefill path over the full sequence: x (b, s, d) ->
    ((b, s, d), cache). `rope` holds the (cos, sin) tables at positions [0,
    s); with `kv_source` (cross-attention) k and v come from it, without
    rope and without the causal mask. Attention is
    nn/attention.chunked_attention (the flash kernel on the card with
    attn_impl="kernel", the plain scan with "plain"). With `cache`
    (prefill) the k and v are written at positions [0, s) in place and a
    KVCache's length set to s; a CrossKV takes the projected encoder K/V
    whole (with the bias where a config sets qkv_bias, which no registered
    enc-dec arch does; the reference's cross cache leaves it out)."""
    # the projections are column-parallel over heads under a mesh
    x = shard_ctx.enter_model(x)
    src = x if kv_source is None else shard_ctx.enter_model(kv_source)
    q, k, v = (_proj(x, params["wq"]), _proj(src, params["wk"]),
               _proj(src, params["wv"]))
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if kv_source is None:
        q, k = _rope_qk(q, k, rope)
    o = attn_lib.chunked_attention(
        q, k, v, causal=causal and kv_source is None, q_chunk=q_chunk,
        kv_chunk=kv_chunk, impl=attn_impl)
    if cache is not None:
        s = k.shape[1]
        cache.k[:, :s] = k.to(cache.k.dtype)
        cache.v[:, :s] = v.to(cache.v.dtype)
        if isinstance(cache, KVCache):
            cache.length.fill_(s)
    return _out(o, params["wo"]), cache


def decode_attention_block(
    params, x, cfg, *, rope, cache, paged: Optional[PagedState] = None,
    paged_impl: str = "kernel", attn_quant=None,
) -> Tuple[torch.Tensor, Any]:
    """One-token decode. x: (b, 1, d); `rope` holds the (cos, sin) tables
    at each row's position (nn/rope.rope_tables).

    With `paged`, `cache` is a paged pool: the new position is written
    through the block table, then attention runs over the mapped blocks via
    the CUDA decode kernel (paged_impl="kernel") or the gathered dense view
    ("gather"); `attn_quant` fuses the GRAU output epilogue on either path.
    Under shard_ctx.record_writes (a data rank's decode) the write is the
    exact one (nn/attention._write_slots) and is also logged for the
    gathered write-back.
    Without it, `cache` is a dense KVCache: the position is written at each
    row's `length` (in place, length += 1) and attention runs over the
    whole buffer masked beyond it (the reference's plain decode)."""
    q, k, v = _qkv(params, x, cfg)
    q, k = _rope_qk(q, k, rope)
    if paged is None:
        cache = attn_lib.update_cache(cache, k, v)
        return _out(attn_lib.decode_attention(q, cache), params["wo"]), cache
    log = shard_ctx.write_log()
    cache = attn_lib.paged_update(cache, k, v, paged, exact=log is not None)
    if log is not None:         # a data rank: lm.decode_step writes back
        log.append((cache, k, v))
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
# MLA attention (deepseek-v3)
# ---------------------------------------------------------------------------

def init_mla(cfg, gen: torch.Generator, *, device, dtype) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    m: MLAConfig = cfg.mla
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    kw = dict(device=device, dtype=dtype)
    return {
        "wq_a": init_param((d, m.q_lora_rank), gen, **kw),
        "q_norm_w": init_param((m.q_lora_rank,), None, init="zeros", **kw),
        "wq_b": init_param((m.q_lora_rank, h, qk_dim), gen, **kw),
        "wkv_a": init_param((d, m.kv_lora_rank + m.qk_rope_dim), gen, **kw),
        "kv_norm_w": init_param((m.kv_lora_rank,), None, init="zeros", **kw),
        "wk_b": init_param((m.kv_lora_rank, h, m.qk_nope_dim), gen, **kw),
        "wv_b": init_param((m.kv_lora_rank, h, m.v_head_dim), gen, **kw),
        "wo": init_param((h, m.v_head_dim, d), gen, **kw),
    }


def _mla_q(params, x, m: MLAConfig, rope):
    """(q_nope, rotated q_rope), each (b, s, h, ·)."""
    ql = rmsnorm(x @ params["wq_a"], params["q_norm_w"])
    q_nope, q_rope = _proj(ql, params["wq_b"]).split(
        [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    return q_nope, rotate(q_rope, *rope)


def _mla_scale(m: MLAConfig) -> float:
    return (m.qk_nope_dim + m.qk_rope_dim) ** -0.5


def _mla_heads(params, cfg) -> Tuple[int, bool]:
    """(the heads `params` hold, whether they are a model-axis share):
    under a serving mesh wq_b / wk_b / wv_b / wo hold this rank's heads
    (serve/sharding.py), or all of them where the axis does not divide
    the heads (replicated: no reduction)."""
    h = params["wq_b"].shape[1]
    return h, h != cfg.num_heads


def apply_mla(params, x, cfg, *, rope, cache: Optional[MLACache] = None,
              q_chunk: int = 1024, kv_chunk: int = 1024,
              attn_impl: str = "kernel"
              ) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """Training / prefill MLA in the expanded form: per-head K and V from
    the latent, v zero-padded to q's head_dim (nope + rope) so the shared
    chunked_attention (the flash kernel on the card) runs it, then cut
    back. `rope` holds the tables at the rope width (qk_rope_dim). With
    `cache` the latent and the rope key are written at [0, s) in place.
    Under a serving mesh the heads are this rank's (_mla_heads) and the
    latent is replicated."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    h, split = _mla_heads(params, cfg)
    q_nope, q_rope = _mla_q(params, x, m, rope)
    ckv, k_rope = (x @ params["wkv_a"]).split(
        [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    ckv = rmsnorm(ckv, params["kv_norm_w"])
    k_rope = rotate(k_rope[:, :, None, :], *rope)                 # (b,s,1,r)
    k = torch.cat([_proj(ckv, params["wk_b"]),
                   k_rope.expand(b, s, h, m.qk_rope_dim)], dim=-1)
    v = _proj(ckv, params["wv_b"])
    o = attn_lib.chunked_attention(
        torch.cat([q_nope, q_rope], dim=-1), k,
        F.pad(v, (0, k.shape[-1] - v.shape[-1])), causal=True,
        q_chunk=q_chunk, kv_chunk=kv_chunk, scale=_mla_scale(m),
        impl=attn_impl)
    out = _out(o[..., :m.v_head_dim], params["wo"], reduce=split)
    if cache is not None:
        cache.ckv[:, :s] = ckv.to(cache.ckv.dtype)
        cache.k_rope[:, :s] = k_rope[:, :, 0].to(cache.k_rope.dtype)
        cache.length.fill_(s)
    return out, cache


def decode_mla(params, x, cfg, *, rope, cache: MLACache
               ) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed-form one-token MLA decode over the latent cache: the new
    latent and rope key are written at each row's `length` (in place,
    length += 1), W_uk is absorbed into the query, attention runs in the
    latent space and W_uv up-projects its output. `rope` holds the tables
    at each row's position."""
    m: MLAConfig = cfg.mla
    q_nope, q_rope = _mla_q(params, x, m, rope)
    ckv_new, k_rope_new = (x[:, 0] @ params["wkv_a"]).split(
        [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    ckv_new = rmsnorm(ckv_new, params["kv_norm_w"])
    k_rope_new = rotate(k_rope_new[:, None, None, :], *rope)[:, 0, 0]
    attn_lib.write_position((cache.ckv, cache.k_rope), (ckv_new, k_rope_new),
                            cache.length)
    cache.length.add_(1)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, params["wk_b"])
    o_lat = attn_lib.mla_decode_attention(q_abs, q_rope, cache,
                                          scale=_mla_scale(m))
    o = torch.einsum("bshr,rhk->bshk", o_lat, params["wv_b"])
    return _out(o, params["wo"], reduce=_mla_heads(params, cfg)[1]), cache


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


def apply_mlp(params, x, act: Callable, gated: bool = True,
              reduce: bool = False):
    """The MLP through wq_lib.matmul: plain `@` on float weights; packed
    2-D weights go to the matmul_wq kernel (its plain version on the
    CPU). With `reduce` the weights are this rank's d_ff shard under a
    serving mesh: w_down's partial products are summed over the model
    axis (and in training the replicated x enters w_gate / w_up's shards
    through shard_ctx.enter_model)."""
    if reduce:
        x = shard_ctx.enter_model(x)
    if gated:
        h = (act(wq_lib.matmul(x, params["w_gate"]))
             * wq_lib.matmul(x, params["w_up"]))
    else:
        h = act(wq_lib.matmul(x, params["w_up"]))
    if not reduce:
        return wq_lib.matmul(h, params["w_down"])
    w = params["w_down"]
    if isinstance(w, wq_lib.QuantWeight):
        # matmul_wq's f32 sum on several ranks, so the partials round once
        part = wq_lib.matmul(h, w, out_dtype=(
            torch.float32 if shard_ctx.model_size() > 1 else None))
    else:
        part = shard_ctx.row_partial(h, w)
    return shard_ctx.reduce_model(part).to(h.dtype)


# ---------------------------------------------------------------------------
# Full decoder layer
# ---------------------------------------------------------------------------

def init_layer(spec: LayerSpec, cfg, gen: torch.Generator, *, device,
               dtype) -> dict:
    """One layer's parameters, the reference's tree: ln1 and "attn" (GQA
    or MLA) or "mamba"; with cross-attention ln_x and "xattn"; unless mlp
    is "none", ln2 and "mlp" or "moe"."""
    if spec.kind not in ("attn", "mamba") or spec.mlp not in ("dense", "moe",
                                                               "none"):
        raise ValueError(f"unknown layer spec {spec}")
    kw = dict(device=device, dtype=dtype)
    p: dict = {}
    init_norm(p, "ln1", cfg.d_model, cfg.norm, **kw)
    if spec.kind == "attn":
        p["attn"] = (init_mla if cfg.mla is not None
                     else init_attention)(cfg, gen, **kw)
    else:
        p["mamba"] = init_mamba2(cfg.d_model, cfg.ssm, gen, **kw)
    if spec.cross_attn:
        init_norm(p, "ln_x", cfg.d_model, cfg.norm, **kw)
        p["xattn"] = init_attention(cfg, gen, **kw)
    if spec.mlp != "none":
        init_norm(p, "ln2", cfg.d_model, cfg.norm, **kw)
        if spec.mlp == "moe":
            p["moe"] = init_moe(cfg.d_model, cfg.moe, gen, **kw)
        else:
            p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.gated_mlp, gen,
                                **kw)
    return p


def _self_mixer(params, h, spec: LayerSpec, cfg, *, rope, cache, mode,
                paged, paged_impl, attn_quant, q_chunk, kv_chunk, attn_impl):
    """The layer's attention or Mamba-2 block: (out, cache)."""
    if spec.kind == "mamba":
        p = params["mamba"]
        if mode == "decode":
            return decode_mamba2(p, h, cfg.d_model, cfg.ssm, cache)
        a, state = apply_mamba2(p, h, cfg.d_model, cfg.ssm)
        if mode != "prefill":
            return a, None
        cache.conv.copy_(state.conv)
        cache.ssm.copy_(state.ssm)
        return a, cache
    p = params["attn"]
    if mode == "decode":
        if cfg.mla is not None:
            return decode_mla(p, h, cfg, rope=rope, cache=cache)
        return decode_attention_block(p, h, cfg, rope=rope, cache=cache,
                                      paged=paged, paged_impl=paged_impl,
                                      attn_quant=attn_quant)
    if mode == "prefill" and paged is not None:
        return paged_prefill_attention_block(
            p, h, cfg, rope=rope, cache=cache, paged=paged,
            paged_impl=paged_impl, attn_quant=attn_quant)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    want = cache if mode == "prefill" else None
    kw = dict(rope=rope, cache=want, q_chunk=q_chunk, kv_chunk=kv_chunk,
              attn_impl=attn_impl)
    if cfg.mla is not None:
        return apply_mla(p, h, cfg, **kw)
    return apply_attention(p, h, cfg, **kw)


def _cross_attention(params, h, cfg, *, encoder_out, cross, mode, q_chunk,
                     kv_chunk, attn_impl):
    """Cross-attention over the encoder's output: decode reads the cached
    K/V (only the query projection runs a token); train and prefill
    project the encoder output, and prefill also fills the cache."""
    if mode == "decode" and cross is not None:
        q = _proj(h, params["wq"])
        o = attn_lib.chunked_attention(q, cross.k, cross.v, causal=False,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk,
                                       impl=attn_impl)
        return _out(o, params["wo"])
    if encoder_out is None:
        raise ValueError("a cross-attention layer needs encoder_out")
    a, _ = apply_attention(params, h, cfg, rope=None, cache=cross,
                           kv_source=encoder_out, causal=False,
                           q_chunk=q_chunk, kv_chunk=kv_chunk,
                           attn_impl=attn_impl)
    return a


def apply_layer(
    params, x, spec: LayerSpec, cfg, *, rope, act: Callable,
    cache: Any = None, encoder_out: Optional[torch.Tensor] = None,
    mode: str = "train", paged: Optional[PagedState] = None,
    paged_impl: str = "kernel", attn_quant=None, q_chunk: int = 1024,
    kv_chunk: int = 1024, attn_impl: str = "kernel",
) -> Tuple[torch.Tensor, Any, Any]:
    """One layer in "train" mode (the full sequence, no cache), "prefill"
    (a dense cache filled from the whole prompt, or one paged chunk) or
    "decode" (dense or paged), with the (cos, sin) rope tables of its
    positions. A cross-attention layer's cache is the pair (self cache,
    CrossKV): prefill fills both, decode reads the cross K/V. Caches are
    updated in place. Returns (x, cache, aux_loss): aux_loss is the MoE
    router's load-balancing loss (an f32 scalar), or 0.0 (no device
    work)."""
    cross = None
    if spec.cross_attn and cache is not None:
        cache, cross = cache
    h = apply_norm(params, "ln1", x, cfg.norm, cfg.norm_eps)
    a, cache = _self_mixer(params, h, spec, cfg, rope=rope, cache=cache,
                           mode=mode, paged=paged, paged_impl=paged_impl,
                           attn_quant=attn_quant, q_chunk=q_chunk,
                           kv_chunk=kv_chunk, attn_impl=attn_impl)
    x = x + a
    if spec.cross_attn:
        h = apply_norm(params, "ln_x", x, cfg.norm, cfg.norm_eps)
        x = x + _cross_attention(params["xattn"], h, cfg,
                                 encoder_out=encoder_out, cross=cross,
                                 mode=mode, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk, attn_impl=attn_impl)
        if cross is not None:
            cache = (cache, cross)
    if spec.mlp == "none":
        return x, cache, 0.0
    h = apply_norm(params, "ln2", x, cfg.norm, cfg.norm_eps)
    if spec.mlp == "moe":
        # serving never drops a token: capacity-factor drops are a training
        # discipline, and in decode they would couple co-batched slots (one
        # slot's routing could evict another's token)
        m, aux = apply_moe(params["moe"], h, cfg.moe, act,
                           full=mode != "train")
        return x + m, cache, aux
    return x + apply_mlp(params["mlp"], h, act, cfg.gated_mlp,
                         mlp_reduce(cfg, params["mlp"])), cache, 0.0


def mlp_reduce(cfg, mlp) -> bool:
    """Whether a dense MLP's weights are a model-axis shard under the
    active serving mesh (its w_down partials are then summed)."""
    return (shard_ctx.active_mesh() is not None and shard_ctx.mlp_splits(
        cfg.d_ff, mlp["w_down"], shard_ctx.model_size()))
