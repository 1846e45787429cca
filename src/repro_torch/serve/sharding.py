"""Placement for serving over a (data, model) mesh: each rank's shard of the
weights and of the KV storage.

The reference places whole arrays with NamedShardings and lets GSPMD
partition the step; here every rank holds only its slice, and the model code
sums or gathers across ranks itself (nn/shard_ctx.py). The slices follow the
reference's logical axes (its nn/common.DEFAULT_RULES): `heads`, `kv_heads`,
`mlp` and `vocab` over `model`, everything else (norms, the embedding's
d_model) replicated:

  * attention: query heads in contiguous ranges of heads_phys / m (the
    engine pads with launch/steps.pad_heads_for where they do not divide);
    each rank's KV heads are the contiguous range its query heads read,
    q // group, so with fewer KV heads than ranks (glm4's 2 at m = 4)
    ranks share a KV head and hold a copy of it. `wo` and its partial sums
    are row-parallel (reduce_model);
  * MLP: `w_gate` / `w_up` column-parallel, `w_down` row-parallel over
    d_ff. A packed `w_down` (its contraction axis is d_ff) splits only on
    whole k-tiles; otherwise the layer's MLP is replicated, as the reference
    replicates a packed contraction axis (shard_ctx.mlp_splits);
  * vocabulary: the embedding's rows and an untied head's columns, in equal
    ranges when m divides the vocabulary (else replicated);
  * packed leaves (quant/weights.QuantWeight) are cut by slicing their
    payload and exponent planes, never by packing a shard again (which
    would change the tile of a shard whose K is not a tile multiple);
  * KV storage: the paged pools' and dense caches' kv-head axis, the rank's
    local KV heads (`local_heads`); the block axis, the allocator, the block
    table and the radix cache are the same on every rank.

The data axis replicates all of it but the dense caches, as the
reference's placement does (weights and pools carry no data axis): every
rank of a model column holds the same blocks, kept equal by the engine's
gathered decode write-back (models/lm.decode_step). The dense caches'
slot axis splits over `data` in contiguous ranges where the axis divides
the slots (the reference's cache_pspecs batch spec), and is replicated
otherwise (nn/shard_ctx.data_slots): a data rank then decodes every slot.

Layer kinds outside this slice (MoE, MLA, Mamba-2, cross-attention) raise
under a mesh: their tensor parallelism is ROADMAP A10b.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.launch.mesh import A10B, mesh_sizes
from repro_torch.models.config import ModelConfig
from repro_torch.nn import shard_ctx
from repro_torch.nn.common import tree_map
from repro_torch.nn.attention import (KVCache, PagedKVCache,
                                      QuantPagedKVCache)
from repro_torch.quant.weights import QuantWeight


def check_servable(cfg: ModelConfig) -> None:
    """Raise for a config whose layers this slice cannot shard."""
    kinds = []
    if cfg.moe is not None:
        kinds.append("MoE")
    if cfg.mla is not None:
        kinds.append("MLA")
    specs = [spec for period, _ in cfg.groups for spec in period]
    if any(spec.kind == "mamba" for spec in specs):
        kinds.append("Mamba-2")
    if cfg.encoder is not None or any(spec.cross_attn for spec in specs):
        kinds.append("cross-attention")
    if kinds:
        raise ValueError(
            f"{cfg.name}: tensor parallelism for {', '.join(kinds)} is not "
            f"served under a mesh yet ({A10B})")


def head_ranges(cfg: ModelConfig, m: int, r: int
                ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((q_lo, q_hi), (kv_lo, kv_hi)): rank r's contiguous query heads and
    the KV heads they read, over the physical (padded) counts."""
    h, kv = cfg.heads_phys, cfg.kv_heads_phys
    if h % m:
        raise ValueError(f"{cfg.name}: {h} heads do not split over {m} "
                         "ranks; pad them first (launch/steps.pad_heads_for)")
    hl, g = h // m, h // kv
    if hl % g and g % hl:
        raise ValueError(
            f"{cfg.name}: {hl} query heads a rank and a GQA group of {g} "
            "give the ranks different groups; no mesh of this size serves "
            "it")
    q_lo, q_hi = r * hl, (r + 1) * hl
    return (q_lo, q_hi), (q_lo // g, (q_hi - 1) // g + 1)


def local_heads(cfg: ModelConfig, m: int) -> Tuple[int, int]:
    """(query heads, KV heads) a rank holds at model-axis size m."""
    (q_lo, q_hi), (kv_lo, kv_hi) = head_ranges(cfg, m, 0)
    return q_hi - q_lo, kv_hi - kv_lo


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _slice(w: Any, axis: int, lo: int, hi: int):
    """w[lo:hi] along `axis` (negative) as a tensor of its own, or w itself
    where the range is all of it (a one-rank axis); a packed leaf slices
    its payload and exponent planes (on the contraction axis only whole
    tiles: rows of the payload and of the exponents)."""
    if not isinstance(w, QuantWeight):
        if lo == 0 and hi == w.shape[axis]:
            return w
        return w.narrow(w.dim() + axis, lo, hi - lo).clone()
    if lo == 0 and hi == (w.kdim if axis == w.caxis else w.q.shape[axis]):
        return w
    ax = w.q.dim() + axis
    if axis != w.caxis:
        return QuantWeight(q=w.q.narrow(ax, lo, hi - lo).clone(),
                           e=w.e.narrow(ax, lo, hi - lo).clone(),
                           bits=w.bits, caxis=w.caxis, kdim=w.kdim,
                           tile=w.tile)
    if lo % w.tile or hi % w.tile:
        raise ValueError(f"a packed contraction axis splits on whole tiles "
                         f"of {w.tile}, not at [{lo}, {hi})")
    q_lo, q_hi = (lo, hi) if w.bits == 8 else (lo // 2, hi // 2)
    return QuantWeight(q=w.q.narrow(ax, q_lo, q_hi - q_lo).clone(),
                       e=w.e.narrow(ax, lo // w.tile,
                                    (hi - lo) // w.tile).clone(),
                       bits=w.bits, caxis=w.caxis, kdim=hi - lo,
                       tile=w.tile)


def _pad(w: Any, axis: int, n: int):
    """w zero-padded to n entries along `axis` (a packed leaf: zero payload
    and zero exponents, which dequantize to 0)."""
    if not isinstance(w, QuantWeight):
        ax = w.dim() + axis
        extra = list(w.shape)
        extra[ax] = n - w.shape[ax]
        return torch.cat([w, w.new_zeros(extra)], dim=ax)
    return QuantWeight(q=_pad(w.q, axis, n), e=_pad(w.e, axis, n),
                       bits=w.bits, caxis=w.caxis, kdim=w.kdim, tile=w.tile)


def pad_params(params, cfg: ModelConfig):
    """The tree with every attention leaf zero-padded to cfg's physical
    head counts (cfg.attn_pad; the padded heads are inert). Leaves already
    at those counts are kept."""
    if cfg.attn_pad is None:
        return params
    h, kv = cfg.heads_phys, cfg.kv_heads_phys
    axes = {"wq": (-2, h), "wk": (-2, kv), "wv": (-2, kv), "wo": (-3, h),
            "bq": (-2, h), "bk": (-2, kv), "bv": (-2, kv)}

    def attn(p):
        out = dict(p)
        for k, (ax, n) in axes.items():
            if k in out:
                w = out[k]
                cur = (w.q if isinstance(w, QuantWeight) else w).shape[ax]
                if cur != n:
                    out[k] = _pad(w, ax, n)
        return out

    out = dict(params)
    for gi in range(len(cfg.groups)):
        out[f"group{gi}"] = [
            {ln: (dict(layer, attn=attn(layer["attn"]))
                  if "attn" in layer else layer)
             for ln, layer in rep.items()} for rep in out[f"group{gi}"]]
    return out


def place_params(params, cfg: ModelConfig, mesh):
    """This rank's slice of the full (padded, see pad_params) parameter
    tree, raw tensors and packed QuantWeights alike; replicated leaves (and
    every leaf on a one-rank axis) are shared with the input tree, sharded
    ones are tensors of their own."""
    check_servable(cfg)
    m = shard_ctx.model_size(mesh)
    r = shard_ctx.model_rank(mesh)
    (q_lo, q_hi), (kv_lo, kv_hi) = head_ranges(cfg, m, r)
    attn_axes = {"wq": (-2, q_lo, q_hi), "wk": (-2, kv_lo, kv_hi),
                 "wv": (-2, kv_lo, kv_hi), "wo": (-3, q_lo, q_hi),
                 "bq": (-2, q_lo, q_hi), "bk": (-2, kv_lo, kv_hi),
                 "bv": (-2, kv_lo, kv_hi)}

    def attn(p):
        return {k: (_slice(w, *attn_axes[k]) if k in attn_axes else w)
                for k, w in p.items()}

    def mlp(p):
        if not shard_ctx.mlp_splits(cfg.d_ff, p["w_down"], m):
            return p
        n = cfg.d_ff // m
        lo, hi = r * n, (r + 1) * n
        return {k: _slice(w, -2 if k == "w_down" else -1, lo, hi)
                for k, w in p.items()}

    def layer(p):
        out = dict(p)
        out["attn"] = attn(p["attn"])
        if "mlp" in p:
            out["mlp"] = mlp(p["mlp"])
        return out

    out = dict(params)
    for gi in range(len(cfg.groups)):
        out[f"group{gi}"] = [{ln: layer(lp) for ln, lp in rep.items()}
                             for rep in params[f"group{gi}"]]
    if "embed" in params and shard_ctx.vocab_splits(cfg.vocab_size, m):
        n = cfg.vocab_size // m
        out["embed"] = _slice(params["embed"], -2, r * n, (r + 1) * n)
        if "head" in params:
            out["head"] = _slice(params["head"], -1, r * n, (r + 1) * n)
    return out


def _to(w: Any, device):
    if isinstance(w, QuantWeight):
        return dataclasses.replace(w, q=w.q.to(device), e=w.e.to(device))
    return w.to(device)


def shard_params(params, cfg: ModelConfig, mesh, device, pack=None):
    """This rank's shard of the full tree `params`, held on the host or on
    `device`: pad_params, then `pack` (the engine's weight packing, a tree
    to tree function; None: none), then place_params, a piece at a time —
    the top-level leaves, then each repeat of each group — each piece moved
    to `device` first. A tree held on the host never stands whole on the
    card: the card holds the shard built so far and one piece's full leaves
    (the embedding and head, or one repeat's layers). Each piece is a tree
    whose other groups are empty, so the three steps give the bits they
    give on the whole tree."""
    skel = {f"group{gi}": [] for gi in range(len(cfg.groups))}

    def build(piece):
        piece = pad_params(tree_map(lambda w: _to(w, device), piece), cfg)
        return place_params(piece if pack is None else pack(piece), cfg,
                            mesh)

    out = build({**{k: v for k, v in params.items()
                    if not k.startswith("group")}, **skel})
    for gi in range(len(cfg.groups)):
        out[f"group{gi}"] = [build({**skel, f"group{gi}": [rep]})[
            f"group{gi}"][0] for rep in params[f"group{gi}"]]
    return out


# ---------------------------------------------------------------------------
# KV storage
# ---------------------------------------------------------------------------

def place_paged_pools(pools, cfg: ModelConfig, mesh):
    """This rank's kv-head slice of a full paged pool tree (float
    PagedKVCache or QuantPagedKVCache with its exponent planes): the local
    shapes init_paged_caches(kv_heads=local_heads(...)[1]) builds. The
    engine builds its local pools that way; this slices an unsharded
    engine's pools, to hold a rank's against them (the tests)."""
    m = shard_ctx.model_size(mesh)
    _, (lo, hi) = head_ranges(cfg, m, shard_ctx.model_rank(mesh))

    def leaf(c):
        k, v = (c.k.narrow(-2, lo, hi - lo).clone(),
                c.v.narrow(-2, lo, hi - lo).clone())
        if isinstance(c, QuantPagedKVCache):
            return QuantPagedKVCache(
                k, v, c.k_exp.narrow(-1, lo, hi - lo).clone(),
                c.v_exp.narrow(-1, lo, hi - lo).clone(), bits=c.bits)
        return PagedKVCache(k, v)
    return tuple(tuple(leaf(c) for c in group) for group in pools)


def place_dense_caches(caches, cfg: ModelConfig, mesh):
    """This rank's slice of a full dense KVCache tree: its kv heads, and its
    data rank's slots (data_slots) — the local shapes the engine builds
    with init_caches(batch=its slots, kv_heads=local_heads(...)[1]); this
    one serves the tests, as place_paged_pools."""
    check_servable(cfg)
    m = shard_ctx.model_size(mesh)
    _, (lo, hi) = head_ranges(cfg, m, shard_ctx.model_rank(mesh))
    s0, s1 = shard_ctx.data_slots(caches[0][0].k.shape[1], mesh)

    def rows(t, heads=True):
        t = t.narrow(1, s0, s1 - s0)
        return (t.narrow(-2, lo, hi - lo) if heads else t).clone()
    return tuple(tuple(
        KVCache(rows(c.k), rows(c.v), rows(c.length, heads=False))
        for c in group) for group in caches)


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

def mesh_summary(mesh) -> str:
    sizes = mesh_sizes(mesh)
    body = "x".join(f"{a}={n}" for a, n in sizes.items())
    total = 1
    for n in sizes.values():
        total *= n
    return f"mesh({body}, devices={total})"


def publish_mesh_metrics(sm, mesh: Optional[Any]) -> None:
    """Record the mesh topology in the engine's metric registry (the
    reference's gauge: every axis 1 without a mesh). Serving metrics are
    engine-level aggregates: every rank runs the same schedule."""
    if mesh is None:
        sm.mesh_devices.set(1.0, axis="data")
        sm.mesh_devices.set(1.0, axis="model")
        return
    for axis, size in mesh_sizes(mesh).items():
        sm.mesh_devices.set(float(size), axis=axis)
