"""Placement for serving over a (data, model) mesh: each rank's shard of the
weights and of the KV storage.

The reference places whole arrays with NamedShardings and lets GSPMD
partition the step; here every rank holds only its slice, and the model code
sums or gathers across ranks itself (nn/shard_ctx.py). The slices follow the
reference's logical axes (its nn/common.DEFAULT_RULES): `heads`,
`kv_heads`, `mlp`, `experts` and `vocab` over `model`, everything else
(norms, routers, the embedding's d_model) replicated, and an axis the
model axis does not divide replicated too:

  * attention (self-attention, Whisper's cross-attention and its encoder's
    layers): query heads in contiguous ranges of heads_phys / m (the
    engine pads with launch/steps.pad_heads_for where they do not divide);
    each rank's KV heads are the contiguous range its query heads read,
    q // group, so with fewer KV heads than ranks (glm4's 2 at m = 4)
    ranks share a KV head and hold a copy of it. `wo` and its partial sums
    are row-parallel (reduce_model);
  * MLA: `wq_b`, `wk_b` and `wv_b` over heads, `wo` row-parallel; `wq_a`,
    `wkv_a` and their norms replicated (so is the latent cache);
  * MLP: `w_gate` / `w_up` column-parallel, `w_down` row-parallel over
    d_ff. A packed `w_down` (its contraction axis is d_ff) splits only on
    whole k-tiles; otherwise the layer's MLP is replicated, as the reference
    replicates a packed contraction axis (shard_ctx.mlp_splits);
  * MoE: the experts' `w_gate` / `w_up` / `w_down` in contiguous ranges of
    E / m (shard_ctx.experts_split), the shared experts' `ws_*` by the
    MLP's rule over their d_ff, the router replicated;
  * Mamba-2: by SSM head (shard_ctx.ssm_splits). The reference cuts
    in_proj's concatenated [z | x | B | C | dt] axis in contiguous halves
    and lets GSPMD fix the segments up; here a rank takes its heads' columns
    of each segment (B and C whole unless the groups split), the matching
    conv channels, dt_bias, a_log, d_skip, norm_w and out_proj's rows;
  * vocabulary: the embedding's rows and an untied head's columns, in equal
    ranges when m divides the vocabulary (else replicated: whisper's
    51,865);
  * packed leaves (quant/weights.QuantWeight) are cut by slicing their
    payload and exponent planes, never by packing a shard again (which
    would change the tile of a shard whose K is not a tile multiple);
  * KV storage: the paged pools', dense KV caches' and cross-attention
    caches' kv-head axis, the rank's local KV heads (`local_heads`); the
    SSM state's heads and conv channels as the mixer's; the MLA latent
    cache whole. The block axis, the allocator, the block table and the
    radix cache are the same on every rank.

The data axis replicates all of it but the dense caches, as the
reference's placement does (weights and pools carry no data axis): every
rank of a model column holds the same blocks, kept equal by the engine's
gathered decode write-back (models/lm.decode_step). The dense caches'
slot axis splits over `data` in contiguous ranges where the axis divides
the slots (the reference's cache_pspecs batch spec), and is replicated
otherwise (nn/shard_ctx.data_slots): a data rank then decodes every slot.
Every registered arch is served under a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models.config import ModelConfig
from repro_torch.nn import shard_ctx
from repro_torch.nn.attention import (CrossKV, KVCache, MLACache,
                                      PagedKVCache, QuantPagedKVCache)
from repro_torch.nn.mamba2 import SSMState
from repro_torch.quant.weights import QuantWeight


def has_attention(cfg: ModelConfig) -> bool:
    """Whether the model has attention heads to pad and split (a pure SSM
    stack such as mamba2 has none: its num_heads is a placeholder)."""
    return cfg.encoder is not None or any(
        spec.kind == "attn" for period, _ in cfg.groups for spec in period)


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


def _ssm_ranges(cfg: ModelConfig, m: int, r: int):
    """Rank r's Mamba-2 share: ((head lo, hi), (B/C channel lo, hi) within
    a segment of groups * d_state), or None where the mixer is replicated
    (shard_ctx.ssm_splits)."""
    s = cfg.ssm
    h, gn = s.n_heads(cfg.d_model), s.n_groups * s.d_state
    heads, groups = shard_ctx.ssm_splits(h, s.n_groups, m)
    if not heads:
        return None
    hl = h // m
    bc = (r * gn // m, (r + 1) * gn // m) if groups else (0, gn)
    return (r * hl, (r + 1) * hl), bc


def local_caches(cfg: ModelConfig, m: int) -> dict:
    """lm.init_caches' keyword arguments for a rank's dense caches at
    model-axis size m (cfg with its heads already padded): its KV heads and
    its SSM (heads, groups)."""
    kw = {}
    if has_attention(cfg):
        kw["kv_heads"] = local_heads(cfg, m)[1]
    if cfg.ssm is not None:
        s = cfg.ssm
        rng = _ssm_ranges(cfg, m, 0)
        kw["ssm_share"] = (
            (s.n_heads(cfg.d_model), s.n_groups) if rng is None else
            (rng[0][1] - rng[0][0],
             (rng[1][1] - rng[1][0]) // s.d_state))
    return kw


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


def _layers(params, cfg: ModelConfig, fn):
    """The tree with fn applied to every layer dict: each repeat's period
    layers and each encoder layer (other leaves shared)."""
    out = dict(params)
    for gi in range(len(cfg.groups)):
        out[f"group{gi}"] = [{ln: fn(layer) for ln, layer in rep.items()}
                             for rep in params[f"group{gi}"]]
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"], layers=[
            fn(layer) for layer in params["encoder"]["layers"]])
    return out


def pad_params(params, cfg: ModelConfig):
    """The tree with every attention leaf (self-, cross- and the encoder's
    attention) zero-padded to cfg's physical head counts (cfg.attn_pad; the
    padded heads are inert). Leaves already at those counts are kept."""
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

    def layer(p):
        return {k: (attn(v) if k in ("attn", "xattn") else v)
                for k, v in p.items()}
    return _layers(params, cfg, layer)


def place_params(params, cfg: ModelConfig, mesh):
    """This rank's slice of the full (padded, see pad_params) parameter
    tree, raw tensors and packed QuantWeights alike; replicated leaves (and
    every leaf on a one-rank axis) are shared with the input tree, sharded
    ones are tensors of their own."""
    m = shard_ctx.model_size(mesh)
    r = shard_ctx.model_rank(mesh)

    def attn(p):
        (q_lo, q_hi), (kv_lo, kv_hi) = head_ranges(cfg, m, r)
        axes = {"wq": (-2, q_lo, q_hi), "wk": (-2, kv_lo, kv_hi),
                "wv": (-2, kv_lo, kv_hi), "wo": (-3, q_lo, q_hi),
                "bq": (-2, q_lo, q_hi), "bk": (-2, kv_lo, kv_hi),
                "bv": (-2, kv_lo, kv_hi)}
        return {k: (_slice(w, *axes[k]) if k in axes else w)
                for k, w in p.items()}

    def mla(p):
        h = cfg.num_heads
        if h % m:
            return p
        lo, hi = r * h // m, (r + 1) * h // m
        axes = {"wq_b": -2, "wk_b": -2, "wv_b": -2, "wo": -3}
        return {k: (_slice(w, axes[k], lo, hi) if k in axes else w)
                for k, w in p.items()}

    def mlp(p, d_ff, names=("w_gate", "w_up", "w_down")):
        if not shard_ctx.mlp_splits(d_ff, p[names[2]], m):
            return p
        lo, hi = r * d_ff // m, (r + 1) * d_ff // m
        out = dict(p)
        for k in names:
            if k in p:
                out[k] = _slice(p[k], -2 if k == names[2] else -1, lo, hi)
        return out

    def moe(p):
        mc = cfg.moe
        out = dict(p)
        if shard_ctx.experts_split(mc.num_experts, m):
            n = mc.num_experts // m
            for k in ("w_gate", "w_up", "w_down"):
                out[k] = _slice(p[k], -3, r * n, (r + 1) * n)
        if mc.num_shared:
            out = mlp(out, mc.d_ff * mc.num_shared,
                      ("ws_gate", "ws_up", "ws_down"))
        return out

    def mamba(p):
        rng = _ssm_ranges(cfg, m, r)
        if rng is None:
            return p
        s = cfg.ssm
        di, gn = s.d_inner(cfg.d_model), s.n_groups * s.d_state
        (h0, h1), (b0, b1) = rng
        dev = p["in_proj"].device

        def span(lo, hi):
            return torch.arange(lo, hi, device=dev)
        chans, bc = span(h0 * s.head_dim, h1 * s.head_dim), span(b0, b1)
        heads = span(h0, h1)
        cols = torch.cat([chans, di + chans, 2 * di + bc, 2 * di + gn + bc,
                          2 * di + 2 * gn + heads])
        conv = torch.cat([chans, di + bc, di + gn + bc])
        take = {"in_proj": (-1, cols), "conv_w": (-1, conv),
                "conv_b": (-1, conv), "dt_bias": (-1, heads),
                "a_log": (-1, heads), "d_skip": (-1, heads),
                "norm_w": (-1, chans), "out_proj": (-2, chans)}
        return {k: (p[k].index_select(p[k].dim() + take[k][0], take[k][1])
                    if k in take else p[k]) for k in p}

    def layer(p):
        out = dict(p)
        if "attn" in p:
            out["attn"] = (mla if cfg.mla is not None else attn)(p["attn"])
        if "xattn" in p:
            out["xattn"] = attn(p["xattn"])
        if "mamba" in p:
            out["mamba"] = mamba(p["mamba"])
        if "mlp" in p:
            out["mlp"] = mlp(p["mlp"], cfg.d_ff)
        if "moe" in p:
            out["moe"] = moe(p["moe"])
        return out

    out = _layers(params, cfg, layer)
    if shard_ctx.vocab_splits(cfg.vocab_size, m):
        n = cfg.vocab_size // m
        for k, ax in (("embed", -2), ("head", -1)):
            if k in params:
                out[k] = _slice(params[k], ax, r * n, (r + 1) * n)
    return out


def serving_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """The config a rank of `mesh` serves: its attention heads padded to
    the model axis (launch/steps.pad_heads_for) where it has any."""
    from repro_torch.launch.steps import pad_heads_for
    return pad_heads_for(cfg, mesh) if has_attention(cfg) else cfg


def _placer(cfg: ModelConfig, mesh, pack):
    """piece -> this rank's slice of it: a piece (a tree holding some of
    the top-level leaves, or one repeat of one group) padded, packed and
    placed. The other groups are empty, so the three steps give the bits
    they give on the whole tree."""
    skel = {f"group{gi}": [] for gi in range(len(cfg.groups))}

    def build(piece):
        full = pad_params({**skel, **piece}, cfg)
        out = place_params(full if pack is None else pack(full), cfg, mesh)
        return {k: out[k] for k in piece}
    return build


def shard_params(params, cfg: ModelConfig, mesh, pack=None):
    """This rank's shard of the full tree `params`: pad_params, then `pack`
    (the engine's weight packing, a tree to tree function; None: none),
    then place_params, a piece at a time — the top-level leaves, then each
    repeat of each group — so the packed copy of the whole tree is never
    made."""
    build = _placer(cfg, mesh, pack)
    out = build({k: v for k, v in params.items()
                 if not k.startswith("group")})
    for gi in range(len(cfg.groups)):
        out[f"group{gi}"] = [build({f"group{gi}": [rep]})[f"group{gi}"][0]
                             for rep in params[f"group{gi}"]]
    return out


@dataclasses.dataclass(frozen=True)
class Draw:
    """lm.init_lm(cfg, seed, dtype)'s tree, not drawn yet: what a mesh rank
    hands ServeEngine(mesh=) in place of a tree (launch/serve.py --mesh).
    The engine draws it on its device a piece at a time and keeps only its
    shard, packed by its own precision (draw_shard), so neither the card
    nor the host ever holds the whole tree."""
    seed: int
    dtype: torch.dtype = torch.bfloat16


def draw_shard(cfg: ModelConfig, mesh, draw: Draw, device, pack=None):
    """This rank's shard of lm.init_lm(cfg, draw.seed, draw.dtype)'s tree,
    drawn on `device` a piece at a time (the embedding, the head, an
    encoder layer, a repeat of a group): each piece is drawn whole, its
    slice kept and the rest freed — the bits shard_params gives on the
    whole draw. `cfg` is the unpadded config (the draw's)."""
    from repro_torch.models import lm
    return lm.init_lm(cfg, seed=draw.seed, dtype=draw.dtype, device=device,
                      shard=_placer(serving_config(cfg, mesh), mesh, pack))


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
    """This rank's slice of a full dense cache tree: its data rank's slots
    (data_slots), and of a KVCache or CrossKV its kv heads, of an SSMState
    its heads and conv channels; an MLACache's latent is replicated over
    the model axis. These are the local shapes the engine builds with
    init_caches(batch=its slots, **local_caches(...)); this one serves the
    tests, as place_paged_pools."""
    m = shard_ctx.model_size(mesh)
    r = shard_ctx.model_rank(mesh)
    lo = hi = None
    if has_attention(cfg):
        _, (lo, hi) = head_ranges(cfg, m, r)
    ssm = None if cfg.ssm is None else _ssm_ranges(cfg, m, r)
    first = next(iter(caches[0][0][0] if isinstance(caches[0][0], tuple)
                      and not hasattr(caches[0][0], "_fields")
                      else caches[0][0]))
    s0, s1 = shard_ctx.data_slots(first.shape[1], mesh)

    def rows(t, axis=None, span=None):
        t = t.narrow(1, s0, s1 - s0)
        if axis is not None:
            t = (t.narrow(axis, span[0], span[1] - span[0])
                 if isinstance(span, tuple) else t.index_select(axis, span))
        return t.clone()

    def leaf(c):
        if isinstance(c, tuple) and not hasattr(c, "_fields"):
            return tuple(leaf(x) for x in c)
        if isinstance(c, KVCache):
            return KVCache(rows(c.k, -2, (lo, hi)), rows(c.v, -2, (lo, hi)),
                           rows(c.length))
        if isinstance(c, CrossKV):
            return CrossKV(rows(c.k, -2, (lo, hi)), rows(c.v, -2, (lo, hi)))
        if isinstance(c, MLACache):
            return MLACache(rows(c.ckv), rows(c.k_rope), rows(c.length))
        if ssm is None:
            return SSMState(rows(c.conv), rows(c.ssm))
        sc = cfg.ssm
        di, gn = sc.d_inner(cfg.d_model), sc.n_groups * sc.d_state
        (h0, h1), (b0, b1) = ssm
        chans = torch.arange(h0 * sc.head_dim, h1 * sc.head_dim)
        bc = torch.arange(b0, b1)
        conv = torch.cat([chans, di + bc, di + gn + bc]).to(c.conv.device)
        return SSMState(rows(c.conv, -1, conv), rows(c.ssm, 2, (h0, h1)))
    return tuple(tuple(leaf(c) for c in group) for group in caches)


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
