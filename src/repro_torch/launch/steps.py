"""The training step (the JAX package's launch/steps.py::make_train_step),
its placement over a (data, model) training mesh (`param_placement`, the
reference's param_pspecs(fsdp=True)), and the head padding of
tensor-parallel serving and training (`pad_heads_for`).

Training over a mesh is explicit: every rank holds its shard of each
parameter and of its AdamW moments, cut over `model` as serving cuts the
weights (serve/sharding.place_params: heads, d_ff, vocabulary) and over
`data` on the d_model axis (FSDP, train/fsdp.py); every rank of a model
column takes its data rank's share of each microbatch's rows; the model
code issues its own collectives (nn/shard_ctx.py) and autograd their
backward. PyTorch runs eagerly: the step is a plain function, and its GRAU register
file is built once per device, on the host, as the reference builds it
once outside its trace.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.nn import shard_ctx
from repro_torch.nn.common import tree_flatten, tree_map
from repro_torch.train import optim
from repro_torch.train.fsdp import Cut, gather_leaf, gatherer, local_piece


def pad_heads_for(cfg: ModelConfig, mesh) -> ModelConfig:
    """Zero-pad the head counts up to multiples of the model axis (`mesh`: a
    serving mesh or the axis size), so attention shards by heads; cfg as it
    is when the heads already divide it (or for MLA).

    The KV heads pad to the next multiple of the axis and the query heads
    to the arch's GQA group times that, so every real query head keeps its
    KV head and the pads (zero weights, nn/blocks.init_attention) read only
    pad KV heads: the padded model computes the unpadded one's function.
    The reference pads the query heads to the next multiple of the padded
    KV count instead, which keeps the group only where that multiple is
    the group times it (llama3-smoke's 4 / 2 heads at 3 ranks, but not
    glm4-smoke's 8 / 2: ROADMAP C, D5)."""
    m = mesh if isinstance(mesh, int) else mesh.size(
        mesh.mesh_dim_names.index("model"))
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if h % m == 0 or cfg.mla is not None:
        return cfg
    kvp = -(-kv // m) * m
    return cfg.replace(attn_pad=(h // kv * kvp, kvp))


# ---------------------------------------------------------------------------
# Placement over a training mesh
# ---------------------------------------------------------------------------

def mesh_shape(mesh) -> Tuple[int, int]:
    """(data, model) of a DeviceMesh, or a (data, model) pair itself."""
    if isinstance(mesh, tuple):
        return mesh
    return shard_ctx.data_size(mesh), shard_ctx.model_size(mesh)


def check_trainable(cfg: ModelConfig) -> None:
    """A training mesh takes the decoder-only archs with dense MLPs and GQA
    attention. MoE (its capacity drops and aux loss are of the global batch:
    they need serving's gathered routing, shard_ctx.split_rows, with a
    backward of its own), MLA, Mamba-2 and the encoder-decoder raise."""
    kinds = {(spec.kind, spec.mlp, spec.cross_attn)
             for period, _ in cfg.groups for spec in period}
    what = [name for name, on in (
        ("MoE", any(mlp == "moe" for _, mlp, _ in kinds)),
        ("MLA", cfg.mla is not None),
        ("Mamba-2", any(kind == "mamba" for kind, _, _ in kinds)),
        ("the encoder-decoder", cfg.encoder is not None
         or any(x for _, _, x in kinds))) if on]
    if what:
        raise NotImplementedError(
            f"{cfg.name}: training over a mesh takes decoder-only GQA archs "
            f"with dense MLPs; {', '.join(what)} over a training mesh is "
            "queued (ROADMAP A11)")


def train_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """The config a rank of a training mesh computes: its attention heads
    padded to the model axis (pad_heads_for)."""
    return pad_heads_for(cfg, mesh_shape(mesh)[1])


def param_placement(cfg: ModelConfig, mesh, *, fsdp: bool = True):
    """Each leaf's Cut on a (data, model) mesh (a DeviceMesh or a (data,
    model) pair), shaped as the parameter tree of train_config(cfg, mesh).
    Over `model`, as
    serve/sharding.place_params: attention's query and KV heads, the MLP's
    d_ff (column-parallel w_gate / w_up, row-parallel w_down) and the
    vocabulary (the embedding's rows, an untied head's columns); an axis
    the model axis does not divide is replicated. Over `data`, with
    `fsdp`, every leaf's d_model axis (the reference's logical "embed"
    axis: the embedding's and the norms' last, wq / wk / wv's first, wo's
    and w_down's last, w_gate / w_up's and the head's first), replicated
    where the data axis does not divide d_model — the reference's
    param_pspecs(cfg, mesh, fsdp=True) and its divisibility fallback."""
    check_trainable(cfg)
    nd, nm = mesh_shape(mesh)
    tcfg = train_config(cfg, (nd, nm))
    if tcfg.kv_heads_phys % nm:
        raise ValueError(
            f"{cfg.name}: {tcfg.kv_heads_phys} KV heads do not split over a "
            f"model axis of {nm}: a training mesh cuts each KV head's "
            "weights onto one rank")
    emb = fsdp and tcfg.d_model % nd == 0 and nd > 1
    dax = (lambda axis: axis if emb else None)
    vocab = nm > 1 and shard_ctx.vocab_splits(tcfg.vocab_size, nm)
    mlp = nm > 1 and tcfg.d_ff % nm == 0
    heads = nm > 1
    rules = {
        "embed": Cut(-2 if vocab else None, dax(-1)),
        "head": Cut(-1 if vocab else None, dax(-2)),
        "wq": Cut(-2 if heads else None, dax(-3)),
        "wk": Cut(-2 if heads else None, dax(-3)),
        "wv": Cut(-2 if heads else None, dax(-3)),
        "wo": Cut(-3 if heads else None, dax(-1)),
        "bq": Cut(-2 if heads else None, None),
        "bk": Cut(-2 if heads else None, None),
        "bv": Cut(-2 if heads else None, None),
        "w_gate": Cut(-1 if mlp else None, dax(-2)),
        "w_up": Cut(-1 if mlp else None, dax(-2)),
        "w_down": Cut(-2 if mlp else None, dax(-1)),
    }

    def cut(path: str) -> Cut:
        name = path.split("/")[-1]
        if name in rules:
            return rules[name]
        if name.endswith(("_w", "_b")):      # a norm over d_model
            return Cut(None, dax(-1))
        raise ValueError(f"{cfg.name}: no training placement for {path}")
    shapes = lm.init_lm(tcfg, device="meta")
    paths = iter(path for path, _ in tree_flatten(shapes))
    return tree_map(lambda _: cut(next(paths)), shapes)


def state_placement(placement):
    """The Cut tree of a training state {"params", "opt"}: the moments cut
    as their parameters, the step count replicated (ckpt save / restore
    under a mesh)."""
    return {"params": placement,
            "opt": optim.OptState(step=Cut(), m=placement, v=placement)}


def _pieces(tree, placement):
    """`placement` restricted to the keys of `tree` (a whole parameter tree
    or a piece of one: some top-level leaves, or {"group{i}": [repeats]}),
    every repeat of a group taking the group's cuts."""
    return {k: ([placement[k][0]] * len(v) if k.startswith("group")
                else placement[k]) for k, v in tree.items()}


def _coords(mesh) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    return ((shard_ctx.data_rank(mesh), shard_ctx.model_rank(mesh)),
            mesh_shape(mesh))


def shard_train_params(params, cfg: ModelConfig, mesh, *,
                       fsdp: bool = True):
    """This rank's shard of the whole (unpadded) parameter tree `params`,
    or of a piece of it (init_lm's `shard` pieces): the attention heads
    zero-padded to train_config (serve/sharding.pad_params), then each
    leaf cut by param_placement. Leaves the rank holds whole are shared
    with the input."""
    from repro_torch.serve.sharding import pad_params
    tcfg = train_config(cfg, mesh)
    placement = param_placement(cfg, mesh, fsdp=fsdp)
    skel = {f"group{gi}": [] for gi in range(len(cfg.groups))}
    padded = pad_params({**skel, **params}, tcfg)
    full = {k: padded[k] for k in params}
    coords, sizes = _coords(mesh)
    return tree_map(lambda x, c: local_piece(x, c, coords, sizes), full,
                    _pieces(full, placement))


def draw_train_shard(cfg: ModelConfig, mesh, seed: int, dtype, device, *,
                     fsdp: bool = True):
    """This rank's shard of lm.init_lm(cfg, seed, dtype)'s tree, drawn on
    `device` a piece at a time (each piece drawn whole, its shard kept):
    the bits shard_train_params gives on the whole draw."""
    params = lm.init_lm(cfg, seed=seed, dtype=dtype, device=device,
                        shard=lambda piece: shard_train_params(
                            piece, cfg, mesh, fsdp=fsdp))
    # the final norm is drawn outside the pieces
    norms = {k: v for k, v in params.items() if k.startswith("ln_f")}
    params.update(shard_train_params(norms, cfg, mesh, fsdp=fsdp))
    return params


def unshard(tree, cfg: ModelConfig, mesh, *, fsdp: bool = True):
    """The whole tree (parameters, gradients or moments, shaped as the
    parameters) from every rank's shard: each leaf gathered over the axes
    it is cut on, then the padded heads taken off (cfg's own shapes).
    Every rank gets it."""
    placement = param_placement(cfg, mesh, fsdp=fsdp)
    full = tree_map(lambda x, c: gather_leaf(x, c, mesh), tree,
                    _pieces(tree, placement))
    return unpad_params(full, cfg)


def unpad_params(params, cfg: ModelConfig):
    """The tree with every attention leaf cut back to cfg's own head counts
    (what serve/sharding.pad_params added, taken off)."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    axes = {"wq": (-2, h), "wk": (-2, kv), "wv": (-2, kv), "wo": (-3, h),
            "bq": (-2, h), "bk": (-2, kv), "bv": (-2, kv)}

    def attn(p):
        return {k: (w.narrow(w.dim() + axes[k][0], 0, axes[k][1])
                    if k in axes and w.shape[axes[k][0]] != axes[k][1]
                    else w) for k, w in p.items()}
    out = dict(params)
    for gi in range(len(cfg.groups)):
        out[f"group{gi}"] = [{ln: {k: (attn(v) if k == "attn" else v)
                                   for k, v in layer.items()}
                              for ln, layer in rep.items()}
                             for rep in params[f"group{gi}"]]
    return out


def data_rows(batch: Dict[str, torch.Tensor], mesh,
              microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """A data rank's rows of the global batch: of each of the reference's
    `microbatches` microbatches (contiguous row ranges of the batch), its
    contiguous share, in microbatch order — so splitting the result into
    `microbatches` gives the rank's share of each."""
    nd = shard_ctx.data_size(mesh)
    rows = next(iter(batch.values())).shape[0]
    if rows % (nd * microbatches):
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{microbatches} microbatches over {nd} data ranks")
    if nd == 1:
        return batch
    n = rows // (nd * microbatches)
    d = shard_ctx.data_rank(mesh)
    idx = torch.cat([torch.arange(i * nd * n + d * n, i * nd * n + (d + 1) * n)
                     for i in range(microbatches)])
    return {k: v[idx.to(v.device)] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def make_loss_and_grads(cfg: ModelConfig, *, remat: Optional[str] = "full",
                        q_chunk: int = 1024, kv_chunk: int = 1024,
                        attn_impl: str = "kernel", mesh=None,
                        fsdp: bool = True) -> Callable:
    """(params, batch) -> (loss, grads): lm_loss and its gradient with
    respect to every parameter leaf (grads in the leaves' dtypes). The
    parameters need not require grad: the gradient is taken through
    detached aliases of them. With `mesh` (run it under
    shard_ctx.use(mesh)), `params` are this rank's shards (train_config's
    tree, cut by param_placement(fsdp=fsdp)), `batch` its rows, the loss
    its share of the global mean and each gradient its shard's, summed
    over the data ranks (train/fsdp.py)."""
    acts = {}
    gather = None
    if mesh is not None:
        placement = param_placement(cfg, mesh, fsdp=fsdp)
        gather = gatherer(placement, mesh)
        cfg = train_config(cfg, mesh)

    def loss_and_grads(params, batch):
        dev = batch["tokens"].device
        if dev not in acts:
            acts[dev] = lm.make_act(cfg, dev)
        paths = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for _, p in paths]
        it = iter(leaves)
        alias = tree_map(lambda _: next(it), params)
        loss = lm.lm_loss(alias, cfg, batch, act=acts[dev], q_chunk=q_chunk,
                          kv_chunk=kv_chunk, remat=remat,
                          attn_impl=attn_impl, gather=gather)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    return loss_and_grads


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig, *,
                    remat: Optional[str] = "full", q_chunk: int = 1024,
                    kv_chunk: int = 1024, microbatches: int = 1,
                    attn_impl: str = "kernel", mesh=None,
                    fsdp: bool = True) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters and moments are updated in place (train/optim.py). With
    `microbatches` > 1 the batch splits along its first axis, the gradients
    sum in an f32 accumulator and the loss and gradients are averaged.

    With `mesh` (a launch/mesh.make_mesh (data, model) mesh) `params` and
    `opt_state` are this rank's shards (shard_train_params,
    optim.init_opt_state of the shards; each leaf cut over data only with
    `fsdp`, as param_placement) and `batch` is the global batch:
    the step runs under shard_ctx.use(mesh), takes the rank's rows
    (data_rows), sums the loss's shares over the data axis (every rank
    reports the same bits) and clips by the norm of the whole gradient
    (optim.adamw_update(placement=))."""
    loss_and_grads = make_loss_and_grads(cfg, remat=remat, q_chunk=q_chunk,
                                         kv_chunk=kv_chunk,
                                         attn_impl=attn_impl, mesh=mesh,
                                         fsdp=fsdp)
    placement = (None if mesh is None
                 else param_placement(cfg, mesh, fsdp=fsdp))

    def train_step(params, opt_state, batch):
        with shard_ctx.use(mesh):
            if mesh is not None:
                batch = data_rows(batch, mesh, microbatches)
            if microbatches > 1:
                if batch["tokens"].shape[0] % microbatches:
                    raise ValueError(
                        f"batch of {batch['tokens'].shape[0]} does not "
                        f"split into {microbatches} microbatches")
                parts = {k: v.chunk(microbatches, dim=0)
                         for k, v in batch.items()}
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
                loss = 0.0
                for i in range(microbatches):
                    l, g = loss_and_grads(params, {k: v[i] for k, v
                                                   in parts.items()})
                    tree_map(lambda a, b: a.add_(b), grads, g)
                    loss = loss + l
                    del g
                grads = tree_map(lambda g: g.div_(microbatches), grads)
                loss = loss / microbatches
            else:
                loss, grads = loss_and_grads(params, batch)
            if mesh is not None:
                loss = shard_ctx.sum_data(loss)
            params, opt_state, metrics = optim.adamw_update(
                opt_cfg, params, grads, opt_state, placement=placement)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# The dry run's cells: one rank's shard on the meta device
# ---------------------------------------------------------------------------

class NotPorted(NotImplementedError):
    """A cell, or a feature of one, that the port does not build yet; the
    message names the ROADMAP item that queues it."""


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """One rank's step of an (arch x shape x mesh) cell: `fn(*args)` runs
    it on meta tensors under the cell's CountMesh (run it inside a
    roofline count: it moves no bytes and issues no collective), `cfg` is
    the config the rank computes (its heads padded to the model axis) and
    `memory` the bytes the rank holds: parameters, AdamW moments, caches
    and its rows of the batch."""
    fn: Callable
    args: Tuple
    cfg: ModelConfig
    memory: Dict[str, int]


def _bytes(tree) -> int:
    from repro_torch.roofline import count as rcount
    t = rcount.Totals()
    rcount.add_params(t, tree)
    return int(t.param_bytes)


def _rows(batch: int, mesh) -> int:
    """A data rank's rows of a batch: batch / D where D divides it, else
    all of it (replicated, the reference's divisibility fallback)."""
    nd = shard_ctx.data_size(mesh)
    return batch // nd if batch % nd == 0 else batch


def train_batch_specs(cfg: ModelConfig, shape,
                      dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The global batch of a train cell on the meta device (the step
    takes its rank's rows, data_rows): tokens and labels (b, s) int32,
    and Whisper's frames or LLaVA's patch embeddings (b, n, d_model)."""
    b, s = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, **meta),
             "labels": torch.empty((b, s), dtype=torch.int32, **meta)}
    if cfg.encoder is not None:
        batch["encoder_frames"] = torch.empty(
            (b, cfg.encoder.num_frames, cfg.d_model), dtype=dtype, **meta)
    if cfg.vision is not None:
        batch["patch_embeds"] = torch.empty(
            (b, cfg.vision.num_patches, cfg.d_model), dtype=dtype, **meta)
    return batch


def abstract_caches(cfg: ModelConfig, mesh, batch: int, max_seq: int, *,
                    dtype=torch.bfloat16):
    """A rank's dense caches on the meta device: its data rank's rows of
    `batch` and, over the model axis, its KV heads and SSM share
    (serve/sharding.local_caches); cfg is the rank's (padded) config."""
    from repro_torch.serve.sharding import local_caches
    return lm.init_caches(cfg, _rows(batch, mesh), max_seq, dtype=dtype,
                          device="meta",
                          **local_caches(cfg, shard_ctx.model_size(mesh)))


def make_prefill_step(cfg: ModelConfig, *, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> Callable:
    """(params, tokens, caches, extras) -> (last logits, caches): the
    whole prompt (after LLaVA's patch prefix, with Whisper's frames
    through the encoder) into the dense caches."""
    def prefill_step(params, tokens, caches, extras):
        patches = extras.get("patch_embeds")
        s = tokens.shape[1] + (0 if patches is None else patches.shape[1])
        logits, caches, _ = lm.apply_lm(
            params, cfg, tokens, mode="prefill", caches=caches,
            positions=torch.arange(s, device=tokens.device),
            encoder_frames=extras.get("encoder_frames"),
            patch_embeds=patches, q_chunk=q_chunk, kv_chunk=kv_chunk)
        return logits[:, -1:], caches
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, tokens, caches, extras) -> (logits, caches): one decode
    step over the dense caches (a cross-attention layer reads its cached
    K/V); a data rank's MoE layers route the whole batch (split_rows)."""
    def serve_step(params, tokens, caches, extras):
        del extras
        with shard_ctx.split_rows():
            return lm.decode_step(params, cfg, tokens, caches)
    return serve_step


def _on_mesh(fn: Callable, mesh) -> Callable:
    def run(*args):
        with shard_ctx.use(mesh):
            return fn(*args)
    return run


def build_cell(arch_cfg: ModelConfig, shape, mesh, *, fsdp: bool = True,
               remat: Optional[str] = "full", dtype=torch.bfloat16,
               q_chunk: int = 1024, kv_chunk: int = 1024,
               microbatches: int = 1, pad_heads: bool = False,
               ep_full: bool = False, mla_cache_shard: bool = False,
               rank: Tuple[int, int] = (0, 0)) -> StepBundle:
    """One rank's step of an (arch x shape) cell on a (data, model) mesh
    (`mesh`: a pair, or a shard_ctx.CountMesh), built on the meta device
    without processes: the rank's shard of the parameters (train:
    param_placement's cuts through train/elasticity.shard_shapes, FSDP
    over data with `fsdp`; serving: serve/sharding.shard_params' slice of
    the heads, d_ff, experts and vocabulary), of the AdamW moments and of
    the caches (local_caches), and its rows of the batch. Attention heads
    are always padded to the model axis where they do not divide it (the
    port's one rule, pad_heads_for: `pad_heads` is kept for the
    reference's signature). Raises NotPorted for what the port lacks:
    training MoE, MLA, Mamba-2 or the encoder-decoder over a mesh, the
    sequence-sharded decode cache of long_500k, `ep_full` and
    `mla_cache_shard`."""
    from repro_torch.serve import sharding
    from repro_torch.train import elasticity
    del pad_heads
    if ep_full:
        raise NotPorted("--ep-full (experts over every mesh axis) is not "
                        "ported (ROADMAP A13)")
    if mla_cache_shard:
        raise NotPorted("--mla-cache-shard (the MLA latent cache's sequence "
                        "over model) is not ported (ROADMAP A13)")
    cm = (mesh if isinstance(mesh, shard_ctx.CountMesh)
          else shard_ctx.CountMesh(*mesh, *rank))
    nd, nm = mesh_shape(cm)
    if shape.kind == "train":
        try:
            check_trainable(arch_cfg)
        except NotImplementedError as e:
            raise NotPorted(f"{e} (ROADMAP A11 item 5)") from None
        if train_config(arch_cfg, cm).kv_heads_phys % nm:
            raise NotPorted(
                f"{arch_cfg.name}: {arch_cfg.num_kv_heads} KV heads under a "
                f"model axis of {nm} (heads that divide it are not padded): "
                "a training mesh that replicates KV heads is not ported "
                "(ROADMAP A13)")
        shapes, placement = elasticity.reshard_plan(arch_cfg, (nd, nm),
                                                    fsdp=fsdp, dtype=dtype)
        params = tree_map(lambda x, c: local_piece(
            x, c, (shard_ctx.data_rank(cm), shard_ctx.model_rank(cm)),
            (nd, nm)), shapes, placement)
        opt = optim.init_opt_state(params)
        batch = train_batch_specs(arch_cfg, shape, dtype)
        step = make_train_step(arch_cfg, optim.AdamWConfig(), remat=remat,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               microbatches=microbatches, mesh=cm,
                               fsdp=fsdp)
        rows = {k: _rows(v.shape[0], cm) * (v.numel() // v.shape[0])
                * v.element_size() for k, v in batch.items()}
        return StepBundle(
            fn=step, args=(params, opt, batch), cfg=train_config(arch_cfg, cm),
            memory={"param_bytes": _bytes(params),
                             "moment_bytes": _bytes((opt.m, opt.v)),
                             "cache_bytes": 0,
                             "batch_bytes": sum(rows.values())})
    if shape.kind == "decode" and shape.seq_len >= 262144:
        raise NotPorted("the sequence-sharded decode cache of long_500k "
                        "(shard_seq) is not ported (ROADMAP A13)")
    cfg = sharding.serving_config(arch_cfg, cm)
    params = sharding.shard_params(lm.init_lm(arch_cfg, dtype=dtype,
                                              device="meta"), cfg, cm)
    b = shape.global_batch
    rows = _rows(b, cm)
    meta = dict(device="meta")
    extras: Dict[str, torch.Tensor] = {}
    if shape.kind == "prefill":
        max_seq = shape.seq_len + (cfg.vision.num_patches if cfg.vision
                                   else 0)
        tokens = torch.empty((rows, shape.seq_len), dtype=torch.int32,
                             **meta)
        if cfg.encoder is not None:
            extras["encoder_frames"] = torch.empty(
                (rows, cfg.encoder.num_frames, cfg.d_model), dtype=dtype,
                **meta)
        if cfg.vision is not None:
            extras["patch_embeds"] = torch.empty(
                (rows, cfg.vision.num_patches, cfg.d_model), dtype=dtype,
                **meta)
        fn = make_prefill_step(cfg, q_chunk=q_chunk, kv_chunk=kv_chunk)
    else:
        max_seq = shape.seq_len
        tokens = torch.empty((rows, 1), dtype=torch.int64, **meta)
        fn = make_serve_step(cfg)
    caches = abstract_caches(cfg, cm, b, max_seq, dtype=dtype)
    return StepBundle(
        fn=_on_mesh(fn, cm), args=(params, tokens, caches, extras), cfg=cfg,
        memory={"param_bytes": _bytes(params), "moment_bytes": 0,
                         "cache_bytes": _bytes(caches),
                         "batch_bytes": _bytes((tokens, extras))})
