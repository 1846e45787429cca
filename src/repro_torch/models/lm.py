"""LM assembly for every arch family (GQA or MLA decoders with dense or
Mixture-of-Experts MLPs, Mamba-2 and hybrid stacks, Whisper's
encoder-decoder, an optional vision-stub prefix): init, the training forward
and loss, the dense caches, dense prefill and decode, paged prefill chunks
and paged decode steps.

Parameters: {"embed", "ln_f_w" (+"ln_f_b"), ["head"], ["encoder": {"layers":
[per-layer params], "ln_enc_w" (+"ln_enc_b")}], "group{i}": [per repeat
{"l{j}": layer params}]} — the JAX package's tree with each stacked axis
unrolled into a list (models/convert.py maps one to the other); a leaf may
be a packed quant/weights.QuantWeight. Caches: a tuple per group of
per-period-layer leaves, each with a leading repeats axis, exactly the JAX
package's tree — PagedKVCache or QuantPagedKVCache pools (the paged
backend), or dense KVCache / MLACache / SSMState leaves, a cross-attention
layer's a (self cache, CrossKV) pair (init_caches).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models.config import ModelConfig
from repro_torch.nn import blocks, shard_ctx
from repro_torch.nn.attention import (NULL_BLOCK, CrossKV, KVCache, MLACache,
                                      PagedState, cache_slice, pool_tensors,
                                      write_gathered)
from repro_torch.nn.common import act_fn, init_param
from repro_torch.nn.mamba2 import SSMState
from repro_torch.nn.rope import rope_tables
from repro_torch.quant import weights as wq_lib


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU: with
    no device given they use CUDA and raise if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' explicitly to run "
                "on the host (the port never falls back to the CPU quietly)")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
            device=None, shard=None) -> Dict[str, Any]:
    """Random parameters from `seed` with the JAX package's initializers
    (embedding: truncated normal, std 0.02; matrices: fan-in truncated
    normal; norms: zeros for rmsnorm's 1 + w), drawn by a torch.Generator on
    `device` (default: CUDA, see resolve_device). `shard` maps each piece
    as it is drawn — a tree holding only the embedding, the head, one
    encoder layer or one repeat of a group — to what is kept of it
    (serve/sharding.draw_shard, launch/steps.draw_train_shard: a mesh
    rank's slice, the rest freed); the norms are kept as drawn (a training
    mesh cuts them afterwards). On device "meta" the tree's shapes and
    dtypes are built without drawing."""
    device = resolve_device(device)
    gen = None      # the meta device draws nothing: shapes only
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    kw = dict(device=device, dtype=dtype)

    def keep(piece):
        return piece if shard is None else shard(piece)
    params: Dict[str, Any] = keep({
        "embed": init_param((cfg.vocab_size, cfg.d_model), gen,
                            init="normal", scale=0.02, **kw)})
    if not cfg.tie_embeddings:
        params.update(keep({"head": init_param((cfg.d_model, cfg.vocab_size),
                                               gen, **kw)}))
    blocks.init_norm(params, "ln_f", cfg.d_model, cfg.norm, **kw)
    if cfg.encoder is not None:
        spec = blocks.LayerSpec(kind="attn", mlp="dense")
        enc = {"layers": [keep({"encoder": {"layers": [blocks.init_layer(
            spec, cfg, gen, **kw)]}})["encoder"]["layers"][0]
            for _ in range(cfg.encoder.num_layers)]}
        blocks.init_norm(enc, "ln_enc", cfg.d_model, cfg.norm, **kw)
        params["encoder"] = enc
    for gi, (period, repeats) in enumerate(cfg.groups):
        params[f"group{gi}"] = [
            keep({f"group{gi}": [{f"l{li}": blocks.init_layer(
                spec, cfg, gen, **kw) for li, spec in enumerate(period)}]})[
                    f"group{gi}"][0]
            for _ in range(repeats)]
    return params


def make_act(cfg: ModelConfig, device):
    """The MLP activation: exact float, or the GRAU QAT surrogate whose
    register file is fitted on the host and placed on `device` once (the
    caller's device: there is no host default)."""
    if cfg.grau is None:
        return act_fn(cfg.activation)
    from repro_torch.nn.common import build_lm_grau
    g = cfg.grau
    return build_lm_grau(cfg.activation, segments=g.segments,
                         num_exponents=g.num_exponents, mode=g.mode,
                         out_bits=g.out_bits,
                         bias_mode=g.bias_mode).to(device)


# ---------------------------------------------------------------------------
# Dense caches
# ---------------------------------------------------------------------------

def _layer_cache(spec, cfg: ModelConfig, lead: Tuple[int, ...], max_seq: int,
                 length: int, dtype, device, kvh: int,
                 ssm_share: Optional[Tuple[int, int]]):
    """One period-layer's dense cache, each tensor with leading dims
    `lead` (repeats, batch): an SSM state of `ssm_share` (heads, groups),
    an MLA latent cache or a KVCache of `kvh` heads."""
    kw = dict(dtype=dtype, device=device)
    lengths = torch.full(lead, length, dtype=torch.int32, device=device)
    if spec.kind == "mamba":
        s = cfg.ssm
        h, g = ssm_share or (s.n_heads(cfg.d_model), s.n_groups)
        conv_dim = h * s.head_dim + 2 * g * s.d_state
        return SSMState(
            conv=torch.zeros(lead + (s.conv_width - 1, conv_dim), **kw),
            ssm=torch.zeros(lead + (h, s.head_dim, s.d_state),
                            dtype=torch.float32, device=device))
    if cfg.mla is not None:
        m = cfg.mla
        return MLACache(
            ckv=torch.zeros(lead + (max_seq, m.kv_lora_rank), **kw),
            k_rope=torch.zeros(lead + (max_seq, m.qk_rope_dim), **kw),
            length=lengths)
    shape = lead + (max_seq, kvh, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw),
                   length=lengths)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                length: int = 0, dtype=torch.bfloat16, device=None,
                policy=None, kv_heads: Optional[int] = None,
                ssm_share: Optional[Tuple[int, int]] = None):
    """The dense cache tree on `device` (default: CUDA, see
    resolve_device): a tuple per group of per-period-layer leaves stacked
    over repeats; cross-attention layers carry (self cache, CrossKV) pairs.
    Attention caches hold `kv_heads` heads and SSM states `ssm_share`
    (heads, groups): a serving-mesh rank's local counts
    (serve/sharding.local_caches), by default the whole model's.
    Dense caches hold float KV only (SSM state is recurrent and MLA latents
    are already compressed: neither pages, so neither quantizes): a policy
    that quantizes any layer's KV is rejected, as in the reference."""
    if policy is not None and policy.kv_quantized:
        raise ValueError(
            f"{cfg.name}: dense caches cannot hold quantized KV "
            "(kv_bits < 16); use the paged backend "
            "(serve/kv_cache.init_paged_caches) with this policy")
    device = resolve_device(device)
    kvh = cfg.kv_heads_phys if kv_heads is None else int(kv_heads)
    caches = []
    for period, repeats in cfg.groups:
        lead = (repeats, batch)
        per_layer = []
        for spec in period:
            c = _layer_cache(spec, cfg, lead, max_seq, length, dtype, device,
                             kvh, ssm_share)
            if spec.cross_attn:
                shape = lead + (cfg.encoder.num_frames, kvh, cfg.head_dim)
                c = (c, CrossKV(
                    k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device)))
            per_layer.append(c)
        caches.append(tuple(per_layer))
    return tuple(caches)


def dense_leaves(caches):
    """Every dense cache leaf of the tree (pairs flattened)."""
    for group in caches:
        for c in group:
            yield from (c if isinstance(c, tuple)
                        and not hasattr(c, "_fields") else (c,))


def set_cache_lengths(caches, lengths: torch.Tensor):
    """Override (in place) the valid-prefix `length` of every seq-indexed
    cache leaf: after bucket-padded prefill only `lengths` (b,) positions
    a row hold real tokens."""
    for c in dense_leaves(caches):
        if isinstance(c, (KVCache, MLACache)):
            c.length.copy_(lengths.to(c.length.dtype).expand_as(c.length))
    return caches


def _cache_positions(caches, batch: int, device) -> torch.Tensor:
    """Each row's decode position (b, 1): the `length` of the first
    seq-indexed cache (every layer's is the same), or zeros for a model
    with none (an SSM stack has no rope)."""
    for c in dense_leaves(caches):
        if isinstance(c, (KVCache, MLACache)):
            return c.length[0][:, None].long().clone()
    return torch.zeros((batch, 1), dtype=torch.long, device=device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def compute_dtype(params) -> torch.dtype:
    """The activations' dtype: the float embedding's, or, when the embedding
    is packed, the final norm's."""
    embed = params["embed"]
    if isinstance(embed, wq_lib.QuantWeight):
        return params["ln_f_w"].dtype
    return embed.dtype


REMATS = (None, "full", "dots")

# remat "dots": the ops whose outputs are kept for the backward pass, as
# XLA's dots_with_no_batch_dims_saveable keeps the dots without batch
# dimensions. Every 2-D product of the layers is aten.mm (a 3-D x @ w folds
# its leading axes into mm's rows) or addmm; bmm (the plain attention's
# batched products), the flash kernel's Function, the norms, rope, the MLP
# activation (the GRAU surrogate) and the mesh's collectives recompute.
DOTS_SAVED = (torch.ops.aten.mm, torch.ops.aten.addmm)


def _dots_policy(ctx, func, *args, **kwargs):
    if getattr(func, "_overloadpacket", None) in DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _check_remat(remat: Optional[str]) -> None:
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}: None, 'full' or 'dots'")


def _remat(body: Callable, x, remat: Optional[str]):
    """body(x) under activation checkpointing (torch.utils.checkpoint,
    non-reentrant): "full" keeps only x and runs the body again in the
    backward pass (the reference's jax.checkpoint); "dots" also keeps the
    outputs of its mm / addmm products (selective checkpointing with
    DOTS_SAVED, the reference's dots_with_no_batch_dims_saveable) and
    recomputes the rest; None runs it plainly. The recomputation runs on
    autograd's thread (a CUDA backward's own), so the body runs under the
    shard_ctx context of the forward's thread (a mesh's collectives)."""
    if remat is None:
        return body(x)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    snap = shard_ctx.snapshot()

    def run(h):
        with shard_ctx.restored(snap):
            return body(h)
    return checkpoint(run, x, use_reentrant=False, **kw)


def _rope_dim(cfg: ModelConfig) -> int:
    """The rotated width: MLA's rope part, else the whole head."""
    return cfg.mla.qk_rope_dim if cfg.mla is not None else cfg.head_dim


def _embed(embed, cfg: ModelConfig, tokens):
    """The embedding lookup (a packed table dequantizes only the gathered
    rows). Under a serving mesh whose model axis splits the vocabulary,
    vocab-parallel: each rank looks up the tokens in its own range of rows,
    zeroes the others, and the ranks' rows are summed (exactly: one
    nonzero term a token)."""
    m = shard_ctx.model_size()
    if m == 1 or not shard_ctx.vocab_splits(cfg.vocab_size, m):
        return wq_lib.take_rows(embed, tokens)
    n = cfg.vocab_size // m
    local = tokens.long() - shard_ctx.model_rank() * n
    mine = (local >= 0) & (local < n)
    rows = wq_lib.take_rows(embed, torch.where(mine, local, 0))
    return shard_ctx.reduce_model(
        torch.where(mine[..., None], rows, torch.zeros_like(rows)))


def _hidden(params, cfg: ModelConfig, tokens, *, mode, caches, positions,
            act, paged: Optional[PagedState], paged_impl, attn_quant,
            remat: Optional[str] = None, q_chunk: int = 1024,
            kv_chunk: int = 1024, attn_impl: str = "kernel",
            patch_embeds=None, encoder_out=None,
            gather: Optional[Callable] = None):
    """Embed (a packed table dequantizes only the gathered rows; LLaVA's
    `patch_embeds` (b, patches, d) go before the tokens, cast to their
    dtype) -> layers (caches updated in place; cross-attention layers read
    `encoder_out`) -> final norm. Returns (x, aux): aux is the MoE layers'
    router losses summed, or 0.0 when no layer has one. The rope tables are
    built once and shared by every layer. In "train" mode (no caches), with
    remat "full" or "dots" each repeat's body runs under activation
    checkpointing (_remat), as the reference's _run_group wraps it in
    jax.checkpoint. `gather` (training over a mesh, train/fsdp.py) maps a
    repeat's layer shards to the layers it computes with: it runs inside
    the body, so under remat the layer is gathered again in the backward
    pass and one repeat's whole weights are live at a time."""
    x = _embed(params["embed"], cfg, tokens).to(compute_dtype(params))
    if patch_embeds is not None:
        # a replicated input under a serving mesh, as the tokens are
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    rope = rope_tables(positions, _rope_dim(cfg), cfg.rope_theta)
    kw = dict(rope=rope, act=act, mode=mode, paged=paged,
              paged_impl=paged_impl, attn_quant=attn_quant, q_chunk=q_chunk,
              kv_chunk=kv_chunk, attn_impl=attn_impl,
              encoder_out=encoder_out)
    aux = 0.0
    for gi, (period, repeats) in enumerate(cfg.groups):
        group = params[f"group{gi}"]
        for r in range(repeats):
            if mode == "train":
                def body(h, layer=group[r], period=period, gi=gi):
                    if gather is not None:
                        layer = gather(layer, f"group{gi}")
                    total = 0.0
                    for li, spec in enumerate(period):
                        h, _, a = blocks.apply_layer(layer[f"l{li}"], h,
                                                     spec, cfg, **kw)
                        total = total + a
                    return h, total
                x, a = _remat(body, x, remat)
                aux = aux + a
                continue
            for li, spec in enumerate(period):
                x, _, a = blocks.apply_layer(
                    group[r][f"l{li}"], x, spec, cfg,
                    cache=cache_slice(caches[gi][li], r), **kw)
                aux = aux + a
    return blocks.apply_norm(params, "ln_f", x, cfg.norm, cfg.norm_eps), aux


def run_encoder(params, cfg: ModelConfig, frames, *, act=None,
                q_chunk: int = 1024, kv_chunk: int = 1024,
                attn_impl: str = "kernel") -> torch.Tensor:
    """Whisper's encoder stack over the stub frames (b, frames, d), cast to
    the model's activation dtype: bidirectional self-attention (rope at
    positions [0, frames), no causal mask: the flash kernel on the card)
    and a dense MLP a layer, then the final encoder norm. Under a serving
    mesh the layers are tensor-parallel as the decoder's are, and the
    output, reduced, is replicated."""
    act = act or make_act(cfg, frames.device)
    enc = params["encoder"]
    e = frames.to(compute_dtype(params))
    rope = rope_tables(torch.arange(e.shape[1], device=e.device),
                       cfg.head_dim, cfg.rope_theta)
    for layer in enc["layers"]:
        hn = blocks.apply_norm(layer, "ln1", e, cfg.norm, cfg.norm_eps)
        a, _ = blocks.apply_attention(layer["attn"], hn, cfg, rope=rope,
                                      causal=False, q_chunk=q_chunk,
                                      kv_chunk=kv_chunk, attn_impl=attn_impl)
        e = e + a
        hn = blocks.apply_norm(layer, "ln2", e, cfg.norm, cfg.norm_eps)
        e = e + blocks.apply_mlp(layer["mlp"], hn, act, cfg.gated_mlp,
                                 blocks.mlp_reduce(cfg, layer["mlp"]))
    return blocks.apply_norm(enc, "ln_enc", e, cfg.norm, cfg.norm_eps)


def _head(params, cfg: ModelConfig, x):
    """Logits: tied through the embedding, or an untied head; packed tables
    dequantize through wq_lib.dense (in x's dtype), as in the reference.
    Under a mesh that splits the vocabulary each rank computes its shard
    and the shards are gathered: every rank gets the full logits (in
    training the replicated x enters the shard through
    shard_ctx.enter_model)."""
    split = shard_ctx.active_mesh() is not None and shard_ctx.vocab_splits(
        cfg.vocab_size, shard_ctx.model_size())
    if split:
        x = shard_ctx.enter_model(x)
    if cfg.tie_embeddings:
        logits = x @ wq_lib.dense(params["embed"], x.dtype).t()
    else:
        logits = x @ wq_lib.dense(params["head"], x.dtype)
    if split:
        logits = shard_ctx.gather_vocab(logits)
    return logits


def _encoder_out(params, cfg: ModelConfig, encoder_frames, encoder_out, *,
                 act, q_chunk, kv_chunk, attn_impl):
    """The encoder's output for an enc-dec model: given, or run over
    `encoder_frames`; None for a decoder-only model."""
    if cfg.encoder is None or encoder_out is not None:
        return encoder_out
    if encoder_frames is None:
        raise ValueError(f"{cfg.name}: an enc-dec forward needs "
                         "encoder_frames (or encoder_out)")
    return run_encoder(params, cfg, encoder_frames, act=act, q_chunk=q_chunk,
                       kv_chunk=kv_chunk, attn_impl=attn_impl)


def apply_lm(params, cfg: ModelConfig, tokens, *, mode: str = "train",
             caches=None, positions=None, paged: Optional[PagedState] = None,
             act=None, paged_impl: str = "kernel", attn_quant=None,
             remat: Optional[str] = None, q_chunk: int = 1024,
             kv_chunk: int = 1024, attn_impl: str = "kernel",
             patch_embeds=None, encoder_frames=None, encoder_out=None,
             gather: Optional[Callable] = None):
    """Returns (logits, caches, aux_loss): the training forward over the
    whole sequence (mode="train", no caches, positions [0, s) over the
    patch prefix and the tokens), or a "decode" step or "prefill" pass
    (the caches updated in place). An enc-dec model runs its encoder over
    `encoder_frames` unless `encoder_out` is given, or unless it decodes
    from caches (the cross K/V are cached). aux_loss is the MoE router
    losses' sum (0.0 for a dense model). `remat` (None | "full" | "dots"),
    `attn_impl` ("kernel" | "plain": the flash kernel on the card, or the
    plain scan) and `gather` apply to "train": under a training mesh
    `params` are a rank's shards and gather(tree, where) gives the
    parameters a piece computes with — the top-level leaves (where None)
    here, each repeat's layers (where "group{i}") inside its body."""
    _check_remat(remat)
    act = act or make_act(cfg, tokens.device)
    if mode == "train":
        if caches is not None or paged is not None:
            raise ValueError("mode='train' runs without caches")
        if gather is not None:
            top = {k: v for k, v in params.items()
                   if not k.startswith("group") and k != "encoder"}
            params = {**params, **gather(top, None)}
        if positions is None:
            s = tokens.shape[1] + (0 if patch_embeds is None
                                   else patch_embeds.shape[1])
            positions = torch.arange(s, device=tokens.device)
    if not (mode == "decode" and caches is not None):
        encoder_out = _encoder_out(params, cfg, encoder_frames, encoder_out,
                                   act=act, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk, attn_impl=attn_impl)
    x, aux = _hidden(params, cfg, tokens, mode=mode, caches=caches,
                     positions=positions, act=act, paged=paged,
                     paged_impl=paged_impl, attn_quant=attn_quant,
                     remat=remat, q_chunk=q_chunk, kv_chunk=kv_chunk,
                     attn_impl=attn_impl, patch_embeds=patch_embeds,
                     encoder_out=encoder_out, gather=gather)
    return _head(params, cfg, x), caches, aux


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            act=None, q_chunk: int = 1024, kv_chunk: int = 1024,
            remat: Optional[str] = None,
            attn_impl: str = "kernel",
            gather: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross-entropy over batch["tokens"] / batch["labels"]
    (b, s), plus the MoE router's load-balancing loss: log-softmax in f32
    over the last labels.shape[1] positions (a vision prefix,
    batch["patch_embeds"], carries no labels; Whisper's encoder reads
    batch["encoder_frames"]), labels < 0 masked out, the mean over the
    rest. Only the f32 log-probabilities are kept for the backward, not a
    second f32 copy of the logits. Under a training mesh the batch is a
    data rank's rows and the count of the mean is summed over the data
    axis (shard_ctx.sum_data): the loss is this rank's share of the global
    mean, and the data ranks' shares sum to it."""
    logits, _, aux = apply_lm(params, cfg, batch["tokens"], mode="train",
                              act=act, q_chunk=q_chunk, kv_chunk=kv_chunk,
                              remat=remat, attn_impl=attn_impl,
                              patch_embeds=batch.get("patch_embeds"),
                              encoder_frames=batch.get("encoder_frames"),
                              gather=gather)
    labels = batch["labels"]
    logp = torch.log_softmax(logits[:, -labels.shape[1]:].float(), dim=-1)
    del logits
    mask = (labels >= 0).to(torch.float32)
    ll = torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    count = shard_ctx.sum_data(mask.sum())
    return -(ll * mask).sum() / torch.clamp(count, min=1.0) + aux


def decode_step(params, cfg: ModelConfig, tokens, caches, *,
                paged: Optional[PagedState] = None, act=None,
                paged_impl: str = "kernel", attn_quant=None,
                write_back: Optional[PagedState] = None):
    """One serving step: tokens (b, 1) + caches -> (logits (b, 1, vocab),
    caches), the caches updated in place. With `paged`, the caches are the
    paged pools, per-slot positions come from `paged.length` and
    `paged.block_table` may be bucket-sliced to the live-block count;
    without it they are the dense caches and each row's position is its
    cache `length`. A cross-attention layer reads its cached K/V. An MoE
    layer runs at full capacity (no token dropped); its router loss is not
    returned.

    `write_back` (paged, a data rank under a serving mesh): `tokens` and
    `paged` are this rank's range of the slots (its rows of the table, a
    column slice of the whole table, so the kernel cuts each slot's
    sequence where the unsharded launch does), and `write_back` is the
    whole slot batch's state. Each layer writes the rank's new K/V before
    attending, as the unsharded forward does; after the forward the null
    block, which idle slots write, is put back as it was, one all-gather
    over the data axis brings every slot's rows from its own rank, and
    every pool takes them in slot order through the same write
    (nn/attention.write_gathered), so every data rank's pools hold the
    same bytes."""
    if paged is not None:
        positions = paged.length[:, None]
    else:
        positions = _cache_positions(caches, tokens.shape[0], tokens.device)
    log = saved = None
    if write_back is not None:
        log = []
        saved = [(t, t[:, NULL_BLOCK].clone()) for t in pool_tensors(caches)]
    with shard_ctx.record_writes(log):
        logits, caches, _ = apply_lm(params, cfg, tokens, mode="decode",
                                     caches=caches, positions=positions,
                                     paged=paged, act=act,
                                     paged_impl=paged_impl,
                                     attn_quant=attn_quant)
    if write_back is not None:
        for t, null in saved:
            t[:, NULL_BLOCK] = null
        write_gathered(log, write_back)
    return logits, caches


def prefill_step(params, cfg: ModelConfig, tokens, caches, *,
                 paged: Optional[PagedState] = None, true_length=None,
                 act=None, encoder_frames=None, paged_impl: str = "kernel",
                 attn_quant=None, want_logits: bool = True,
                 q_chunk: int = 1024, kv_chunk: int = 1024,
                 attn_impl: str = "kernel"
                 ) -> Tuple[Optional[torch.Tensor], Any]:
    """Prompt ingestion. Returns (logits (b, vocab), caches), the caches
    filled in place; with want_logits=False the head is skipped and logits
    is None.

    With `paged`: one chunk of the chunked-prefill state machine, tokens
    (b, C) at absolute positions paged.length + [0, C), written through
    the (bucket-sliced) table and attending the already-resident prefix
    blocks plus the chunk; the logits are the chunk's last position's.

    Without it: the whole prompt into dense caches, tokens (b, s) at
    positions [0, s), right-padded to a bucket length; `true_length` (b,)
    marks the real prefix (padding is causally downstream of every real
    token, and the cache lengths are set to it so decode masks the rest)
    and the logits are the last real position's. An enc-dec model runs its
    encoder over `encoder_frames` and fills the cross K/V. Bucket padding
    is sound only for attention caches: recurrent (SSM) state absorbs
    padded tokens, so SSM-bearing archs are prefilled at exact length (the
    engine does so). `attn_impl` picks the flash kernel ("kernel", on the
    card) or the plain scan ("plain") for the dense path's attention."""
    b, s = tokens.shape
    act = act or make_act(cfg, tokens.device)
    if paged is not None:
        positions = (paged.length[:, None].long()
                     + torch.arange(s, device=tokens.device)[None])
        x, _ = _hidden(params, cfg, tokens, mode="prefill", caches=caches,
                       positions=positions, act=act, paged=paged,
                       paged_impl=paged_impl, attn_quant=attn_quant)
        if not want_logits:
            return None, caches
        return _head(params, cfg, x[:, -1]), caches
    encoder_out = _encoder_out(params, cfg, encoder_frames, None, act=act,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               attn_impl=attn_impl)
    x, _ = _hidden(params, cfg, tokens, mode="prefill", caches=caches,
                   positions=torch.arange(s, device=tokens.device), act=act,
                   paged=None, paged_impl=paged_impl, attn_quant=None,
                   q_chunk=q_chunk, kv_chunk=kv_chunk, attn_impl=attn_impl,
                   encoder_out=encoder_out)
    if true_length is None:
        last = x[:, -1]
    else:
        idx = torch.clamp(true_length.long() - 1, 0, s - 1)
        last = x[torch.arange(b, device=x.device), idx]
        set_cache_lengths(caches, true_length)
    return (_head(params, cfg, last) if want_logits else None), caches
