"""LM assembly for the dense GQA decoders: init, the training forward and
loss, paged prefill chunks and paged decode steps.

Parameters: {"embed", "ln_f_w" (+"ln_f_b"), ["head"], "group{i}": [per
repeat {"l{j}": layer params}]} — the JAX package's tree with each group's
stacked `stack` axis unrolled into a list (models/convert.py maps one to the
other); a leaf may be a packed quant/weights.QuantWeight. Caches: a tuple
per group of per-period-layer PagedKVCache or QuantPagedKVCache pools, each
with a leading repeats axis, exactly the JAX package's pool tree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.nn import blocks
from repro_torch.nn.attention import PagedState, cache_slice
from repro_torch.nn.common import act_fn, init_param
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
            device=None) -> Dict[str, Any]:
    """Random parameters from `seed` with the JAX package's initializers
    (embedding: truncated normal, std 0.02; matrices: fan-in truncated
    normal; norms: zeros for rmsnorm's 1 + w), drawn by a torch.Generator on
    `device` (default: CUDA, see resolve_device)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    kw = dict(device=device, dtype=dtype)
    params: Dict[str, Any] = {
        "embed": init_param((cfg.vocab_size, cfg.d_model), gen,
                            init="normal", scale=0.02, **kw)}
    if not cfg.tie_embeddings:
        params["head"] = init_param((cfg.d_model, cfg.vocab_size), gen, **kw)
    blocks.init_norm(params, "ln_f", cfg.d_model, cfg.norm, **kw)
    for gi, (period, repeats) in enumerate(cfg.groups):
        params[f"group{gi}"] = [
            {f"l{li}": blocks.init_layer(spec, cfg, gen, **kw)
             for li, spec in enumerate(period)}
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
# Forward
# ---------------------------------------------------------------------------

def compute_dtype(params) -> torch.dtype:
    """The activations' dtype: the float embedding's, or, when the embedding
    is packed, the final norm's."""
    embed = params["embed"]
    if isinstance(embed, wq_lib.QuantWeight):
        return params["ln_f_w"].dtype
    return embed.dtype


def _check_remat(remat: Optional[str]) -> None:
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' is XLA's dots_with_no_batch_dims_saveable policy; "
            "the port has only None and 'full' (ROADMAP)")
    if remat not in (None, "full"):
        raise ValueError(f"unknown remat {remat!r}: None or 'full'")


def _hidden(params, cfg: ModelConfig, tokens, *, mode, caches, positions,
            act, paged: Optional[PagedState], paged_impl, attn_quant,
            remat: Optional[str] = None, q_chunk: int = 1024,
            kv_chunk: int = 1024, attn_impl: str = "kernel"):
    """Embed (a packed table dequantizes only the gathered rows) -> layers
    (pools updated in place) -> final norm. The rope tables are built once
    and shared by every layer. In "train" mode (no caches), with
    remat="full" each repeat's body runs under activation checkpointing
    (torch.utils.checkpoint, non-reentrant): only its input is kept and the
    body runs again in the backward pass, as the reference's _run_group
    wraps it in jax.checkpoint."""
    x = wq_lib.take_rows(params["embed"], tokens).to(compute_dtype(params))
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    kw = dict(rope=rope, act=act, mode=mode, paged=paged,
              paged_impl=paged_impl, attn_quant=attn_quant, q_chunk=q_chunk,
              kv_chunk=kv_chunk, attn_impl=attn_impl)
    for gi, (period, repeats) in enumerate(cfg.groups):
        group = params[f"group{gi}"]
        for r in range(repeats):
            if mode == "train":
                def body(h, layer=group[r], period=period):
                    for li, spec in enumerate(period):
                        h, _ = blocks.apply_layer(layer[f"l{li}"], h, spec,
                                                  cfg, **kw)
                    return h
                x = (checkpoint(body, x, use_reentrant=False)
                     if remat == "full" else body(x))
                continue
            for li, spec in enumerate(period):
                x, _ = blocks.apply_layer(
                    group[r][f"l{li}"], x, spec, cfg,
                    cache=cache_slice(caches[gi][li], r), **kw)
    return blocks.apply_norm(params, "ln_f", x, cfg.norm, cfg.norm_eps)


def _head(params, cfg: ModelConfig, x):
    """Logits: tied through the embedding, or an untied head; packed tables
    dequantize through wq_lib.dense (in x's dtype), as in the reference."""
    if cfg.tie_embeddings:
        return x @ wq_lib.dense(params["embed"], x.dtype).t()
    return x @ wq_lib.dense(params["head"], x.dtype)


def apply_lm(params, cfg: ModelConfig, tokens, *, mode: str = "train",
             caches=None, positions=None, paged: Optional[PagedState] = None,
             act=None, paged_impl: str = "kernel", attn_quant=None,
             remat: Optional[str] = None, q_chunk: int = 1024,
             kv_chunk: int = 1024, attn_impl: str = "kernel"):
    """Returns (logits, caches): the training forward over the whole
    sequence (mode="train", no caches, positions [0, s)), or a paged
    "decode" step or "prefill" chunk (the pools in `caches` updated in
    place). `remat` (None | "full") and `attn_impl` ("kernel" | "plain":
    the flash kernel on the card, or the plain scan) apply to "train"."""
    _check_remat(remat)
    act = act or make_act(cfg, tokens.device)
    if mode == "train":
        if caches is not None or paged is not None:
            raise ValueError("mode='train' runs without caches")
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _hidden(params, cfg, tokens, mode=mode, caches=caches,
                positions=positions, act=act, paged=paged,
                paged_impl=paged_impl, attn_quant=attn_quant, remat=remat,
                q_chunk=q_chunk, kv_chunk=kv_chunk, attn_impl=attn_impl)
    return _head(params, cfg, x), caches


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            act=None, q_chunk: int = 1024, kv_chunk: int = 1024,
            remat: Optional[str] = None,
            attn_impl: str = "kernel") -> torch.Tensor:
    """Next-token cross-entropy over batch["tokens"] / batch["labels"]
    (b, s): log-softmax in f32, labels < 0 masked out, the mean over the
    rest. (The reference adds the MoE load-balancing loss; a dense model
    has none.) Only the f32 log-probabilities are kept for the backward,
    not a second f32 copy of the logits."""
    logits, _ = apply_lm(params, cfg, batch["tokens"], mode="train", act=act,
                         q_chunk=q_chunk, kv_chunk=kv_chunk, remat=remat,
                         attn_impl=attn_impl)
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    del logits
    mask = (labels >= 0).to(torch.float32)
    ll = torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def decode_step(params, cfg: ModelConfig, tokens, caches, *,
                paged: PagedState, act=None, paged_impl: str = "kernel",
                attn_quant=None):
    """One serving step: tokens (b, 1) + pools -> (logits (b, 1, vocab),
    pools). Per-slot positions come from `paged.length`;
    `paged.block_table` may be bucket-sliced to the live-block count."""
    positions = paged.length[:, None]
    return apply_lm(params, cfg, tokens, mode="decode", caches=caches,
                    positions=positions, paged=paged, act=act,
                    paged_impl=paged_impl, attn_quant=attn_quant)


def prefill_step(params, cfg: ModelConfig, tokens, caches, *,
                 paged: PagedState, act=None, paged_impl: str = "kernel",
                 attn_quant=None, want_logits: bool = True
                 ) -> Tuple[Optional[torch.Tensor], Any]:
    """One chunk of the chunked-prefill state machine: tokens (b, C) at
    absolute positions paged.length + [0, C), written through the (bucket-
    sliced) table and attending the already-resident prefix blocks plus the
    chunk. Returns (logits at the chunk's last position (b, vocab), pools);
    with want_logits=False the head is skipped and logits is None (the
    engine discards them)."""
    b, s = tokens.shape
    positions = (paged.length[:, None].long()
                 + torch.arange(s, device=tokens.device)[None])
    act = act or make_act(cfg, tokens.device)
    x = _hidden(params, cfg, tokens, mode="prefill", caches=caches,
                positions=positions, act=act, paged=paged,
                paged_impl=paged_impl, attn_quant=attn_quant)
    if not want_logits:
        return None, caches
    return _head(params, cfg, x[:, -1]), caches
