"""Weight-only quantization with power-of-two scales — packed param planes.

A packable tensor designates one contraction axis (the axis a matmul sums
over), indexed from the right. That axis of length K is cut into K // tile
tiles (tile = the largest divisor of K not above 512, so nothing is ever
padded); each (tile, out-channel) gets one signed-byte exponent, and the
payload holds int8 values at 8 bits or split-halves nibbles *within each
tile* at 4 bits (packed row i of a tile holds tile elements i and
i + tile/2). The scale arithmetic is quant/pot.py's, shared with the KV
pools; the bytes are the JAX package's quant/weights.py's, bit for bit.

Which tensors pack (PrecisionPolicy.weight_bits_for; names group{gi}.l{li}
plus embed / head): the attention projections wq/wk/wv/wo, the MLP matmuls
w_gate/w_up/w_down and the vocabulary tensors. Norms and biases stay float.

Routing, as in the reference: the MLP's 2-D weights (contraction axis -2) go
through `matmul`, which launches kernels/matmul_wq.py's CUDA kernel for a
CUDA tensor and runs its plain torch version for a CPU tensor; attention
projections and the tied logits dequantize through `dense`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.quant.pot import (exp2i, pack_int4, pot_exponent,
                                   quantize_pot, unpack_int4)

WEIGHT_BITS = (16, 8, 4)
WQ_TILE_K = 512     # default contraction tile: one exponent per 512 elements


def validate_weight_bits(bits: int) -> None:
    if bits not in WEIGHT_BITS:
        raise ValueError(
            f"weight_bits must be one of {WEIGHT_BITS}, got {bits}")


def effective_tile(kdim: int, tile_k: int = WQ_TILE_K) -> int:
    """Largest divisor of the contraction length <= tile_k (whole K when it
    already fits)."""
    return kdim if kdim <= tile_k else math.gcd(kdim, tile_k)


@dataclasses.dataclass
class QuantWeight:
    """One packed parameter tensor.

    ``q``     int8 payload: the original shape with the contraction axis
              halved at 4 bits (split-halves nibbles within each tile).
    ``e``     int8 exponents: the contraction axis replaced by kdim // tile.
    ``bits``  4 or 8.
    ``caxis`` contraction axis, negative (so per-repeat slices keep it).
    ``kdim``  unpacked contraction length.
    ``tile``  contraction-tile width (divides kdim).
    """
    q: torch.Tensor
    e: torch.Tensor
    bits: int
    caxis: int
    kdim: int
    tile: int

    @property
    def nbytes(self) -> int:
        return _nbytes(self.q) + _nbytes(self.e)

    @property
    def device(self) -> torch.device:
        return self.q.device


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def pack_tensor(w: torch.Tensor, bits: int, caxis: int,
                tile_k: int = WQ_TILE_K) -> QuantWeight:
    """Quantize one tensor onto the 2^e grid along ``caxis``; the exponent
    is per (contraction tile, every other index): amax reduces over the
    tile only."""
    validate_weight_bits(bits)
    if bits == 16:
        raise ValueError("16-bit tensors stay raw float — do not pack them")
    ca = caxis if caxis < 0 else caxis - w.dim()
    k = w.shape[ca]
    t = effective_tile(k, tile_k)
    if bits == 4 and t % 2:
        raise ValueError(
            f"weight_bits=4 packs two values per byte along the contraction "
            f"axis; axis length {k} (tile {t}) is odd — use an even dim or "
            "weight_bits >= 8")
    wt = torch.movedim(w.to(torch.float32), ca, -1)
    lead = wt.shape[:-1]
    wt = wt.reshape(lead + (k // t, t))
    e = pot_exponent(wt.abs().amax(dim=-1), bits)            # (..., k_tiles)
    q = quantize_pot(wt, e[..., None], bits)                 # (..., kt, t)
    if bits == 4:
        q = pack_int4(q)                                     # (..., kt, t//2)
    payload = torch.movedim(q.reshape(lead + (-1,)), -1, ca).contiguous()
    return QuantWeight(q=payload, e=torch.movedim(e, -1, ca).contiguous(),
                       bits=bits, caxis=ca, kdim=k, tile=t)


def dense(w: Any, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dequantized view of a packed tensor in `dtype` (default f32, as
    the reference); identity on raw tensors. Every dequantized value is
    q * 2^e with |q| <= 127, exact in f32 and in bf16."""
    if not isinstance(w, QuantWeight):
        return w
    ca = w.caxis + w.q.dim()
    kt = w.kdim // w.tile
    shape = w.q.shape
    q = w.q.reshape(shape[:ca] + (kt, shape[ca] // kt) + shape[ca + 1:])
    if w.bits == 4:
        q = torch.movedim(unpack_int4(torch.movedim(q, ca + 1, -1)), -1,
                          ca + 1)
    # q * 2^e straight in `dtype`: exact there as in f32 (|q| <= 127, and
    # bf16 has f32's exponent range), without an f32 copy of the table
    out = q.to(dtype) * exp2i(w.e.unsqueeze(ca + 1)).to(dtype)
    return out.reshape(shape[:ca] + (w.kdim,) + shape[ca + 1:])


def take_rows(w: Any, idx: torch.Tensor) -> torch.Tensor:
    """Embedding lookup: gather packed rows + their exponent rows, then
    dequantize only the gathered slice (f32); a plain row gather on raw
    tensors, through F.embedding, whose backward sums each row's gradient
    in a fixed order (indexing's accumulates in thread order on the CPU,
    which makes training runs differ in the last bits)."""
    if not isinstance(w, QuantWeight):
        return torch.nn.functional.embedding(idx.long(), w)
    if w.caxis == -w.q.dim():
        raise ValueError("take_rows needs axis 0 distinct from the packed "
                         f"contraction axis (caxis={w.caxis})")
    sub = QuantWeight(q=w.q[idx.long()], e=w.e[idx.long()], bits=w.bits,
                      caxis=w.caxis, kdim=w.kdim, tile=w.tile)
    return dense(sub)


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` where ``w`` may be packed: a 2-D QuantWeight with
    contraction axis -2 goes to kernels/matmul_wq.matmul_wq (the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors); any other packed
    tensor is dequantized through `dense`."""
    if not isinstance(w, QuantWeight):
        return x @ w
    if w.q.dim() == 2 and w.caxis == -2:
        from repro_torch.kernels.matmul_wq import matmul_wq
        return matmul_wq(x, w)
    return x @ dense(w, x.dtype)


# ---------------------------------------------------------------------------
# Parameter-tree packing under a PrecisionPolicy
# ---------------------------------------------------------------------------

_ATTN_AXES = {"wq": -3, "wk": -3, "wv": -3, "wo": -2}
_MLP_AXES = {"w_gate": -2, "w_up": -2, "w_down": -2}


def weight_bits_by_layer(cfg, policy) -> Dict[str, int]:
    """Per-layer weight bits from the policy (16 everywhere when None)."""
    out: Dict[str, int] = {}
    for gi, (period, _) in enumerate(cfg.groups):
        for li in range(len(period)):
            name = f"group{gi}.l{li}"
            out[name] = policy.weight_bits_for(name) if policy else 16
    out["embed"] = policy.weight_bits_for("embed") if policy else 16
    if not cfg.tie_embeddings:
        out["head"] = policy.weight_bits_for("head") if policy else 16
    return out


def validate_weight_packing(cfg, policy) -> None:
    """Every int4 evenness assumption, checked when the policy is applied,
    with the reference's messages."""
    def _even(dim_name: str, dim: int, where: str):
        if dim % 2:
            raise ValueError(
                f"{cfg.name} ({where}): weight_bits=4 packs two values per "
                f"byte along the contraction axis; {dim_name}={dim} is odd "
                "— pad the model to an even value or use weight_bits >= 8")
    for name, bits in weight_bits_by_layer(cfg, policy).items():
        validate_weight_bits(bits)
        if bits != 4:
            continue
        if name in ("embed", "head"):
            _even("d_model", cfg.d_model, name)
            continue
        gname, lname = name.split(".")
        spec = cfg.groups[int(gname[len("group"):])][0][int(lname[1:])]
        if spec.kind == "attn" and getattr(cfg, "mla", None) is None:
            _even("d_model", cfg.d_model, name)
            _even("head_dim", cfg.head_dim, name)
        if spec.cross_attn:
            _even("d_model", cfg.d_model, name)
            _even("head_dim", cfg.head_dim, name)
        if spec.mlp not in ("none", "moe"):
            _even("d_model", cfg.d_model, name)
            _even("d_ff", cfg.d_ff, name)


def _pack_subtree(sub: dict, axes: Dict[str, int], bits: int,
                  tile_k: int) -> dict:
    out = dict(sub)
    for key, caxis in axes.items():
        if key in out and not isinstance(out[key], QuantWeight):
            out[key] = pack_tensor(out[key], bits, caxis, tile_k)
    return out


def pack_params(params: dict, cfg, policy, tile_k: int = WQ_TILE_K) -> dict:
    """Pack a parameter tree once, per the policy's weight rules. Returns a
    new tree sharing every untouched leaf. Each repeat of a group packs on
    its own: the exponent's amax reduces over the tile only, so this gives
    the same bytes as the reference packing the stacked leaf whole. Leaves
    that are already packed stay as they are."""
    validate_weight_packing(cfg, policy)
    out = dict(params)
    for gi, (period, _) in enumerate(cfg.groups):
        reps = []
        for rep in out[f"group{gi}"]:
            rep = dict(rep)
            for li, spec in enumerate(period):
                bits = policy.weight_bits_for(f"group{gi}.l{li}")
                if bits == 16:
                    continue
                layer = dict(rep[f"l{li}"])
                if spec.kind == "attn" and "attn" in layer:
                    layer["attn"] = _pack_subtree(layer["attn"], _ATTN_AXES,
                                                  bits, tile_k)
                if "mlp" in layer:
                    layer["mlp"] = _pack_subtree(layer["mlp"], _MLP_AXES,
                                                 bits, tile_k)
                rep[f"l{li}"] = layer
            reps.append(rep)
        out[f"group{gi}"] = reps
    for name, caxis in (("embed", -1), ("head", -2)):
        if name not in out or isinstance(out[name], QuantWeight):
            continue
        bits = policy.weight_bits_for(name)
        if bits != 16:
            # embed: caxis = d_model (the tied logits' contraction), so
            # vocabulary rows stay whole for take_rows
            out[name] = pack_tensor(out[name], bits, caxis, tile_k)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def packed_param_bytes(params) -> int:
    """Bytes of the parameter tree as stored (packed payloads + exponent
    planes + float leaves)."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QuantWeight):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += _nbytes(leaf)
    return total
