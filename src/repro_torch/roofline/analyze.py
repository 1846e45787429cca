"""Roofline analysis: three terms from a count of the work (count.py).

  compute    = operations / peak rate of their type
  memory     = bytes read and written / the memory rate
  collective = collective bytes / the link rate

The counterpart of the JAX package's roofline/analyze.py, against the
H100 SXM's published peaks in place of the TPU's. A count is of one rank
(count.py counts what this process runs), so no term is divided by the
number of cards, as in the reference, whose HLO totals are per device.
The reference's collective_bytes_from_hlo / collective_breakdown read
compiled HLO; the port has none to read: count.Totals.collective_by_op is
their counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A card's published peaks, at the power limit named."""
    name: str
    power_limit_w: float
    bytes_per_s: float              # device memory
    link_bytes_per_s: float         # one direction, all links of the card
    ops_per_s: Mapping[str, float]  # dense, by operand type


# The H100 SXM data sheet (NVIDIA H100 Tensor Core GPU, SXM5 80 GB column),
# at its 700 W power limit: a card set below it runs slower under load, so
# every measurement is printed beside the card's own limit.
H100 = Peaks(
    name="NVIDIA H100 80GB HBM3",
    power_limit_w=700.0,
    bytes_per_s=3.35e12,            # HBM3
    # NVLink 4: 900 GB/s a card, both directions together (18 links)
    link_bytes_per_s=450e9,
    ops_per_s={
        "bf16": 989e12,             # tensor cores, dense
        "int8": 1979e12,            # tensor cores, dense
        "f32": 67e12,               # FP32 on the CUDA cores
        "f64": 34e12,               # FP64 on the CUDA cores
        # the data sheet has no int32 entry: 64 INT32 lanes per SM x 132
        # SMs x the 1.98 GHz boost clock, one operation a lane a cycle (a
        # compare, a shift, a select or an add is one operation)
        "int32": 16.7e12,
    })


def bound(nbytes: float, ops: float, kind: str):
    """(ms, "bytes" or "operations"): the least time the H100 takes to
    move `nbytes` (each input read once, each output written once) and do
    `ops` operations of type `kind`, whichever is longer."""
    t_bytes = nbytes / H100.bytes_per_s * 1e3
    t_ops = ops / H100.ops_per_s[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_terms(*, flops: float, bytes_accessed: float,
                   collective_bytes: float, chips: int,
                   ops_by_kind: Optional[Mapping[str, float]] = None
                   ) -> Dict[str, float]:
    """All terms in seconds, per step and per rank (the count is a rank's),
    and the dominant one ("compute", "memory" or "collective"). The compute
    term takes `ops_by_kind` (operations by type, count.Totals) where given,
    else `flops` at the bf16 tensor-core peak. `chips` is kept for the
    reference's signature: nothing is divided by it."""
    del chips
    if ops_by_kind:
        t_compute = sum(n / H100.ops_per_s[k] for k, n in ops_by_kind.items())
    else:
        t_compute = flops / H100.ops_per_s["bf16"]
    terms = {"compute_s": t_compute,
             "memory_s": bytes_accessed / H100.bytes_per_s,
             "collective_s": collective_bytes / H100.link_bytes_per_s}
    dominant = max(terms, key=terms.get)
    return {**terms, "bound_s": terms[dominant],
            "dominant": dominant.replace("_s", "")}


def model_flops(n_params: float, tokens: float, *,
                training: bool = True) -> float:
    """6·N·D for a train step (forward and backward), 2·N·D for
    inference."""
    return (6.0 if training else 2.0) * n_params * tokens


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of a dense GQA decoder (no remat
    recompute): 6 per parameter and token for the projections, MLP and
    tied head, and the causal attention's 4 b h s^2 d / 2 forward times 3
    (forward and the two-product backward)."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
                 + 3 * d * cfg.d_ff)
    matmul = 6 * batch * seq * (cfg.num_layers * per_layer
                                + d * cfg.vocab_size)
    attn = 3 * cfg.num_layers * 4 * batch * cfg.num_heads * seq * seq * hd / 2
    return matmul + attn
