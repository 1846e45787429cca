"""Analytical hardware cost model — reproduces the paper's Table VI structure.

No Vivado in this container, so we model LUT/FF/latency as explicit functions
of the architectural parameters and *calibrate* the per-primitive coefficients
against the paper's published post-implementation numbers. The driver
(tables/table6_hwcost.py) then reproduces the table and the headline
claims (>90% LUT reduction, pipeline depths, frequency advantage) from the
model rather than from synthesis. Pure Python, the JAX package's
core/hwcost.py as it is.

Primitive cost assumptions (Ultra96-V2, 4-LUT/CARRY8 fabric, b = datapath
width = 24 bits as in the paper's MAC-output range analysis):
  * b-bit comparator          ~ b/2 LUTs (carry-chain compare)
  * b-bit conditional shifter ~ b LUTs (2:1 mux per bit)
  * b-bit adder               ~ b LUTs
  * registers                 1 FF per pipeline bit
Calibrated residuals (control, setting loader, bypass) are fitted so the
model matches Table VI within a few percent and are reported alongside.
"""
from __future__ import annotations

import dataclasses
import math


DATAPATH_BITS = 24  # MAC outputs of 8-bit QNNs reach ~[-1e5, 1e5] (paper §I-B)


@dataclasses.dataclass(frozen=True)
class HWReport:
    name: str
    design: str          # "pipelined" | "serialized"
    lut: int
    ff: int
    freq_mhz: float
    pipeline_depth_8bit: int
    cycles_per_input: dict  # per output precision


# Calibrated against the paper's post-implementation Table VI by least squares
# over {4,6,8} segments x {8,16} exponents (max residual < 1.4%):
#   lut(S, E) = c0 + c_S*S + c_E*E + c_SE*S*E
# The structural reading: c_S = comparator + bias/sign register per segment,
# c_E = one 1-bit shifter stage (PoT) or shifter+accumulator stage (APoT),
# c_SE = per-segment setting-buffer bits that grow with the stage count.
_LUT_COEF = {"pot": (-84.5, 42.75, 27.875, 0.375),
             "apot": (-117.333, 42.0, 38.542, 0.437)}
_FF_COEF = {"pot": (-138.667, 80.5, 35.5, 1.0),
            "apot": (-160.667, 80.5, 42.5, 1.0)}
_SERIAL = {"pot": (270, 456), "apot": (283, 463)}       # paper-measured


def mt_cost(out_bits: int = 8, design: str = "pipelined", b: int = DATAPATH_BITS) -> HWReport:
    """Multi-Threshold unit: 2^n - 1 threshold comparators + registers.

    Pipelined: one b-bit comparator + threshold register + out_bits counter
    slice per stage -> (b + out_bits + 8) LUT/stage, matching the paper's
    10206 at 255 stages exactly.
    """
    n_thresh = (1 << out_bits) - 1
    if design == "pipelined":
        lut = n_thresh * (b + out_bits + 8) + 6
        ff = n_thresh * (b + out_bits + 41) - 2057
        freq = 200.0
    else:
        # one reusable comparator + threshold register file + FSM
        lut = (b // 2) + n_thresh * out_bits + 744
        ff = n_thresh * b + 2144
        freq = 100.0
    depth = n_thresh
    cycles = {1: 1, 2: 3, 4: 15, 8: 255}
    return HWReport("multi-threshold", design, int(lut), int(ff), freq, depth, cycles)


def grau_cost(
    segments: int = 6,
    num_exponents: int = 8,
    mode: str = "pot",
    design: str = "pipelined",
    b: int = DATAPATH_BITS,
) -> HWReport:
    """GRAU: (S-1) comparators + E shifter stages + bias adder + control."""
    n_cmp = segments - 1
    if design == "pipelined":
        c0, cs, ce, cse = _LUT_COEF[mode]
        lut = c0 + cs * segments + ce * num_exponents + cse * segments * num_exponents
        f0, fs, fe, fse = _FF_COEF[mode]
        ff = f0 + fs * segments + fe * num_exponents + fse * segments * num_exponents
        freq = 250.0
        # pre-shift + thresholds + E shifters + sign + bias
        depth = 1 + n_cmp + num_exponents + 1 + 1
        cycles = {1: 1, 2: 3, 4: depth, 8: depth}       # 1/2-bit take the MT bypass
    else:
        lut, ff = _SERIAL[mode]
        freq = 250.0
        depth = num_exponents
        cycles = {1: 1, 2: 3, 4: num_exponents + 4, 8: num_exponents + 4}
    return HWReport(f"{mode}-pwlf", design, int(round(lut)), int(round(ff)),
                    freq, depth, cycles)


# ---------------------------------------------------------------------------
# KV-cache memory / bandwidth accounting (serving-side mixed precision)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVCostReport:
    """Per-precision KV storage and decode-bandwidth terms, all in bytes.

    ``payload_bytes_per_token_layer`` is K+V storage for one position of one
    layer at ``kv_bits``; ``scale_bytes_per_token_layer`` amortizes the
    per-(block, head) power-of-two exponent planes (1 byte each for K and V)
    over the block's positions.  ``gather_bytes_per_step`` is the paged
    decode read traffic for one tick at context ``ctx``.
    """
    kv_bits: int
    payload_bytes_per_token_layer: float
    scale_bytes_per_token_layer: float
    bytes_per_slot: float          # full max_seq reservation, all layers
    pool_bytes: float              # whole pool (num_blocks incl. null)
    gather_bytes_per_step: float   # one decode tick at `ctx`, all layers


def kv_cache_cost(*, num_layers: int, kv_heads: int, head_dim: int,
                  block_size: int, kv_bits: int, slots: int, max_seq: int,
                  ctx: int | None = None,
                  num_blocks: int | None = None) -> KVCostReport:
    """Analytical KV memory/bandwidth model as f(kv_bits).

    One place computes both the paper-style storage table (LUT-cost's memory
    sibling) and the serving numbers launch/serve.py logs at startup: bytes
    per slot, whole-pool bytes, and per-decode-step gathered bytes. 16-bit
    pools store 2-byte floats and no scale plane; 8/4-bit pools store packed
    integer payloads plus one exponent byte per (block, head) per tensor.
    """
    if kv_bits not in (16, 8, 4):
        raise ValueError(f"kv_bits must be 16, 8 or 4, got {kv_bits}")
    payload = 2 * kv_heads * head_dim * kv_bits / 8          # K+V, one token
    scale = 0.0 if kv_bits == 16 else 2 * kv_heads / block_size
    per_token_layer = payload + scale
    blocks_per_slot = -(-max_seq // block_size)
    tokens_per_slot = blocks_per_slot * block_size
    if num_blocks is None:
        num_blocks = slots * blocks_per_slot + 1             # + null block
    ctx = max_seq if ctx is None else ctx
    live_blocks = max(1, -(-ctx // block_size))
    return KVCostReport(
        kv_bits=kv_bits,
        payload_bytes_per_token_layer=payload,
        scale_bytes_per_token_layer=scale,
        bytes_per_slot=tokens_per_slot * per_token_layer * num_layers,
        pool_bytes=num_blocks * block_size * per_token_layer * num_layers,
        gather_bytes_per_step=(slots * live_blocks * block_size
                               * per_token_layer * num_layers),
    )


# ---------------------------------------------------------------------------
# Weight memory / bandwidth accounting (weight-only serving quantization)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WeightCostReport:
    """Per-precision serving-weight storage terms, all in bytes.

    Covers the packable matmul tensors (attention projections, MLP, embedding,
    untied head) at ``weight_bits``.  16-bit rows model the raw f32 serving
    tree (4 bytes/element, no scale planes); 8/4-bit rows model the packed
    power-of-two layout of quant/weights.py: 1 or 0.5 payload bytes per
    element plus one int8 exponent per (contraction tile, out-channel).
    Norms and biases stay f32 at every width and are excluded — they are
    constant across rows and orders of magnitude smaller than the matmuls.
    ``bytes_per_decode_step`` equals ``total_bytes``: decode streams every
    weight once per token, so total weight bytes IS the model-bytes/step
    bandwidth term.
    """
    weight_bits: int
    payload_bytes: float
    scale_bytes: float
    layer_bytes: float             # all decoder layers together
    embed_bytes: float             # embedding (+ head when untied)
    total_bytes: float
    bytes_per_decode_step: float


def _wq_tensor_bytes(k: int, out: int, bits: int, tile_k: int) -> tuple:
    """(payload, scale) bytes for one packed tensor with contraction length
    ``k`` and ``out`` output elements — mirrors quant/weights.pack_tensor:
    payload k*out elements at bits/8 bytes, one exponent byte per
    (tile, out-channel) with the same largest-divisor tile rule."""
    if bits == 16:
        return 4.0 * k * out, 0.0
    t = k if k <= tile_k else math.gcd(k, tile_k)
    return k * out * bits / 8, (k // t) * out


def weight_cost(*, num_layers: int, d_model: int, num_heads: int,
                kv_heads: int, head_dim: int, d_ff: int, gated: bool,
                vocab_size: int, tied: bool, weight_bits: int,
                tile_k: int = 512) -> WeightCostReport:
    """Analytical serving-weight memory model as f(weight_bits).

    The weight-side sibling of :func:`kv_cache_cost`: one place computes the
    startup table launch/serve.py logs (expected bytes at 16/8/4 bits).
    """
    if weight_bits not in (16, 8, 4):
        raise ValueError(f"weight_bits must be 16, 8 or 4, got {weight_bits}")
    # (contraction length, out elements) per tensor.  wo's shape is
    # (heads, head_dim, d_model) with the tile axis on head_dim — each head
    # carries its own scale rows, so its contraction length for the scale
    # plane is head_dim, not heads*head_dim (payload bytes are identical
    # either way; only the exponent count differs).
    qkvo = [(d_model, num_heads * head_dim),        # wq
            (d_model, kv_heads * head_dim),         # wk
            (d_model, kv_heads * head_dim),         # wv
            (head_dim, num_heads * d_model)]        # wo
    mlp = ([(d_model, d_ff)] * (2 if gated else 1)  # w_gate / w_up
           + [(d_ff, d_model)])                     # w_down
    payload = scale = 0.0
    for k, out in qkvo + mlp:
        p, s = _wq_tensor_bytes(k, out, weight_bits, tile_k)
        payload += p * num_layers
        scale += s * num_layers
    layer_bytes = payload + scale
    # embedding packs along d_model (row gather stays packed); the untied
    # head packs along its own contraction axis d_model as well
    embed_tensors = [(d_model, vocab_size)] * (1 if tied else 2)
    embed_bytes = 0.0
    for k, out in embed_tensors:
        p, s = _wq_tensor_bytes(k, out, weight_bits, tile_k)
        payload += p
        scale += s
        embed_bytes += p + s
    total = layer_bytes + embed_bytes
    return WeightCostReport(
        weight_bits=weight_bits,
        payload_bytes=payload,
        scale_bytes=scale,
        layer_bytes=layer_bytes,
        embed_bytes=embed_bytes,
        total_bytes=total,
        bytes_per_decode_step=total,
    )


def adp(report: HWReport, delay_ns: float) -> float:
    return report.lut * delay_ns


def pdp(power_w: float, delay_ns: float) -> float:
    return power_w * delay_ns


# Paper's Table VI rows for calibration/validation (LUT, FF, freq, depth@8bit)
PAPER_TABLE6 = {
    ("multi-threshold", "pipelined"): dict(lut=10206, ff=18568, freq=200, depth=255),
    ("multi-threshold", "serialized"): dict(lut=2796, ff=8264, freq=100, depth=255),
    ("pot-pwlf", "pipelined", 4, 8): dict(lut=324, ff=500),
    ("pot-pwlf", "pipelined", 4, 16): dict(lut=560, ff=816),
    ("pot-pwlf", "pipelined", 6, 8): dict(lut=408, ff=675),
    ("pot-pwlf", "pipelined", 6, 16): dict(lut=647, ff=1007),
    ("pot-pwlf", "pipelined", 8, 8): dict(lut=507, ff=854),
    ("pot-pwlf", "pipelined", 8, 16): dict(lut=755, ff=1202),
    ("pot-pwlf", "serialized"): dict(lut=270, ff=456),
    ("apot-pwlf", "pipelined", 4, 8): dict(lut=376, ff=534),
    ("apot-pwlf", "pipelined", 4, 16): dict(lut=699, ff=906),
    ("apot-pwlf", "pipelined", 6, 8): dict(lut=458, ff=709),
    ("apot-pwlf", "pipelined", 6, 16): dict(lut=786, ff=1097),
    ("apot-pwlf", "pipelined", 8, 8): dict(lut=558, ff=888),
    ("apot-pwlf", "pipelined", 8, 16): dict(lut=895, ff=1292),
    ("apot-pwlf", "serialized"): dict(lut=283, ff=463),
}
