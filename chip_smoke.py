#!/usr/bin/env python3
"""Check that the PyTorch port runs on one CUDA card, through its own kernels.

    python3 chip_smoke.py [--seed N] [--out report.json]

Phases (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi); build every CUDA kernel
     of the port from src/repro_torch/csrc (one nvcc per source, in
     parallel) and print the build seconds and the ptxas report;
  2. kernels: each wrapper runs on the card at the main path's shapes and is
     held against its plain torch version on the same inputs — the GRAU unit
     bit-exact; paged decode / chunked prefill on 16-, 8- and 4-bit KV
     pools (and the bf16 decode and prefill split over several sequence
     parts, each also against a float64 attention) and matmul_wq (int4 /
     int8 weights, the llama3.2-3b MLP shapes at 8 and 32 rows) within the
     stated tolerances, each with the fused GRAU epilogue bit-exact on the
     kernel's own f32 output — then timed (CUDA-graph replay, and eager
     CUDA events) beside its plain version, a PyTorch library call for the
     same function where one exists, and the card's bound; decode and
     matmul_wq over operand copies larger than the 50 MB L2, the GRAU unit
     at slice (d)'s shapes and at 2048 x 8192 over copies past L2;
     matmul_grau (the int8 matmul with the GRAU epilogue) bit for bit at the
     quickstart's, the kernel bench's, ragged and the llama3.2-3b MLP
     shapes (with one and several K parts), on signed, unsigned and random
     register files, timed over weight copies past L2; flash_attention
     (dense GQA attention forward) against its plain version (o and lse) at
     slice (e)'s shape causal and not, in f32, at every head_dim of the
     reference's archs (16, 48, 64, 192, 256 beside 128) on both bf16
     kernels, on a ragged length and after a prefix, and its backward
     against autograd; then the bf16 decode and prefill at glm4-9b's GQA
     group of 16 (32 heads over 2) and qwen1.5-32b's group of 1 (40 over
     40) on 16- and 4-bit pools with the fused epilogue (the same checks and
     float64 gates), a decode tick whose outputs must be the same bits in a
     quarter-capacity bucket and in the whole table, a prefill over table
     blocks shared with another slot's row, and copy_pool_block
     byte-exact;
  3. the slices: full-width llama3.2-3b in bf16 (weights drawn from --seed
     on the card) serves 8 requests through ServeEngine with the kernels,
     (a) with float activations, (b) with the GRAU MLP activation plus the
     fused GRAU attention epilogue, and (c) as (b) with the weights packed
     to int4 (the MLP through matmul_wq) and int4 KV pools; each once more
     through the gather path (in (c) with the MLP weights dequantized to
     bf16) for the greedy-token share. Then (d), the paper's integer flow:
     the quickstart's steps (launch/quickstart.py: the GRAU unit and the
     fused matmul_grau, each bit for bit against its plain version), and
     Table III for SFC and CNV with SiLU at the paper-table settings (QAT
     training, GRAU replacement, every pot/apot activation through the GRAU
     unit kernel; the kernel path's predictions and GRAU outputs held bit
     for bit against the plain unit's on the same trained parameters).
     Then (e), GRAU-QAT training of full-width llama3.2-3b (bf16 weights,
     f32 AdamW moments, GRAU apot, sequence 4096, remat "full") through
     launch/steps.make_train_step and train/loop.run: loss and gradients
     through the flash kernel held against the plain attention scan on
     batch 0, 8 steps with the kernel's launches counted, and a checkpoint
     / resume check at llama3-smoke size whose loss must fall.
     Then (f), full-width llama3.2-3b in (b)'s setup with EOS off: a
     shared-prefix trace (16 requests, one 1024-token prefix, then the
     first served alone through its prefill) cache-off and cache-on, whose
     streams must be the same bits with 15 x 1024 prefix tokens cached and
     as many fewer computed; the same trace with one request cancelled
     mid-prefill and one mid-decode; and an overload trace (12 requests of
     512-1024 prompt tokens on 256 usable blocks) that must preempt, finish
     every request in full and return every block and pin, beside an
     unpreempted run whose identical-token share it prints. Then (g), (b)'s
     8 requests on glm4-9b (full width and depth) and qwen1.5-32b (full
     width, 16 of 64 layers: the bf16 weights of all 64 leave no room on an
     80 GB card), through the kernels and the gather path. Then (h),
     (b)'s setup with EOS off: (1) the sampler (serve/sampling.py, threefry
     keys from serve/prng.py) on the card against itself on the CPU — the
     same (8, 128256) logits and keys, 32 draws under four SamplingParams:
     raw bits equal, tokens equal but for near-ties (2 f32 ulps, each
     printed), and a chi-square of 200,000 draws at a 16-way distribution
     (p > 1e-3); (2) (f)'s shared-prefix trace sampled, cache off and on:
     the streams the same tokens, 15 x 1024 prefix tokens cached; (3)
     (b)'s 8 requests sampled with telemetry on and off: the same streams,
     the 30 metric families in the Prometheus text, counters equal to the
     engine's stats, a valid JSONL trace with submit -> finish per request,
     tick-phase p50 / p99; (4) one FaultPlan on them — nan_logits on one
     request, chunk_error on another, a deadline that lands inside a 1 s
     slow step on a third: each retires with its reason, the watchdog
     degrades and recovers, every other stream as in (3), the audit finds
     no leak and every block is free; (5) real NaN written into a decoding
     slot's block under (a)'s float setup: that slot retires
     numeric_error, its neighbour's stream is unchanged, its blocks read
     back zero and a fresh request reusing them decodes; under (b)'s
     epilogue the same poison is printed, not gated.
     Launch counters are zeroed before and read after each run.
Each phase prints its seconds. The last two lines are the kernels JSON and
the result line.

Without a CUDA card, or outside a checkout of the repository, it prints why
on stderr and exits 2. `--rehearse` runs the same phases at smoke size on
the CPU (plain versions, no timings) to check the control flow, and exits 1.
`--kernels-from DIR` times only the rows of matmul_wq (its 8 MLP shapes),
of the decode and the prefill (16-, 8- and 4-bit pools; the decode also in
buckets of 32 and 64 of its 128 blocks), of
flash_attention (slice (e)'s shape), of matmul_grau (the quickstart's
product and the MLP products at 32 and 2048 rows) and of the GRAU unit
(slice (d)'s shapes and 2048 x 8192) of the port under DIR/src — an
unpacked earlier commit, or this checkout — in CUDA-graph replay, and
prints them as one JSON line, so two versions compare on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
PEAK_OPS = {                      # dense peaks, H100 SXM
    "bf16": 989e12,               # tensor cores (data sheet)
    # the data sheet has no int32 entry: 64 INT32 lanes per SM x 132 SMs x
    # the 1.98 GHz boost clock, one operation a lane a cycle (a compare, a
    # shift, a select or an add is one operation, not a multiply-add pair)
    "int32": 16.7e12,
    "int8": 1979e12,              # tensor cores, dense (data sheet)
}
# Kernel vs plain, element by element: |got - want| <= atol + rtol * |want|.
F32_TOL = 2e-5      # f32: the same sums in another order (FMA contraction)
# bf16 output: both sides round an f32 result (held at F32_TOL) to bf16, so
# they may land one bf16 ulp (<= 2**-7 * |want|) apart, and no further
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-6
# relative L2, first decode logits, kernel path vs gather path
SLICE_TOL = {"float": 2e-2, "grau": 5e-2, "wq4_kv4_grau": 5e-2,
             "glm4_grau": 5e-2, "qwen_grau": 5e-2}
# flash kernel vs its plain version, element by element (o, lse): the
# reference tests' tolerances for o (f32 3e-5, bf16 2e-2); lse is the same
# f32 scores and sums in another order (bf16: a fast exp as well)
FLASH_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (2e-2, 1e-4)}
# bf16 o, inside that outer gate: the kernel rounds each weight of P to bf16
# (relative error <= 2^-9) before P V and both sides round o to bf16 (<=
# 2^-8 |o| each), so |got - want| <= 2^-9 (P|V|)/l + 2^-7 |want|, where
# (P|V|)/l is the plain version on |v|; held at twice that
FLASH_BF16_PV, FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2 ** -8, 2 ** -6, 1e-5
# and the late rows as a whole (there |o| ~ 0.03 against (P|V|)/l ~ 0.8, so
# the element bound alone is loose): rows >= min(1024, s_q / 2)
FLASH_LATE_ROW, FLASH_LATE_REL_L2 = 1024, 1e-2
FLASH_BWD_TOL = 1e-5    # f32 backward vs autograd of the plain version
# slice (e): loss and gradients through the kernel vs the plain scan (bf16,
# GRAU: a rounding flip of one activation moves its output by s_out)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-3, 5e-2
# a timed operand set spans at least this many bytes: twice the H100's 50
# MB L2, so a call cycling through it reads device memory
L2_SPAN_BYTES = 100_000_000
DECODE_BUCKETS_TIMED = (32, 64)   # --kernels-from: decode buckets (blocks)
# multi-part decode and prefill, f32 output against a float64 attention
# (|f32 - f64| / (1 + |f64|)): the kernel within F64_REL x the plain
# version's distance + F64_FLOOR (the multi-part prefill read 0.7x at most
# on an H100)
F64_REL, F64_FLOOR = 2.0, 1e-7
RESUME_TOL = 1e-5       # resumed vs uninterrupted losses, relative
RESUME_FALL = 0.5       # smoke-size loss falls by this over its 6 steps, as
                        # the reference's tests/test_models.py asks in 10


class SmokeError(RuntimeError):
    pass


def need(cond, what):
    if not cond:
        raise SmokeError(what)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def device_ms(torch, fn, iters=20, warmup=3):
    """Mean device time per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls=20, replays=10):
    """Mean device time per call from CUDA-graph replay: `calls` calls
    captured once (after warm-up), the graph replayed `replays` times
    between CUDA events. device_ms's eager loop measures the host's enqueue
    whenever that is slower than the device — Python, ctypes and launches
    take some tens of microseconds a call — while a replay issues the
    captured kernels back to back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def cycling(fns):
    """One zero-argument call that runs `fns` in turn: timing a kernel over
    several copies of its operands whose bytes exceed the 50 MB L2 makes
    every call read device memory, as the served model's many weights do."""
    state = {"i": 0}

    def call():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()
    return call


def bound(nbytes, ops, kind):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------

def random_specs(np, make_spec, rng, n):
    """Register files with negative pre-shifts and shift counts >= 32."""
    out = []
    for i in range(n):
        segments, ne = int(rng.integers(1, 9)), int(rng.integers(1, 17))
        bps = (np.sort(rng.choice(np.arange(-(1 << 24), 1 << 24),
                                  size=segments - 1, replace=False))
               if segments > 1 else np.empty((0,), np.int64))
        pre = int(rng.choice([-40, -31, -5, -1, 0, 3, 20, 28, 33]))
        out.append(make_spec(bps, rng.integers(0, 2, size=(segments, ne)),
                             rng.choice([-1, 1], size=segments),
                             rng.integers(-200, 201, size=segments),
                             pre_shift=pre, num_exponents=ne,
                             out_bits=int(rng.choice([4, 8])),
                             out_signed=bool(i % 2)))
    return out


def check_grau(torch, np, dev, shapes, rng, timed):
    from repro_torch.kernels import grau as gk
    from repro_torch.kernels import ops
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.pwlf.spec import make_spec

    specs = [build_lm_grau("silu").spec, build_lm_grau("identity").spec]
    specs += random_specs(np, make_spec, rng, 8)
    rows, cols = shapes["grau"]
    n = rows * cols
    x = rng.integers(-(1 << 31), 1 << 31, size=(rows, cols), dtype=np.int64)
    x.reshape(-1)[:6] = [-(1 << 31), -(1 << 31) + 1, -1, 0, (1 << 31) - 2,
                         (1 << 31) - 1]
    x = torch.from_numpy(x.astype(np.int32)).to(dev)
    small = torch.from_numpy(rng.integers(-5000, 5000, size=(rows, cols),
                                          dtype=np.int64).astype(np.int32)).to(dev)
    modes = set()
    for spec in specs:
        for inp in (x, small, x[:, 1:]):            # ragged + unaligned view
            got = ops.grau(inp, spec)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            regs = spec.packed(dev)
            want = gk.grau_plain(inp, regs, num_exponents=spec.num_exponents,
                                 qmin=spec.qmin, qmax=spec.qmax)
            need(torch.equal(got.to(torch.int32), want),
                 f"grau kernel differs from plain (pre={int(spec.pre_shift)})")
            modes.add(got.dtype)
    need(modes == {torch.int8, torch.uint8}, f"bus modes covered: {modes}")
    log(f"grau: bit-exact on {len(specs)} specs x 3 inputs, modes "
        f"{sorted(str(m) for m in modes)}")
    row = {"name": "grau", "route": "cuda",
           "source": "src/repro_torch/csrc/grau.cu",
           "replaces": "src/repro/kernels/grau.py:103", "max_abs_err": 0}
    if timed:
        spec = quickstart_unit()
        row["shapes"] = [time_grau(torch, dev, spec, r, c, rng)
                         for r, c in GRAU_TIMED]
        main = row["shapes"][0]                 # the quickstart's unit call
        row.update({k: main[k] for k in ("ms", "eager_ms", "plain_ms",
                                         "bound_ms", "bound_by")})
        row["library_ms"] = None
        for r in row["shapes"]:
            log(f"timed grau: {json.dumps(r)}")
    return row


# The GRAU unit's timed shapes: slice (d)'s calls (the quickstart's 256 x
# 512, Table III's SFC layers (batch 128 x 256) and CNV layers (128 x 16 x
# 16 x 16 and 128 x 8 x 8 x 32 as rows x channels)), and a 2048 x 8192
# array of MAC outputs (an MLP's width at 2048 rows), timed over copies
# past L2.
GRAU_TIMED = [(256, 512), (128, 256), (32768, 16), (8192, 32), (2048, 8192)]
# Integer operations of the datapath an element, as csrc/grau_datapath.cuh
# runs it: 7 compares and 7 adds (the comparator bank), 3 table selects,
# the enc mask, the multiply-add and 2 clamps; then 4 a fired stage (find
# the lowest set bit, shift, add, clear the bit).
GRAU_OPS_BASE, GRAU_OPS_STAGE = 21, 4


def quickstart_unit():
    """The quickstart's SiLU unit (signed bus; APoT, 6 segments, 8
    exponents over a +/-30000 MAC range)."""
    from repro_torch.core.build import build_grau
    from repro_torch.core.folding import fold
    return build_grau(fold("silu", s_in=2 ** -10, s_out=2 ** -4, out_bits=8),
                      mac_range=(-30000, 30000), segments=6, num_exponents=8,
                      mode="apot", bias_mode="lsq").spec


def grau_ops(torch, x, spec):
    """The integer operations the datapath needs on x: GRAU_OPS_BASE an
    element plus GRAU_OPS_STAGE for each stage that fires on it (the set
    bits of enc[segment] below num_exponents), counted from the data."""
    from repro_torch.pwlf.spec import MAX_SEGMENTS, REG_BP, REG_ENC
    regs = spec.packed(x.device)
    seg = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for i in range(MAX_SEGMENTS - 1):
        seg += (x > regs[REG_BP + i]).to(torch.int32)
    per_seg = torch.bincount(seg.reshape(-1).long(), minlength=MAX_SEGMENTS)
    mask = (1 << spec.num_exponents) - 1
    fired = [bin(int(e) & mask).count("1")
             for e in regs[REG_ENC:REG_ENC + MAX_SEGMENTS].cpu()]
    stages = sum(int(n) * f for n, f in zip(per_seg.cpu(), fired))
    return GRAU_OPS_BASE * x.numel() + GRAU_OPS_STAGE * stages, stages


def grau_timing_case(torch, np, dev, rows, cols, rng):
    """MAC outputs in the quickstart's range (+/-60000) at (rows, cols):
    one array (slice (d)'s activations come warm from the layer before), or
    copies past L2_SPAN_BYTES when one array alone exceeds the 50 MB L2."""
    x = torch.from_numpy(rng.integers(-60000, 60000, size=(rows, cols))
                         .astype(np.int32)).to(dev)
    n = 4 * x.numel()
    copies = max(2, -(-L2_SPAN_BYTES // n)) if n > 50_000_000 else 1
    return [x] + [x.clone() for _ in range(copies - 1)]


def time_grau(torch, dev, spec, rows, cols, rng):
    """The unit on (rows, cols) int32 MAC outputs: the kernel under CUDA-
    graph replay (and eager events, which read the host's enqueue for a
    small call), its plain version, and the bound: 5 bytes an element
    against grau_ops' count at the int32 rate."""
    import numpy as np
    from repro_torch.kernels import grau as gk
    xs = grau_timing_case(torch, np, dev, rows, cols, rng)
    regs = spec.packed(dev)
    kw = dict(num_exponents=spec.num_exponents, qmin=spec.qmin,
              qmax=spec.qmax)
    kern = cycling([(lambda x=x: gk.grau_unit(x, regs, **kw)) for x in xs])
    ops, stages = grau_ops(torch, xs[0], spec)
    t_bound, by = bound(5 * xs[0].numel(), ops, "int32")
    return {"shape": [rows, cols], "copies": len(xs),
            "ms": graph_ms(torch, kern),
            "eager_ms": device_ms(torch, kern, 50, 5),
            "plain_ms": device_ms(torch, lambda: gk.grau_plain(
                xs[0], regs, **kw), 5, 1),
            "bound_ms": t_bound, "bound_by": by, "int_ops": ops,
            "fired_stages": stages}


def random_pools(torch, dev, dtype, shape, kv_bits):
    """(k, v, {k_exp, v_exp, kv_bits}) for a (nb, bs, kvh, d) pool: float
    pools of `dtype`, or packed int8 pools with exponents in [-9, -4]."""
    if kv_bits == 16:
        return (torch.randn(shape, device=dev).to(dtype),
                torch.randn(shape, device=dev).to(dtype), {})
    nb, bs, kvh, d = shape
    pshape = (nb, bs, kvh, d // 2 if kv_bits == 4 else d)
    k, v = (torch.randint(-128, 128, pshape, dtype=torch.int8, device=dev)
            for _ in range(2))
    ke, ve = (torch.randint(-9, -3, (nb, kvh), dtype=torch.int8, device=dev)
              for _ in range(2))
    return k, v, {"k_exp": ke, "v_exp": ve, "kv_bits": kv_bits}


def paged_case(torch, np, dev, dtype, shapes, rng, kv_bits=16):
    s = shapes
    slots, h, kvh, d, bs, max_len = (s["slots"], s["h"], s["kvh"], s["d"],
                                     s["bs"], s["max_len"])
    bps = max_len // bs
    nb = slots * bps + 1
    k, v, kv = random_pools(torch, dev, dtype, (nb, bs, kvh, d), kv_bits)
    # fragmented: every slot's blocks drawn from a shuffled pool
    perm = rng.permutation(np.arange(1, nb))[:slots * bps].reshape(slots, bps)
    lengths = rng.integers(1, max_len + 1, size=slots)
    lengths[0], lengths[1], lengths[2] = 0, max_len, 1       # idle, full, 1
    table = perm.astype(np.int32)
    table[lengths == 0] = 0
    q = torch.randn((slots, h, d), device=dev).to(dtype)
    return (q, k, v, torch.from_numpy(table).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev)), kv


def live_bytes(lengths_or_ends, bs, kvh, d, kv_bits):
    """K and V bytes of the live blocks at kv_bits per element (bf16 when
    16), their exponents (one byte per block and head each) and table
    entries."""
    blocks = sum(max(-(-int(n) // bs), 1) for n in lengths_or_ends)
    payload = 2 * blocks * bs * kvh * d * kv_bits // 8
    exps = 2 * blocks * kvh if kv_bits < 16 else 0
    return payload + exps + 4 * blocks


def dequant_pools(torch, k, v, kv, dtype):
    """Dense pools of `dtype` holding the same values (for the library
    yardstick; built outside any timed call)."""
    if not kv:
        return k, v
    from repro_torch.quant import kv as kvq
    bits = kv["kv_bits"]
    return (kvq.load_block(k, kv["k_exp"], bits).to(dtype),
            kvq.load_block(v, kv["v_exp"], bits).to(dtype))


def sdpa_yardstick(torch, q, k, v, table, ends, g, causal_rows=None):
    """F.scaled_dot_product_attention on the gathered view (the view is
    built outside the timed call); returns a zero-argument timed call."""
    import torch.nn.functional as F
    b = table.shape[0]
    kvh, d = k.shape[2], k.shape[3]
    kd = k[table.long()].reshape(b, -1, kvh, d).transpose(1, 2)
    vd = v[table.long()].reshape(b, -1, kvh, d).transpose(1, 2)
    kd = kd.repeat_interleave(g, dim=1).contiguous()
    vd = vd.repeat_interleave(g, dim=1).contiguous()
    pos = torch.arange(kd.shape[2], device=q.device)
    if causal_rows is None:                               # decode
        qd = q[:, :, None, :]                             # (b, h, 1, d)
        mask = (pos[None] < ends[:, None])[:, None, None, :]
    else:
        qd = q.transpose(1, 2)                            # (b, h, C, d)
        mask = (pos[None, None] <= causal_rows[..., None])[:, None]
    return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)


def close(got, want, rtol, atol):
    """(every element within atol + rtol * |want|, max |got - want|)."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok, float(diff.max())


def check_paged(torch, np, dev, shapes, rng, timed):
    """Decode and prefill on 16-, 8- and 4-bit pools, f32 and bf16, against
    their plain versions, plus a bf16 decode tick and a bf16 prefill chunk
    that the tensor-core kernels split into several sequence parts; rows
    keyed by kernel name and kv_bits."""
    from functools import partial

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import attn_output_quant
    from repro_torch.nn.common import build_lm_grau

    g = build_lm_grau("identity")
    s = shapes
    group = s["h"] // s["kvh"]
    rows = {}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for kv_bits in (16, 8, 4):
        for name in ("paged_attention", "paged_prefill"):
            worst = 0.0
            for dtype in (torch.float32, torch.bfloat16):
                (q, k, v, table, lengths), kv = paged_case(
                    torch, np, dev, dtype, s, rng, kv_bits)
                if name == "paged_attention":
                    kern, plain = pa.paged_attention, pa.paged_attention_plain
                    args = (q, k, v, table, lengths)
                else:
                    kern = pa.paged_prefill_attention
                    plain = pa.paged_prefill_plain
                    C = s["chunk"]
                    starts = torch.tensor(
                        [0, C, s["max_len"] // 2, s["max_len"] - C][:q.shape[0]],
                        dtype=torch.int32, device=dev)
                    qp = torch.randn((starts.shape[0], C, s["h"], s["d"]),
                                     device=dev).to(dtype)
                    args = (qp, k, v,
                            table[1:1 + starts.shape[0]].contiguous(), starts)
                kern, plain = partial(kern, **kv), partial(plain, **kv)
                label = f"{name} kv{kv_bits} {dtype}"
                # the f32 result before the output cast, at F32_TOL
                f32 = kern(*args, out_dtype=torch.float32)
                sync()
                ok, err32 = close(f32, plain(*args, out_dtype=torch.float32),
                                  F32_TOL, F32_TOL)
                need(ok, f"{label}: f32 output off by {err32:.3g} "
                     f"> {F32_TOL} (1 + |want|)")
                got = kern(*args)
                sync()
                need(torch.isfinite(got.float()).all(), f"{label}: non-finite")
                rtol, atol = ((F32_TOL, F32_TOL) if dtype == torch.float32
                              else (BF16_RTOL, BF16_ATOL))
                ok, err = close(got, plain(*args), rtol, atol)
                need(ok, f"{label}: output off by {err:.3g} > {atol} + "
                     f"{rtol:.3g} |want|")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
                quant = kern(*args, spec=g.spec, s_in=g.s_in)
                sync()
                need(torch.equal(quant, attn_output_quant(f32, g.spec,
                                                          g.s_in)),
                     f"{label}: GRAU epilogue not bit-exact")
                qref = plain(*args, spec=g.spec, s_in=g.s_in)
                flips = int((quant.to(torch.int32) - qref.to(torch.int32))
                            .abs().gt(1).sum())
                need(flips == 0, f"{label}: epilogue vs plain off by > 1")
                log(f"{label}: max |kernel - plain| = {err:.3g} (each "
                    f"element within {atol:.3g} + {rtol:.3g} |want|), f32 "
                    f"output {err32:.3g} (within {F32_TOL} (1 + |want|)); "
                    "epilogue bit-exact on the kernel's f32 output")
            parts, vs64 = (prefill_parts_case if name == "paged_prefill"
                           else decode_parts_case)(torch, np, dev, s, rng,
                                                   kv_bits, g, sync)
            suffix = "" if kv_bits == 16 else f"_kv{kv_bits}"
            row = {"name": name + suffix, "route": "cuda",
                   # bf16 q, the served and timed dtype; f32 q runs
                   # csrc/paged_attention.cu
                   "source": "src/repro_torch/csrc/paged_prefill.cu",
                   "replaces": ("src/repro/kernels/paged_attention.py:189"
                                if name == "paged_attention" else
                                "src/repro/kernels/paged_attention.py:401"),
                   "kv_bits": kv_bits, "max_abs_err": worst}
            row["multi_part_case_parts"] = parts
            row["multi_part_f32_vs_f64"] = vs64
            if timed:
                row.update(time_paged(torch, np, dev, name, s, group, rng,
                                      kv_bits))
                log(f"timed: {json.dumps(row)}")
            rows[name + suffix] = row
    return rows


def prefill_f64(torch, q, k, v, table, start, kv):
    """The prefill in float64 on the gathered dense view (masked softmax
    attention, not the kernels' recurrence): what the f32 outputs of the
    kernel and of its plain version are both measured from."""
    from repro_torch.kernels.ref import dense_kv_views
    kd, vd = dense_kv_views(k, v, table, **kv)
    b, C, h, d = q.shape
    kvh = kd.shape[2]
    qg = q.double().reshape(b, C, kvh, h // kvh, d)
    lg = torch.einsum("bqkgd,bskd->bkgqs", qg, kd.double()) * d ** -0.5
    pos = torch.arange(kd.shape[1], device=q.device)
    row_end = start.long()[:, None] + torch.arange(C, device=q.device)[None]
    live = (pos[None, None] <= row_end[..., None])[:, None, None]
    lg = lg.masked_fill(~live, float("-inf"))
    o = torch.einsum("bkgqs,bskd->bkgqd", torch.softmax(lg, -1), vd.double())
    return o.permute(0, 3, 1, 2, 4).reshape(b, C, h, d)


def prefill_parts_case(torch, np, dev, s, rng, kv_bits, g, sync, draws=4,
                       tag=""):
    """Bf16 prefill chunks (batch 1) at the end of a full-width table, which
    the tensor-core kernel splits into several sequence parts, on `draws`
    fresh pools and queries: f32 output within F32_TOL of the plain
    version's; the bf16 output equal, bit for bit, to the kernel's own f32
    output rounded to bf16; the fused epilogue bit-exact on the kernel's f32
    output and within one code of the plain version's. (The one-ulp-of-
    plain rule of the other cases compares two roundings of f32 results;
    on 8-bit pools |o| reaches ~8 and the two f32 results sit ~1e-5 apart,
    more than a bf16 ulp of the case's small outputs.) Returns the part
    count and, over the draws, the largest |f32 - f64| / (1 + |f64|) of the
    kernel and of the plain version against prefill_f64: the measure
    F32_TOL bounds, read from an exact-enough reference."""
    from functools import partial

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import attn_output_quant
    C, rows = s["chunk"], s["chunk"] * s["h"] // s["kvh"]
    start = torch.tensor([s["max_len"] - C], dtype=torch.int32, device=dev)
    vs64 = {"kernel": 0.0, "plain": 0.0}
    for _ in range(draws):
        (_, k, v, table, _), kv = paged_case(torch, np, dev, torch.bfloat16,
                                             s, rng, kv_bits)
        q = torch.randn((1, C, s["h"], s["d"]), device=dev).to(torch.bfloat16)
        args = (q, k, v, table[1:2].contiguous(), start)
        parts, _ = pa.prefill_plan(1, s["kvh"], rows, table.shape[1], s["bs"],
                                   sm_count(torch, dev))
        need(parts > 1, f"the multi-part prefill case plans {parts} part")
        kern, plain = (partial(pa.paged_prefill_attention, **kv),
                       partial(pa.paged_prefill_plain, **kv))
        label = f"paged_prefill kv{kv_bits} {tag} {parts} parts"
        f32 = kern(*args, out_dtype=torch.float32)
        sync()
        p32 = plain(*args, out_dtype=torch.float32)
        ok, err32 = close(f32, p32, F32_TOL, F32_TOL)
        need(ok, f"{label}: f32 output off by {err32:.3g} > {F32_TOL} (1 + "
             "|want|)")
        o64 = prefill_f64(torch, *args, kv)
        for who, o in (("kernel", f32), ("plain", p32)):
            vs64[who] = max(vs64[who], float(((o.double() - o64).abs()
                                              / (1 + o64.abs())).max()))
        got = kern(*args)
        sync()
        need(got.dtype == torch.bfloat16
             and torch.equal(got, f32.to(torch.bfloat16)),
             f"{label}: bf16 output is not the kernel's f32 output rounded")
        err = float((got.float() - plain(*args).float()).abs().max())
        quant = kern(*args, spec=g.spec, s_in=g.s_in)
        sync()
        need(torch.equal(quant, attn_output_quant(f32, g.spec, g.s_in)),
             f"{label}: GRAU epilogue not bit-exact")
        qref = plain(*args, spec=g.spec, s_in=g.s_in)
        need(int((quant.to(torch.int32) - qref.to(torch.int32)).abs().max())
             <= 1, f"{label}: epilogue vs plain off by > 1")
        log(f"{label} (start {int(start)}, table width {table.shape[1]}): "
            f"f32 output {err32:.3g} from plain (within {F32_TOL} (1 + "
            "|want|)), bf16 output its rounding bit for bit (max |bf16 - "
            f"plain bf16| = {err:.3g}); epilogue bit-exact on the kernel's "
            "f32 output")
    log(f"paged_prefill kv{kv_bits} {tag}: over {draws} draws, max |f32 - "
        f"f64| / (1 + |f64|): kernel {vs64['kernel']:.3g}, plain "
        f"{vs64['plain']:.3g}")
    f64_gate(f"paged_prefill kv{kv_bits} {tag}", vs64)
    return parts, vs64


def f64_gate(label, vs64):
    """The kernel's f32 output against the float64 attention, as |f32 -
    f64| / (1 + |f64|): within F32_TOL, and within F64_REL times the plain
    version's own distance plus F64_FLOOR (both round the same softmax in
    f32; the kernel's parts and tensor-core steps may not add more)."""
    bound = F64_REL * vs64["plain"] + F64_FLOOR
    need(vs64["kernel"] <= min(F32_TOL, bound),
         f"{label}: f32 output {vs64['kernel']:.3g} from float64, beyond "
         f"min({F32_TOL}, {F64_REL} x plain's {vs64['plain']:.3g} + "
         f"{F64_FLOOR})")


def decode_parts_case(torch, np, dev, s, rng, kv_bits, g, sync, draws=4,
                      tag=""):
    """Bf16 decode ticks at the main shape (slots ragged up to max_len,
    one idle), which the tensor-core kernel splits into decode_plan's
    sequence parts, on `draws` fresh pools and queries: f32 output within
    F32_TOL of the plain version's; the bf16 output the kernel's own f32
    output rounded, bit for bit; the fused epilogue bit-exact on the
    kernel's f32 output and within one code of the plain version's; and
    f64_gate against prefill_f64 at C = 1 over the live slots. Returns the
    part count and the f32-vs-f64 distances."""
    from functools import partial

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import attn_output_quant
    vs64 = {"kernel": 0.0, "plain": 0.0}
    for _ in range(draws):
        (q, k, v, table, lengths), kv = paged_case(
            torch, np, dev, torch.bfloat16, s, rng, kv_bits)
        args = (q, k, v, table, lengths)
        parts, _ = pa.decode_plan(q.shape[0], s["kvh"], table.shape[1],
                                  table.stride(0), s["bs"],
                                  sm_count(torch, dev))
        need(parts > 1, f"the multi-part decode case plans {parts} part")
        kern, plain = (partial(pa.paged_attention, **kv),
                       partial(pa.paged_attention_plain, **kv))
        label = f"paged_attention kv{kv_bits} {tag} {parts} parts"
        f32 = kern(*args, out_dtype=torch.float32)
        sync()
        p32 = plain(*args, out_dtype=torch.float32)
        ok, err32 = close(f32, p32, F32_TOL, F32_TOL)
        need(ok, f"{label}: f32 output off by {err32:.3g} > {F32_TOL} (1 + "
             "|want|)")
        live = lengths > 0
        o64 = prefill_f64(torch, q[:, None], k, v, table, lengths - 1,
                          kv)[:, 0][live]
        for who, o in (("kernel", f32), ("plain", p32)):
            vs64[who] = max(vs64[who], float(((o.double()[live] - o64).abs()
                                              / (1 + o64.abs())).max()))
        got = kern(*args)
        sync()
        need(got.dtype == torch.bfloat16
             and torch.equal(got, f32.to(torch.bfloat16)),
             f"{label}: bf16 output is not the kernel's f32 output rounded")
        quant = kern(*args, spec=g.spec, s_in=g.s_in)
        sync()
        need(torch.equal(quant, attn_output_quant(f32, g.spec, g.s_in)),
             f"{label}: GRAU epilogue not bit-exact")
        qref = plain(*args, spec=g.spec, s_in=g.s_in)
        need(int((quant.to(torch.int32) - qref.to(torch.int32)).abs().max())
             <= 1, f"{label}: epilogue vs plain off by > 1")
        log(f"{label} (lengths {lengths.tolist()}, table width "
            f"{table.shape[1]}): f32 output {err32:.3g} from plain (within "
            f"{F32_TOL} (1 + |want|)), bf16 output its rounding bit for bit; "
            "epilogue bit-exact on the kernel's f32 output")
    log(f"paged_attention kv{kv_bits} {tag}: over {draws} draws, max |f32 - "
        f"f64| / (1 + |f64|): kernel {vs64['kernel']:.3g}, plain "
        f"{vs64['plain']:.3g}")
    f64_gate(f"paged_attention kv{kv_bits} {tag}", vs64)
    return parts, vs64


def sm_count(torch, dev):
    from repro_torch.kernels import build as kbuild
    return kbuild.sm_count(dev) if dev.type == "cuda" else kbuild.H100_SMS


def paged_timing_case(torch, np, dev, name, s, group, rng, kv_bits,
                      bucket=None):
    """The main path's shape in bf16: a decode tick at the widest bucket (8
    slots, ragged up to max_len) or, with `bucket`, at the table sliced to
    that many blocks (its row stride kept, as the engine slices it; every
    length inside the bucket), or one prefill chunk (b = 1) starting
    mid-prompt, over 16-, 8- or 4-bit pools. Returns (kernel, plain, a list
    of argument tuples, bytes, flops, library call); the bytes count the
    live pools at kv_bits. Decode gets copies of its pools (and exponent
    planes) whose live bytes together exceed L2_SPAN_BYTES, so that a call
    cycling through them reads device memory, as a served tick's 28
    layers of pools do; the prefill's one case."""
    from functools import partial

    from repro_torch.kernels import paged_attention as pa
    (q, k, v, table, lengths), kv = paged_case(torch, np, dev,
                                               torch.bfloat16, s, rng,
                                               kv_bits)
    if bucket is not None:
        top = bucket * s["bs"]
        ends = rng.integers(1, top + 1, size=q.shape[0])
        ends[0], ends[1], ends[2] = 0, top, 1             # idle, full, 1
        lengths = torch.from_numpy(ends.astype(np.int32)).to(dev)
        table = table[:, :bucket]
    kd, vd = dequant_pools(torch, k, v, kv, torch.bfloat16)
    h, d, kvh, bs = s["h"], s["d"], s["kvh"], s["bs"]
    if name == "paged_attention":
        ends = [int(n) for n in lengths.cpu()]
        nbytes = (live_bytes(ends, bs, kvh, d, kv_bits) + 2 * 2 * q.numel()
                  + 4 * len(ends))
        flops = sum(4 * h * d * n for n in ends)
        lib = sdpa_yardstick(torch, q, kd, vd, table, lengths, group)
        kern, plain = pa.paged_attention, pa.paged_attention_plain
        copies = max(2, -(-L2_SPAN_BYTES // live_bytes(ends, bs, kvh, d,
                                                       kv_bits)))
        calls = [((q, k, v, table, lengths), kv)]
        for _ in range(copies - 1):
            calls.append(((q, k.clone(), v.clone(), table, lengths),
                          {key: (x.clone() if torch.is_tensor(x) else x)
                           for key, x in kv.items()}))
    else:
        C = s["chunk"]
        start = torch.tensor([s["max_len"] // 2 - C], dtype=torch.int32,
                             device=dev)
        width = -(-(int(start) + C) // bs)
        tab = table[1:2, :width].contiguous()
        qp = torch.randn((1, C, h, d), device=dev).to(torch.bfloat16)
        end = int(start) + C
        nbytes = live_bytes([end], bs, kvh, d, kv_bits) + 2 * 2 * qp.numel()
        flops = sum(4 * h * d * (int(start) + r + 1) for r in range(C))
        rows_end = start[:, None] + torch.arange(C, device=dev)[None]
        lib = sdpa_yardstick(torch, qp, kd, vd, tab, None, group, rows_end)
        kern, plain = pa.paged_prefill_attention, pa.paged_prefill_plain
        calls = [((qp, k, v, tab, start), kv)]
    return ([partial(kern, *a, **kw) for a, kw in calls],
            partial(plain, *calls[0][0], **calls[0][1]), nbytes, flops, lib)


def paged_parts(torch, dev, name, s, group, width):
    """The tensor-core kernels' sequence parts at the timed shape."""
    from repro_torch.kernels import paged_attention as pa
    if name == "paged_prefill":
        return pa.prefill_plan(1, s["kvh"], s["chunk"] * group, width,
                               s["bs"], sm_count(torch, dev))[0]
    return pa.decode_plan(s["slots"], s["kvh"], width, width, s["bs"],
                          sm_count(torch, dev))[0]


def time_paged(torch, np, dev, name, s, group, rng, kv_bits=16):
    """The kernel (CUDA-graph replay, and eager) over paged_timing_case's
    calls, its plain version and the library call, with the bound;
    `parts`: the kernel's sequence parts; `pool_copies`: the decode's pool
    sets cycled through."""
    kerns, plain, nbytes, flops, lib = paged_timing_case(
        torch, np, dev, name, s, group, rng, kv_bits)
    width = (-(-(s["max_len"] // 2) // s["bs"]) if name == "paged_prefill"
             else s["max_len"] // s["bs"])
    t_bound, by = bound(nbytes, flops, "bf16")
    return {"ms": graph_ms(torch, cycling(kerns)),
            "eager_ms": device_ms(torch, cycling(kerns)),
            "parts": paged_parts(torch, dev, name, s, group, width),
            "pool_copies": len(kerns),
            "plain_ms": device_ms(torch, plain, 5, 1),
            "bound_ms": t_bound, "bound_by": by,
            "library_ms": graph_ms(torch, lib),
            "library_call": "torch.nn.functional.scaled_dot_product_attention "
                            "on the gathered (dequantized) bf16 view"}


def check_matmul_wq(torch, np, dev, shapes, rng, timed):
    """matmul_wq at the MLP's shapes (w_gate and w_down, 8 and 32 rows),
    int4 and int8, f32 and bf16 activations, against matmul_wq_plain:
    f32 output within F32_TOL * sum_k |x||w| element by element (the same
    exact products summed in another order); output in x's dtype within
    that plus one bf16 ulp of the plain version's (each rounds its own f32
    sum). The fused epilogue bit-exact on one shape."""
    from repro_torch.kernels import matmul_wq as mm
    from repro_torch.kernels.ref import attn_output_quant
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.quant import weights as wq

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    worst = 0.0
    weights = {}
    for wname, (K, N) in shapes["mlp"].items():
        w_f = torch.randn((K, N), device=dev) * K ** -0.5
        for bits in (4, 8):
            w = wq.pack_tensor(w_f, bits, -2)
            weights[(wname, bits)] = w
            wabs = wq.dense(w).abs()
            for M in shapes["rows"]:
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn((M, K), device=dev).to(dtype)
                    label = f"matmul_wq {wname} M={M} int{bits} {dtype}"
                    got = mm.matmul_wq(x, w)
                    sync()
                    want = mm.matmul_wq_plain(x, w.q, w.e, bits=bits, kdim=K)
                    tol = F32_TOL * (x.float().abs() @ wabs)
                    if dtype == torch.bfloat16:
                        tol = tol + BF16_ATOL + BF16_RTOL * want.float().abs()
                    diff = (got.float() - want.float()).abs()
                    need(got.dtype == dtype and bool((diff <= tol).all()),
                         f"{label}: off by {float(diff.max()):.3g}, beyond "
                         "the stated tolerance")
                    if dtype == torch.bfloat16:
                        worst = max(worst, float(diff.max()))
                    log(f"{label}: max |kernel - plain| = "
                        f"{float(diff.max()):.3g} (each element within "
                        f"{F32_TOL} sum|x||w|"
                        + (" + one bf16 ulp)" if dtype == torch.bfloat16
                           else ")"))
    g = build_lm_grau("silu")
    wname, (K, N) = next(iter(shapes["mlp"].items()))
    w = weights[(wname, 4)]
    x = torch.randn((shapes["rows"][0], K), device=dev)
    f32 = mm.matmul_wq(x, w)
    fused = mm.matmul_wq(x, w, g.spec, s_in=g.s_in)
    sync()
    need(torch.equal(fused, attn_output_quant(f32, g.spec, g.s_in)),
         "matmul_wq: GRAU epilogue not bit-exact on the kernel's f32 output")
    log("matmul_wq: GRAU epilogue bit-exact on the kernel's f32 output")
    # bf16 activations (the served dtype), at both MLP shapes: the fused
    # epilogue on the kernel's own f32 sum (out_dtype), and against plain
    for wname, (K, N) in shapes["mlp"].items():
        w = weights[(wname, 4)]
        M = shapes["rows"][-1]
        xb = torch.randn((M, K), device=dev).to(torch.bfloat16)
        f32 = mm.matmul_wq(xb, w, out_dtype=torch.float32)
        fused = mm.matmul_wq(xb, w, g.spec, s_in=g.s_in)
        sync()
        label = f"matmul_wq {wname} M={M} int4 bf16 + GRAU"
        need(torch.equal(fused, attn_output_quant(f32, g.spec, g.s_in)),
             f"{label}: epilogue not bit-exact on the kernel's f32 sum")
        qref = mm.matmul_wq_plain(xb, w.q, w.e, bits=4, kdim=K, spec=g.spec,
                                  s_in=g.s_in)
        flips = int((fused.to(torch.int32) - qref.to(torch.int32)).abs()
                    .max())
        need(flips <= 1, f"{label}: epilogue vs plain off by {flips} > 1")
        parts = mm.plan_parts(M, N, K, w.tile, sm_count(torch, dev))[0]
        log(f"{label} ({parts} K parts): epilogue bit-exact on the kernel's "
            "f32 sum, within one code of plain")
    row = {"name": "matmul_wq", "route": "cuda",
           "source": "src/repro_torch/csrc/matmul_wq.cu",
           "replaces": "src/repro/kernels/matmul_wq.py:95",
           "max_abs_err": worst}
    if timed:
        row["shapes"] = [time_matmul_wq(torch, dev, shapes, wname, M, bits)
                         for wname in shapes["mlp"] for bits in (4, 8)
                         for M in shapes["rows"]]
        main = row["shapes"][0]                  # w_gate, int4, decode rows
        row.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")})
        row["library_call"] = ("torch.matmul(x, W) on the weight dequantized "
                               "to bf16 before timing (4x / 2x the weight "
                               "bytes of int4 / int8)")
        for r in row["shapes"]:
            log(f"timed matmul_wq: {json.dumps(r)}")
    return row


def matmul_wq_case(torch, dev, shapes, wname, M, bits):
    """bf16 x (M, K) and copies of one packed MLP weight whose payload and
    exponents together exceed twice the 50 MB L2, so every call of the
    kernel reads its weight from device memory, as the served model's 84
    weights a forward do."""
    from repro_torch.quant import weights as wq
    K, N = shapes["mlp"][wname]
    x = torch.randn((M, K), device=dev).to(torch.bfloat16)
    base = wq.pack_tensor(torch.randn((K, N), device=dev) * K ** -0.5, bits,
                          -2)
    packed = base.q.numel() + base.e.numel()
    ws = [wq.QuantWeight(q=base.q.clone(), e=base.e.clone(), bits=bits,
                         caxis=-2, kdim=K, tile=base.tile)
          for _ in range(max(2, -(-L2_SPAN_BYTES // packed)))]
    return x, ws


def time_matmul_wq(torch, dev, shapes, wname, M, bits):
    """One MLP product in bf16 over matmul_wq_case's weight copies: the
    kernel (CUDA-graph replay, and eager), its plain version, and
    torch.matmul on the same copies dequantized to bf16 (4x / 2x the bytes);
    the bound counts x, the payload, the exponents and the output once.
    `parts`: the kernel's K parts."""
    from repro_torch.kernels import matmul_wq as mm
    from repro_torch.quant import weights as wq
    K, N = shapes["mlp"][wname]
    x, ws = matmul_wq_case(torch, dev, shapes, wname, M, bits)
    kern = [(lambda w=w: mm.matmul_wq(x, w)) for w in ws]
    dense = [wq.dense(w, torch.bfloat16) for w in ws]
    nbytes = x.numel() * 2 + ws[0].q.numel() + ws[0].e.numel() + M * N * 2
    t_bound, by = bound(nbytes, 2 * M * K * N, "bf16")
    return {"weight": wname, "M": M, "K": K, "N": N, "bits": bits,
            "parts": mm.plan_parts(M, N, K, ws[0].tile,
                                   sm_count(torch, dev))[0],
            "weight_copies": len(ws),
            "ms": graph_ms(torch, cycling(kern)),
            "eager_ms": device_ms(torch, cycling(kern), 50, 5),
            "plain_ms": device_ms(torch, cycling([
                (lambda w=w: mm.matmul_wq_plain(x, w.q, w.e, bits=bits,
                                                kdim=K)) for w in ws]), 5, 1),
            "bound_ms": t_bound, "bound_by": by,
            "library_ms": graph_ms(torch, cycling([
                (lambda d=d: torch.matmul(x, d)) for d in dense]))}


def matmul_grau_specs(np, rng):
    """The quickstart's SiLU unit (signed bus), a ReLU unit on the unsigned
    (uint8) bus, and random register files (negative pre-shifts, shift
    counts 31-40)."""
    from repro_torch.core.build import build_grau
    from repro_torch.core.folding import fold
    from repro_torch.pwlf.spec import make_spec
    relu = build_grau(fold("relu", s_in=2 ** -10, s_out=2 ** -4, out_bits=8,
                           out_signed=False), mac_range=(-30000, 30000),
                      segments=6, num_exponents=8, mode="apot").spec
    return [quickstart_unit(), relu] + random_specs(np, make_spec, rng, 8)


def check_matmul_grau(torch, np, dev, shapes, rng, timed):
    """matmul_grau against matmul_grau_plain (the product in float64, exact,
    wrapped to int32, then the plain datapath), bit for bit, at every shape
    and register file; then timed at the quickstart's shape and the MLP
    shapes."""
    from repro_torch.kernels import matmul_grau as mg
    from repro_torch.kernels import ops

    specs = matmul_grau_specs(np, rng)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    modes = set()
    for xshape, (K, N) in shapes["mm_grau"]:
        x = torch.from_numpy(rng.integers(-128, 128, size=xshape)
                             .astype(np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-128, 128, size=(K, N))
                             .astype(np.int8)).to(dev)
        x.view(-1)[0], w.view(-1)[:2] = -128, -128      # the int8 extremes
        for spec in specs:
            got = ops.matmul_grau(x, w, spec)
            sync()
            want = mg.matmul_grau_plain(
                x.reshape(-1, K), w, spec.packed(dev),
                num_exponents=spec.num_exponents, qmin=spec.qmin,
                qmax=spec.qmax).reshape(got.shape)
            need(got.dtype == want.dtype and torch.equal(got, want),
                 f"matmul_grau {xshape} x {(K, N)} differs from plain "
                 f"(pre={int(spec.pre_shift)}, qmin={spec.qmin})")
            modes.add(got.dtype)
    need(modes == {torch.int8, torch.uint8}, f"bus modes covered: {modes}")
    log(f"matmul_grau: bit-exact on {len(shapes['mm_grau'])} shapes x "
        f"{len(specs)} specs, modes {sorted(str(m) for m in modes)}")
    row = {"name": "matmul_grau", "route": "cuda",
           "source": "src/repro_torch/csrc/matmul_grau.cu",
           "replaces": "src/repro/kernels/matmul_grau.py:66",
           "max_abs_err": 0}
    if timed:
        row["shapes"] = [time_matmul_grau(torch, dev, specs[0], *mkn)
                         for mkn in shapes["mm_grau_timed"]]
        main = row["shapes"][0]                 # the quickstart's product
        row.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")})
        row["library_call"] = main["library_call"]
        for r in row["shapes"]:
            log(f"timed matmul_grau: {json.dumps(r)}")
    return row


# matmul_grau's timed shapes (M, K, N): the quickstart's product, and the
# llama3.2-3b MLP products (w_gate 3072 -> 8192, w_down 8192 -> 3072) at 32
# and 2048 rows
MM_GRAU_TIMED = [(128, 256, 128), (32, 3072, 8192), (32, 8192, 3072),
                 (2048, 3072, 8192), (2048, 8192, 3072)]


def matmul_grau_case(torch, dev, M, K, N):
    """Random int8 x (M, K), and copies of one int8 weight (K, N) that
    together exceed 60 MB, so that a call cycling through them reads its
    weight from device memory."""
    x = torch.randint(-128, 128, (M, K), dtype=torch.int8, device=dev)
    base = torch.randint(-128, 128, (K, N), dtype=torch.int8, device=dev)
    return x, [base] + [base.clone() for _ in
                        range(max(2, -(-60_000_000 // (K * N))) - 1)]


def time_matmul_grau(torch, dev, spec, M, K, N):
    """One int8 product with the GRAU epilogue, timed over enough weight
    copies to exceed L2: the kernel (CUDA-graph replay, and eager: eager
    events read the host's enqueue for a small call), its plain version,
    and as the library yardstick torch._int_mm (cuBLASLt int8 -> int32,
    without the epilogue: it writes 4 bytes an output where the kernel
    writes 1), replayed the same way. The bound counts x, w and the 8-bit
    output once, and 2 M K N int8 operations. `row_tile`, `parts` and
    `steps_per_part`: the kernel's plan (K split into `parts`)."""
    from repro_torch.kernels import matmul_grau as mg
    from repro_torch.kernels.ref import wrap_int32
    x, ws = matmul_grau_case(torch, dev, M, K, N)
    base = ws[0]
    # the yardstick computes the kernel's int32 sums (float64 is exact here)
    need(torch.equal(torch._int_mm(x, base),
                     wrap_int32((x.double() @ base.double()).long())),
         f"torch._int_mm differs from the exact int32 sums at {(M, K, N)}")
    regs = spec.packed(dev)
    kw = dict(num_exponents=spec.num_exponents, qmin=spec.qmin,
              qmax=spec.qmax)
    t_bound, by = bound(M * K + K * N + M * N, 2 * M * K * N, "int8")
    # cuBLASLt's int8 kernels take both operands K-major: beside w as the
    # kernel takes it (row-major), time a column-major copy of it too
    kmajor = [w.t().contiguous().t() for w in ws]
    kern = [(lambda w=w: mg.matmul_grau(x, w, regs, **kw)) for w in ws]
    lib = [(lambda w=w: torch._int_mm(x, w)) for w in ws]
    libk = [(lambda w=w: torch._int_mm(x, w)) for w in kmajor]
    bm, parts, spp = mg.plan(M, N, K, sm_count(torch, dev))
    return {"M": M, "K": K, "N": N, "row_tile": bm, "parts": parts,
            "steps_per_part": spp, "weight_copies": len(ws),
            "ms": graph_ms(torch, cycling(kern)),
            "eager_ms": device_ms(torch, cycling(kern), 50, 5),
            "plain_ms": device_ms(torch, cycling([
                (lambda w=w: mg.matmul_grau_plain(x, w, regs, **kw))
                for w in ws]), 5, 1),
            "bound_ms": t_bound, "bound_by": by,
            "library_ms": graph_ms(torch, cycling(lib)),
            "library_eager_ms": device_ms(torch, cycling(lib), 50, 5),
            "library_kmajor_ms": graph_ms(torch, cycling(libk)),
            "library_call": "torch._int_mm(x, w) on w row-major (K, N), as "
                            "the kernel takes it (library_kmajor_ms: on a "
                            "column-major copy): int8 -> int32 without the "
                            "GRAU epilogue (the port never calls it)"}


def flash_cases(torch, timed):
    """(label, b, s_q, s_kv, h, kvh, d, dtype, causal, q_offset): slice
    (e)'s shape causal and not, f32, every head_dim of the reference's
    archs, a ragged length and queries after a prefix (q_offset, s_q <
    s_kv); the rehearsal's shapes are cut to smoke size."""
    bf, f32 = torch.bfloat16, torch.float32
    if timed:
        return [("train bf16 causal", 1, 4096, 4096, 24, 8, 128, bf, True, 0),
                ("train bf16 full", 1, 4096, 4096, 24, 8, 128, bf, False, 0),
                ("f32 causal", 2, 1024, 1024, 24, 8, 128, f32, True, 0),
                ("d64 bf16", 1, 2048, 2048, 8, 2, 64, bf, True, 0),
                ("d256 bf16", 1, 1024, 1024, 16, 16, 256, bf, True, 0),
                ("ragged 1000", 1, 1000, 1000, 24, 8, 128, bf, True, 0),
                ("q_offset 700", 1, 300, 1000, 24, 8, 128, bf, True, 700),
                # the reference's other head dims: glm4 (16), deepseek-smoke
                # (48) on the mma.sync kernel, deepseek-v3 (192) on wgmma
                ("d16 bf16", 1, 1000, 1000, 8, 2, 16, bf, True, 0),
                ("d48 bf16", 1, 777, 777, 8, 8, 48, bf, False, 0),
                ("d192 bf16", 1, 1000, 1000, 16, 16, 192, bf, True, 0),
                ("d192 q_offset", 1, 200, 900, 16, 16, 192, bf, True, 700),
                ("d48 f32", 1, 300, 300, 8, 8, 48, f32, True, 0)]
    return [("train bf16 causal", 1, 128, 128, 4, 2, 32, bf, True, 0),
            ("f32 causal", 2, 64, 64, 4, 2, 32, f32, True, 0),
            ("d256 f32", 1, 64, 64, 2, 2, 256, f32, False, 0),
            ("ragged 100", 1, 100, 100, 4, 2, 32, f32, True, 0),
            ("q_offset 70", 1, 30, 100, 4, 2, 32, f32, True, 70)]


def check_flash(torch, np, dev, shapes, rng, timed):
    """The flash kernel against flash_attention_plain on the same inputs, o
    element by element and lse, at every case of flash_cases; then
    flash_attention_backward (through FlashAttention) against autograd
    through the plain version, f32; then timed at slice (e)'s shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_plain

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    worst = 0.0
    bf16_worst = {"bound_ratio": 0.0, "late_rel_l2": 0.0}
    for label, b, sq, skv, h, kvh, d, dt, causal, off in flash_cases(
            torch, timed):
        q = torch.randn((b, sq, h, d), device=dev).to(dt)
        k, v = (torch.randn((b, skv, kvh, d), device=dev).to(dt)
                for _ in range(2))
        o, lse = fa.flash_attention(q, k, v, causal=causal, q_offset=off)
        sync()
        want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                               q_offset=off)
        tol, ltol = FLASH_TOL[str(dt).split(".")[-1]]
        need(o.dtype == dt and torch.isfinite(o.float()).all()
             and torch.isfinite(lse).all(), f"flash {label}: bad output")
        ok, err = close(o, want, tol, tol)
        need(ok, f"flash {label}: o off by {err:.3g} > {tol} (1 + |want|)")
        ok, lerr = close(lse, want_lse, ltol, ltol)
        need(ok, f"flash {label}: lse off by {lerr:.3g} > {ltol} (1 + "
             "|want|)")
        extra = ""
        if dt == torch.bfloat16:
            worst = max(worst, err)
            ratio, late = flash_bf16_bound(torch, q, k, v, o, want, causal,
                                           off)
            bf16_worst["bound_ratio"] = max(bf16_worst["bound_ratio"], ratio)
            bf16_worst["late_rel_l2"] = max(bf16_worst["late_rel_l2"], late)
            need(ratio <= 1.0, f"flash {label}: o off by {ratio:.3g} x "
                 f"{FLASH_BF16_ATOL} + {FLASH_BF16_PV} (P|V|)/l + "
                 f"{FLASH_BF16_RTOL} |want|")
            need(late <= FLASH_LATE_REL_L2, f"flash {label}: late rows of o "
                 f"off by rel L2 {late:.3g} > {FLASH_LATE_REL_L2}")
            extra = (f", worst |o - plain| / bf16 bound {ratio:.3g}, late "
                     f"rows rel L2 {late:.3g} (within {FLASH_LATE_REL_L2})")
        log(f"flash {label} {(b, sq, skv, h, kvh, d)} causal={causal} "
            f"q_offset={off}: max |o - plain| {err:.3g} (within {tol} (1 + "
            f"|want|)), max |lse - plain| {lerr:.3g} (within {ltol})"
            f"{extra}")
        del q, k, v, o, lse, want, want_lse
    # the backward: FlashAttention's tiles from the saved lse against
    # autograd through the plain version, f32, q_offset and ragged tiles
    b, sq, skv, h, kvh, d, off = ((1, 384, 512, 8, 2, 128, 128) if timed
                                  else (1, 48, 64, 4, 2, 32, 16))
    q = torch.randn((b, sq, h, d), device=dev, requires_grad=True)
    k, v = (torch.randn((b, skv, kvh, d), device=dev, requires_grad=True)
            for _ in range(2))
    do = torch.randn((b, sq, h, d), device=dev)
    got = torch.autograd.grad(fa.FlashAttention.apply(
        q, k, v, True, None, off, sq // 3, skv // 3), (q, k, v), do)
    want = torch.autograd.grad(flash_attention_plain(
        q, k, v, causal=True, q_offset=off)[0], (q, k, v), do)
    bwd = max(float((a - w).norm() / w.norm()) for a, w in zip(got, want))
    need(bwd <= FLASH_BWD_TOL, f"flash backward: rel L2 {bwd:.3g} > "
         f"{FLASH_BWD_TOL}")
    log(f"flash backward {(b, sq, skv, h, kvh, d)} q_offset={off}: dq, dk, "
        f"dv within rel L2 {bwd:.3g} of autograd through the plain version "
        f"(gate {FLASH_BWD_TOL})")
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:79",
           "max_abs_err": worst, "bf16_bound_ratio": bf16_worst[
               "bound_ratio"], "bf16_late_rel_l2": bf16_worst["late_rel_l2"],
           "backward_rel_l2": bwd}
    if timed:
        row.update(time_flash(torch, dev, shapes["flash"]))
        log(f"timed: {json.dumps(row)}")
    return row


def flash_bf16_bound(torch, q, k, v, o, want, causal, q_offset):
    """(the largest |o - want| over FLASH_BF16_ATOL + FLASH_BF16_PV (P|V|)/l
    + FLASH_BF16_RTOL |want|, the relative L2 of o - want over the late
    rows) for a bf16 case; (P|V|)/l is the plain version in f32 on |v|."""
    from repro_torch.kernels.ref import flash_attention_plain
    pv = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                               causal=causal, q_offset=q_offset)[0]
    got, want = o.float(), want.float()
    bound = (FLASH_BF16_ATOL + FLASH_BF16_PV * pv
             + FLASH_BF16_RTOL * want.abs())
    ratio = float(((got - want).abs() / bound).max())
    first = min(FLASH_LATE_ROW, q.shape[1] // 2)
    return ratio, rel_l2(got[:, first:], want[:, first:])


def time_flash(torch, dev, shape):
    """Slice (e)'s attention in bf16, causal: the kernel (CUDA-graph
    replay, and eager), its plain version and
    F.scaled_dot_product_attention(is_causal, enable_gqa) on (b, h, s, d)
    copies made before timing (replay and eager too). The bound: q, k, v
    read and o, lse written once over the memory rate, against 4 b h s^2 d
    / 2 operations (causal) over the bf16 tensor-core peak."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_plain
    b, s, h, kvh, d = shape
    q = torch.randn((b, s, h, d), device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, s, kvh, d), device=dev).to(torch.bfloat16)
            for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    ok, err = close(lib().transpose(1, 2), fa.flash_attention(q, k, v)[0],
                    2e-2, 2e-2)
    need(ok, f"the SDPA yardstick computes another function (off by "
         f"{err:.3g})")
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * s
    t_bound, by = bound(nbytes, 4 * b * h * s * s * d / 2, "bf16")
    kern = lambda: fa.flash_attention(q, k, v)  # noqa: E731
    return {"shape": [b, s, h, kvh, d], "kernel": fa.kernel_for(q.dtype, d),
            "ms": graph_ms(torch, kern, calls=10, replays=5),
            "eager_ms": device_ms(torch, kern),
            "plain_ms": device_ms(torch, lambda: flash_attention_plain(
                q, k, v), 5, 1),
            "bound_ms": t_bound, "bound_by": by,
            "library_ms": graph_ms(torch, lib, calls=10, replays=5),
            "library_eager_ms": device_ms(torch, lib),
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal=True, enable_gqa=True) on (b, h, s, "
                            "d) copies"}


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------

def make_requests(np, Request, vocab, n, lo, hi, max_new, seed):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(2, vocab,
                                               size=int(rng.integers(lo, hi + 1))),
                    max_new_tokens=max_new) for i in range(n)]


def serve(torch, np, dev, cfg, params, ecfg_kw, reqs_fn):
    from repro_torch import kernels
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    eng = ServeEngine(cfg, params, EngineConfig(**ecfg_kw), device=dev)
    eng.warmup()
    reqs = reqs_fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    m = eng.metrics()
    need(len(done) == len(reqs), f"served {len(done)} of {len(reqs)}")
    ttft = sorted(r.ttft for r in eng.scheduler.finished)
    out = {
        "requests": len(done),
        "decode_tokens": eng.stats["decode_tokens"],
        "prefill_tokens": eng.stats["prefill_tokens"],
        "ticks": eng.stats["ticks"], "chunks": eng.stats["chunks"],
        "wall_s": wall,
        "tokens_per_s": eng.stats["decode_tokens"] / wall,
        "ttft_mean_s": float(np.mean(ttft)),
        "ttft_p50_s": float(np.median(ttft)),
        "ttft_max_s": float(ttft[-1]),
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if dev.type == "cuda" else None),
        "weight_bits": m["weight_bits"], "kv_bits": m["kv_bits"],
        "weight_bytes": m["weight_bytes"],
        "launches": counts,
    }
    streams = {r.rid: list(r.out_tokens) for r in done}
    for r in done:
        need(len(r.out_tokens) >= 1, f"rid {r.rid}: no tokens")
        need(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
             f"rid {r.rid}: token out of range")
    del eng
    return out, streams


def first_decode_logits(torch, np, dev, cfg, params, attn_quant, prompts,
                        max_seq, bs, chunk, policy=None, gather_params=None):
    """Prefill every prompt through the kernels into fresh pools (quantized
    per `policy`), then run the first decode step once through each path on
    its own copy of the pools: the kernels with `params`, and the gather
    path with `gather_params` (default: the same tree)."""
    from repro_torch.models import lm
    from repro_torch.nn.attention import PagedState
    from repro_torch.serve import kv_cache as kvc
    act = lm.make_act(cfg, dev)
    bps = kvc.blocks_for(max_seq, bs)
    cols = bps + chunk // bs
    slots = len(prompts)
    caches = kvc.init_paged_caches(cfg, slots * bps + 1, bs,
                                   dtype=lm.compute_dtype(params), device=dev,
                                   policy=policy)
    table = np.zeros((slots, cols), np.int32)
    for s in range(slots):
        table[s, :bps] = 1 + s * bps + np.arange(bps)
    buckets = kvc.decode_block_buckets(cols)
    i32 = dict(dtype=torch.int32, device=dev)
    for s, p in enumerate(prompts):
        ctx = len(p) - 1
        for p0 in kvc.chunk_starts(0, ctx, chunk):
            w = kvc.chunk_table_width(p0, chunk, bs, buckets)
            toks = np.zeros((1, chunk), np.int64)
            n = min(ctx - p0, chunk)
            toks[0, :n] = p[p0:p0 + n]
            st = PagedState(torch.tensor(table[s:s + 1, :w], **i32),
                            torch.tensor([p0], **i32),
                            torch.tensor([ctx], **i32))
            lm.prefill_step(params, cfg, torch.from_numpy(toks).to(dev),
                            caches, paged=st, act=act, paged_impl="kernel",
                            attn_quant=attn_quant, want_logits=False)
    lengths = np.array([len(p) - 1 for p in prompts], np.int32)
    w = kvc.bucket_for(kvc.blocks_for(int(lengths.max()) + 1, bs),
                       kvc.decode_block_buckets(bps))
    last = torch.tensor([[int(p[-1])] for p in prompts], device=dev)
    st = PagedState(torch.tensor(table[:, :w], **i32),
                    torch.tensor(lengths, **i32))
    out = {}
    for impl, tree in (("kernel", params),
                       ("gather", gather_params or params)):
        # the decode write is in place (and, on quantized pools, may raise a
        # block's exponent): each path writes its own copy
        own = tuple(tuple(type(c)(*[t.clone() if torch.is_tensor(t) else t
                                    for t in c]) for c in grp)
                    for grp in caches)
        logits, _ = lm.decode_step(tree, cfg, last, own, paged=st, act=act,
                                   paged_impl=impl, attn_quant=attn_quant)
        out[impl] = logits[:, -1].float()
        del own
    del caches
    return out["kernel"], out["gather"]


def mlp_dequantized(torch, params):
    """The packed tree with every MLP weight dequantized to the activations'
    dtype (the same values): the MLP then runs as a plain matrix product,
    the comparison path of slice (c)."""
    from repro_torch.models import lm
    from repro_torch.quant import weights as wq
    dt = lm.compute_dtype(params)
    out = dict(params)
    for name, reps in params.items():
        if name.startswith("group"):
            out[name] = [{ln: dict(layer, mlp={k: wq.dense(v, dt) for k, v
                                              in layer["mlp"].items()})
                          for ln, layer in rep.items()} for rep in reps]
    return out


def compare_streams(streams, other):
    same = total = 0
    for rid, toks in streams.items():
        o = other[rid]
        total += max(len(toks), len(o))
        same += sum(a == b for a, b in zip(toks, o))
    return same / total


def slice_phase(torch, np, dev, args, rehearse):
    from repro_torch.configs.archs import get_config
    from repro_torch.models import lm
    from repro_torch.models.config import GRAUConfig
    from repro_torch.nn.attention import AttnQuant
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.quant import weights as wq
    from repro_torch.quant.policy import PrecisionPolicy
    from repro_torch.serve.engine import Request

    cfg = get_config("llama3.2-3b", smoke=rehearse)
    dtype = torch.float32 if rehearse else torch.bfloat16
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=args.seed, dtype=dtype, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"init_lm {cfg.name} (d_model {cfg.d_model}, {cfg.num_layers} "
        f"layers, vocab {cfg.vocab_size}) {dtype} on {dev}: "
        f"{time.perf_counter() - t0:.1f} s")
    max_seq = 256 if rehearse else 2048
    lo, hi = (8, 100) if rehearse else (64, 1024)
    ecfg = dict(slots=8, max_seq=max_seq, page_size=16, seed=args.seed)
    reqs_fn = lambda: make_requests(np, Request, cfg.vocab_size, 8, lo, hi,  # noqa: E731
                                    32, args.seed)
    prompts = [r.prompt for r in reqs_fn()]
    attn = build_lm_grau("identity")
    aq = AttnQuant(attn.spec.to(dev), attn.s_in, attn.s_out)
    gcfg = cfg.replace(grau=GRAUConfig())
    results = {}
    for label, c, extra in (("float", cfg, {}),
                            ("grau", gcfg, {"attn_grau": attn})):
        res, streams = serve(torch, np, dev, c, params, {**ecfg, **extra},
                             reqs_fn)
        la = res["launches"]
        # (a CPU rehearsal runs the plain versions: no launches to count)
        need(rehearse or (la["paged_attention"] > 0
                          and la["paged_prefill"] > 0),
             f"{label}: the main path did not launch both attention kernels: "
             f"{la}")
        if label == "grau" and not rehearse:
            need(la["paged_attention_epilogue"] > 0
                 and la["paged_prefill_epilogue"] > 0,
                 f"grau: the fused GRAU epilogue did not run: {la}")
        gres, gstreams = serve(torch, np, dev, c, params,
                               {**ecfg, **extra, "paged_impl": "gather"},
                               reqs_fn)
        res["gather_tokens_per_s"] = gres["tokens_per_s"]
        res["greedy_identical_share"] = compare_streams(streams, gstreams)
        lk, lg = first_decode_logits(torch, np, dev, c, params,
                                     aq if "attn_grau" in extra else None,
                                     prompts, max_seq, 16, 32)
        results[label] = check_logits(torch, label, res, lk, lg)
    if args.profile:
        for label, c, extra in (("float", cfg, {}),
                                ("grau", gcfg, {"attn_grau": attn})):
            results[f"profile_{label}"] = profile_serve(
                torch, dev, c, params, {**ecfg, **extra}, reqs_fn,
                f"{args.profile}.{label}.txt", label)
    # (c): the same weights packed to int4 and int4 KV pools, with GRAU. The
    # float tree is dropped before serving: the served model is the packed one
    policy = PrecisionPolicy(kv_default_bits=4, weight_default_bits=4)
    packed = wq.pack_params(params, gcfg, policy)
    del params
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    label = "wq4_kv4_grau"
    qcfg = {**ecfg, "attn_grau": attn, "weight_bits": 4, "kv_bits": 4}
    res, streams = serve(torch, np, dev, gcfg, packed, qcfg, reqs_fn)
    la = res["launches"]
    mlp_per_forward = 3 * gcfg.num_layers
    res["matmul_wq_launches_per_forward"] = mlp_per_forward
    if not rehearse:
        need(la["matmul_wq"] == mlp_per_forward * (res["ticks"]
                                                   + res["chunks"]),
             f"{label}: matmul_wq launched {la['matmul_wq']} times, want "
             f"{mlp_per_forward} x ({res['ticks']} ticks + {res['chunks']} "
             "chunks)")
        need(la["paged_attention"] > 0 and la["paged_prefill"] > 0
             and la["paged_attention_kv4"] == la["paged_attention"]
             and la["paged_prefill_kv4"] == la["paged_prefill"]
             and la["paged_attention_epilogue"] == la["paged_attention"],
             f"{label}: the attention kernels did not all run on 4-bit pools "
             f"with the GRAU epilogue: {la}")
    plain = mlp_dequantized(torch, packed)
    gres, gstreams = serve(torch, np, dev, gcfg, plain,
                           {**ecfg, "attn_grau": attn, "kv_bits": 4,
                            "paged_impl": "gather"}, reqs_fn)
    res["gather_tokens_per_s"] = gres["tokens_per_s"]
    res["greedy_identical_share"] = compare_streams(streams, gstreams)
    lk, lg = first_decode_logits(torch, np, dev, gcfg, packed, aq, prompts,
                                 max_seq, 16, 32, policy=policy,
                                 gather_params=plain)
    del plain
    results[label] = check_logits(torch, label, res, lk, lg)
    if args.profile:
        results[f"profile_{label}"] = profile_serve(
            torch, dev, gcfg, packed, qcfg, reqs_fn,
            f"{args.profile}.{label}.txt", label)
    return results


# ---------------------------------------------------------------------------
# phase 2b: the paged kernels at the new archs' GQA groups, over shared
# blocks, and the copy-on-write block copy
# ---------------------------------------------------------------------------

def group_shapes(shapes, timed):
    """(label, shapes) of glm4-9b's GQA group of 16 (32 heads over 2) and
    qwen1.5-32b's group of 1 (40 over 40), head_dim 128, at the main path's
    slots, page, chunk and max_len (smaller head counts in a rehearsal)."""
    heads = ((32, 2), (40, 40)) if timed else ((16, 1), (4, 4))
    return [(f"g{h // kvh}", dict(shapes, h=h, kvh=kvh)) for h, kvh in heads]


def check_paged_groups(torch, np, dev, shapes, rng, timed):
    """Decode and prefill, bf16 q split over several parts, at GQA groups 16
    and 1 on 16- and 4-bit pools with the fused GRAU epilogue (the checks
    and float64 gates of decode_parts_case / prefill_parts_case); a prefill
    chunk over table blocks shared with another slot's row; and
    copy_pool_block byte-exact on 16-, 8- and 4-bit pools."""
    from repro_torch.nn.common import build_lm_grau
    g = build_lm_grau("identity")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}
    for label, s in group_shapes(shapes, timed):
        for bits in (16, 4):
            key = f"{label}_kv{bits}"
            dparts, dvs = decode_parts_case(torch, np, dev, s, rng, bits, g,
                                            sync, draws=2, tag=label)
            pparts, pvs = prefill_parts_case(torch, np, dev, s, rng, bits, g,
                                             sync, draws=2, tag=label)
            out[key] = {"h": s["h"], "kvh": s["kvh"], "decode_parts": dparts,
                        "decode_f32_vs_f64": dvs, "prefill_parts": pparts,
                        "prefill_f32_vs_f64": pvs}
    out["decode_bucket"] = decode_bucket_case(torch, np, dev, shapes, rng, g,
                                              sync)
    for bits in (16, 4):
        out[f"shared_prefill_kv{bits}"] = shared_prefill_case(
            torch, np, dev, shapes, rng, bits, sync)
    out["copy_pool_block"] = copy_block_case(torch, np, dev, shapes, rng,
                                             sync)
    return out


def decode_bucket_case(torch, np, dev, s, rng, g, sync):
    """One bf16 decode tick at the main shape with the fused GRAU epilogue,
    its table sliced to a quarter of the slot capacity and to all of it,
    every length inside the quarter. As column views of one table (the
    engine's buckets, planned from the row stride) the f32, bf16 and GRAU
    outputs must be the same bits at both widths; as contiguous copies of
    those columns (each planned from its own width, so the two cut a slot
    at different blocks) the elements that differ are counted and
    reported."""
    from repro_torch.kernels import paged_attention as pa
    (q, k, v, table, _), _ = paged_case(torch, np, dev, torch.bfloat16, s,
                                        rng, 16)
    cap = table.shape[1]
    quarter = cap // 4
    lengths = torch.from_numpy(rng.integers(
        1, quarter * s["bs"] + 1, size=q.shape[0]).astype(np.int32)).to(dev)
    out = {}
    for key, copy in (("capacity_planned", False), ("width_planned", True)):
        runs = []
        for width in (quarter, cap):
            tab = table[:, :width].contiguous() if copy else table[:, :width]
            args = (q, k, v, tab, lengths)
            runs.append((
                pa.paged_attention(*args, out_dtype=torch.float32),
                pa.paged_attention(*args),
                pa.paged_attention(*args, spec=g.spec, s_in=g.s_in)))
        sync()
        out[key] = {name: int((a != b).sum()) for name, a, b in
                    zip(("f32", "bf16", "grau"), *runs)}
    out["elements"] = q.numel()
    need(not any(out["capacity_planned"].values()),
         f"decode at widths {quarter} and {cap} of one table: "
         f"{out['capacity_planned']} elements differ")
    log(f"decode bucket: widths {quarter} and {cap} of {q.numel()} output "
        f"elements, lengths {lengths.tolist()}: views of one table "
        f"{out['capacity_planned']} differ; contiguous copies (planned from "
        f"the width) {out['width_planned']} differ")
    return out


def shared_prefill_case(torch, np, dev, s, rng, kv_bits, sync):
    """A bf16 prefill chunk of slot 1 whose first table blocks are slot 0's
    (a cached prefix pinned into two rows): its f32 output within F32_TOL of
    the plain version's, and the same bits as through private copies of
    those blocks (copy_pool_block)."""
    from functools import partial

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.nn.attention import PagedKVCache, QuantPagedKVCache
    from repro_torch.serve import kv_cache as kvc
    (_, k, v, table, _), kv = paged_case(torch, np, dev, torch.bfloat16, s,
                                         rng, kv_bits)
    C, bs = s["chunk"], s["bs"]
    shared = s["max_len"] // bs // 2
    start = torch.tensor([shared * bs], dtype=torch.int32, device=dev)
    width = -(-(shared * bs + C) // bs)
    rows = table[:3, :width].clone()
    rows[1, :shared] = rows[0, :shared]
    q = torch.randn((1, C, s["h"], s["d"]), device=dev).to(torch.bfloat16)
    kern = partial(pa.paged_prefill_attention, out_dtype=torch.float32, **kv)
    row = rows[1:2].contiguous()
    f32 = kern(q, k, v, row, start)
    sync()
    ok, err = close(f32, pa.paged_prefill_plain(q, k, v, row, start,
                                                out_dtype=torch.float32,
                                                **kv), F32_TOL, F32_TOL)
    need(ok, f"shared prefill kv{kv_bits}: f32 output off by {err:.3g}")
    pool = (PagedKVCache(k[None], v[None]) if kv_bits == 16 else
            QuantPagedKVCache(k[None], v[None], kv["k_exp"][None],
                              kv["v_exp"][None], kv_bits))
    own = rows[2:3].contiguous()          # slot 2's blocks take the copies
    for src, dst in zip(rows[0, :shared].tolist(), own[0, :shared].tolist()):
        kvc.copy_pool_block(((pool,),), src, dst)
    own[0, shared:] = row[0, shared:]
    same = bool(torch.equal(kern(q, k, v, own, start), f32))
    sync()
    need(same, f"shared prefill kv{kv_bits}: not the bits of private copies")
    log(f"paged_prefill kv{kv_bits} over {shared} table blocks shared with "
        f"another row (start {int(start)}): f32 output {err:.3g} from plain, "
        "the same bits as through private copies")
    return {"shared_blocks": shared, "f32_vs_plain": err,
            "same_bits_as_private_copies": same}


def copy_block_case(torch, np, dev, s, rng, sync):
    """copy_pool_block on 16-, 8- and 4-bit pools of two layers: block dst
    becomes block src in every buffer (payload and exponent planes), byte
    for byte, and nothing else moves."""
    from repro_torch.nn.attention import PagedKVCache, QuantPagedKVCache
    from repro_torch.serve import kv_cache as kvc
    out = {}
    nb, shape = 64, (64, s["bs"], s["kvh"], s["d"])
    for bits in (16, 8, 4):
        layers = []
        for _ in range(2):
            k, v, kv = random_pools(torch, dev, torch.bfloat16, shape, bits)
            layers.append(PagedKVCache(k[None], v[None]) if bits == 16 else
                          QuantPagedKVCache(k[None], v[None],
                                            kv["k_exp"][None],
                                            kv["v_exp"][None], bits))
        src, dst = (int(x) for x in rng.choice(np.arange(1, nb), 2,
                                               replace=False))
        bufs = [b for pool in layers for b in pool if torch.is_tensor(b)]
        want = []
        for b in bufs:
            w = b.clone()
            w[:, dst] = b[:, src]
            want.append(w)
        kvc.copy_pool_block((tuple(layers),), src, dst)
        sync()
        same = all(torch.equal(b.view(torch.uint8), w.view(torch.uint8))
                   for b, w in zip(bufs, want))
        need(same, f"copy_pool_block kv{bits}: not byte-exact")
        out[f"kv{bits}"] = {"buffers": len(bufs), "byte_exact": same}
    log(f"copy_pool_block on the card: byte-exact on 16-, 8- and 4-bit pools "
        f"({json.dumps(out)})")
    return out


# ---------------------------------------------------------------------------
# slice (f): the prefix cache, preemption and cancel
# ---------------------------------------------------------------------------

def total_pins(radix) -> int:
    stack, n = [radix.root], 0
    while stack:
        node = stack.pop()
        n += node.pins
        stack.extend(node.children.values())
    return n


def drive(eng, reqs, first_alone, hooks=()):
    """Serve `reqs`: with `first_alone`, submit the first one alone and step
    until its prefill is done, then the rest; else all at once. `hooks` are
    called with the engine after every step, each until it returns True.
    Returns (polled requests, wall s)."""
    done, pending = [], list(hooks)
    t0 = time.perf_counter()
    first = reqs[0]
    rest = reqs[1:] if first_alone else []
    for r in ([first] if first_alone else reqs):
        eng.submit(r)

    def prefilled():
        return (first.rid not in [r.rid for r in eng.scheduler.waiting]
                and not any(r is not None and r.rid == first.rid
                            and r.pending_chunks for r in eng.slot_req))
    while rest and not prefilled():
        eng.step()
        done.extend(eng.poll())
    for r in rest:
        eng.submit(r)
    steps = 0
    while eng.scheduler.waiting or any(r is not None for r in eng.slot_req):
        eng.step()
        done.extend(eng.poll())
        pending = [h for h in pending if not h(eng)]
        steps += 1
        need(steps < 100_000, "the engine did not finish")
    done.extend(eng.poll())
    return done, time.perf_counter() - t0


def shared_prefix_trace(np, Request, vocab, full, seed):
    """16 requests: one shared prefix (1024 tokens; 128 in a rehearsal)
    then each its own suffix of 16-256 tokens (16-64), 32 new tokens
    (8), all drawn from `seed`."""
    rng = np.random.default_rng(seed + 17)
    plen, (lo, hi), new = (1024, (16, 256), 32) if full else (128, (16, 64),
                                                              8)
    prefix = rng.integers(2, vocab, size=plen)
    return plen, [Request(rid=i, prompt=np.concatenate(
        [prefix, rng.integers(2, vocab, size=int(rng.integers(lo, hi + 1)))]),
        max_new_tokens=new) for i in range(16)]


def overload_trace(np, Request, vocab, scale, seed):
    """12 requests of 512-1024 prompt tokens (each length divided by
    `scale` in a rehearsal) and 64 new tokens (/ scale), in an arrival order
    that makes the head of the queue wait while shorter later arrivals are
    admitted past it: two long prompts (992-1023) and two short ones
    (512-559), then the head (1024), then seven of 560-1023, shortest
    first. With 256 usable blocks of 16 tokens, the first four reserve
    200-216 blocks, the head needs 68 and the shortest later arrival 39-42
    (admitted past it); when a short one retires, the head preempts."""
    rng = np.random.default_rng(seed + 29)
    lens = ([int(x) for x in rng.integers(992, 1024, size=2)]
            + [int(x) for x in rng.integers(512, 560, size=2)] + [1024]
            + sorted(int(x) for x in rng.integers(560, 1024, size=7)))
    lens[5] = min(lens[5], 600)          # the first later arrival fits
    return [Request(rid=i, prompt=rng.integers(2, vocab, size=n // scale),
                    max_new_tokens=64 // scale) for i, n in enumerate(lens)]


def served(eng, done, wall, counts):
    ttft = sorted(r.ttft for r in eng.scheduler.finished if r.ttft)
    m = eng.metrics()
    return {"requests": len(done), "prefill_tokens": m["prefill_tokens"],
            "cached_prefix_tokens": m["cached_prefix_tokens"],
            "prefix_hit_rate": m["prefix_hit_rate"],
            "preempted": m["preempted"], "hol_skips": m["hol_skips"],
            "evictions": m["evictions"], "chunks": m["chunks"],
            "ticks": m["ticks"], "decode_tokens": m["decode_tokens"],
            "wall_s": wall, "tokens_per_s": m["decode_tokens"] / wall,
            "ttft_mean_s": float(sum(ttft) / len(ttft)),
            "ttft_p50_s": float(ttft[len(ttft) // 2]),
            "launches": counts}


def need_kernels(counts, label, rehearse):
    """The run went through both attention kernels with the epilogue (a
    CPU rehearsal runs the plain versions: no launches to count)."""
    need(rehearse or all(counts[k] > 0 for k in (
        "paged_attention", "paged_prefill", "paged_attention_epilogue",
        "paged_prefill_epilogue")),
        f"{label}: the attention kernels (with the fused GRAU epilogue) did "
        f"not both run: {counts}")


def pool_returned(eng, label):
    """After poll(): evicting the whole radix cache leaves every block free
    and no pin held."""
    pins = total_pins(eng.radix)
    eng.radix.evict(eng.allocator.num_blocks)
    free = eng.allocator.free_blocks
    need(pins == 0 and free == eng.allocator.num_blocks - 1,
         f"{label}: {free} of {eng.allocator.num_blocks - 1} blocks free, "
         f"{pins} pins held after every request finished")
    return {"free_blocks": free, "pins": pins}


def first_divergence(streams, other):
    """(rid, index) of the earliest token where two runs' streams differ."""
    best = None
    for rid, toks in streams.items():
        j = next((i for i, (a, b) in enumerate(zip(toks, other[rid]))
                  if a != b), None)
        if j is not None and (best is None or j < best[1]):
            best = (rid, j)
    return best


def prefix_slice(torch, np, dev, args, rehearse):
    """Slice (f), at llama3.2-3b's full width and depth in slice (b)'s
    setup (GRAU MLP, fused GRAU attention epilogue, 16-bit pools, 8 slots,
    max_seq 2048, page 16, chunk 32; weights from --seed; EOS off, so every
    stream runs its full budget): the shared-prefix trace cache-off and
    cache-on (streams the same bits; 15 x 1024 prefix tokens cached, as
    many fewer computed), the overload trace on 256 usable blocks (every
    request complete, preemptions, the pool returned) beside an unpreempted
    run, and cancels mid-prefill and mid-decode."""
    from repro_torch import kernels
    from repro_torch.configs.archs import get_config
    from repro_torch.models import lm
    from repro_torch.models.config import GRAUConfig
    from repro_torch.nn.attention import AttnQuant
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    cfg = get_config("llama3.2-3b", smoke=rehearse).replace(grau=GRAUConfig())
    dtype = torch.float32 if rehearse else torch.bfloat16
    params = lm.init_lm(cfg, seed=args.seed, dtype=dtype, device=dev)
    attn = build_lm_grau("identity")
    max_seq = 256 if rehearse else 2048
    base = dict(slots=8, max_seq=max_seq, page_size=16, prefill_chunk=32,
                attn_grau=attn, eos_id=-1, seed=args.seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "max_seq": max_seq}

    def run(kw, reqs, hooks=(), first_alone=True):
        eng = ServeEngine(cfg, params, EngineConfig(**{**base, **kw}),
                          device=dev)
        eng.warmup()
        sync()
        kernels.reset_launches()
        done, wall = drive(eng, reqs, first_alone, hooks)
        sync()
        counts = kernels.launch_counts()
        return eng, done, served(eng, done, wall, counts)

    # shared prefix: cache off, then on
    plen, _ = shared_prefix_trace(np, Request, cfg.vocab_size, not rehearse,
                                  args.seed)
    streams = {}
    for on in (False, True):
        _, trace = shared_prefix_trace(np, Request, cfg.vocab_size,
                                       not rehearse, args.seed)
        eng, done, res = run({"prefix_cache": on}, trace)
        label = f"shared_prefix_cache_{'on' if on else 'off'}"
        need(len(done) == 16 and all(len(r.out_tokens) == r.max_new_tokens
                                     for r in done),
             f"{label}: {len(done)} of 16 served in full")
        need_kernels(res["launches"], label, rehearse)
        streams[on] = {r.rid: list(r.out_tokens) for r in done}
        out[label] = res
        log(f"slice[f] {label}: prefill_tokens {res['prefill_tokens']}, hit "
            f"rate {res['prefix_hit_rate']:.4f}, TTFT mean "
            f"{res['ttft_mean_s']:.3f} s (p50 {res['ttft_p50_s']:.3f}), "
            f"decode {res['tokens_per_s']:.1f} tokens/s")
        del eng
    off, on = out["shared_prefix_cache_off"], out["shared_prefix_cache_on"]
    need(streams[True] == streams[False],
         "shared prefix: cache-on and cache-off streams differ")
    want = 15 * plen
    need(on["cached_prefix_tokens"] == want
         and off["prefill_tokens"] - on["prefill_tokens"] == want,
         f"shared prefix: {on['cached_prefix_tokens']} prefix tokens cached "
         f"and {off['prefill_tokens'] - on['prefill_tokens']} fewer "
         f"computed, want {want} each")
    out["shared_prefix_streams_identical"] = True
    log(f"slice[f] shared prefix: cache-on and cache-off streams identical; "
        f"{want} = 15 x {plen} prefix tokens cached, as many fewer computed")

    # cancel, during the same trace with the cache on
    cancelled = {}

    def cancel_mid_prefill(eng):
        for slot in eng._prefilling:
            rs = eng.slot_req[slot]
            if rs.rid != 0 and rs.computed_prefill_tokens > 0:
                need(eng.cancel(rs.rid), "cancel mid-prefill refused")
                cancelled["mid_prefill"] = rs.rid
                return True
        return False

    def cancel_mid_decode(eng):
        for rs in eng.slot_req:
            if (rs is not None and rs.rid not in cancelled.values()
                    and 0 < len(rs.out_tokens) < rs.max_new_tokens - 2):
                need(eng.cancel(rs.rid), "cancel mid-decode refused")
                cancelled["mid_decode"] = rs.rid
                return True
        return False
    _, trace = shared_prefix_trace(np, Request, cfg.vocab_size, not rehearse,
                                   args.seed)
    eng, done, res = run({"prefix_cache": True}, trace,
                         (cancel_mid_prefill, cancel_mid_decode))
    need(set(cancelled) == {"mid_prefill", "mid_decode"},
         f"cancel: only {cancelled} happened")
    reasons = {rs.rid: rs.finish_reason for rs in eng.scheduler.finished}
    need(len(done) == 16 and all(reasons[rid] == "cancelled"
                                 for rid in cancelled.values()),
         f"cancel: {len(done)} polled, reasons {reasons}")
    need(all(len(r.out_tokens) == r.max_new_tokens for r in done
             if r.rid not in cancelled.values()),
         "cancel: another stream was cut")
    res.update(cancelled=cancelled, pool=pool_returned(eng, "cancel"))
    out["cancel"] = res
    log(f"slice[f] cancel: rid {cancelled['mid_prefill']} mid-prefill and "
        f"rid {cancelled['mid_decode']} mid-decode came back 'cancelled'; "
        f"pool returned {res['pool']}")
    del eng

    # overload: preemption on 256 usable blocks, beside an unpreempted run
    scale = 4 if rehearse else 1
    ov_seq = 2048 // scale
    kw = dict(prefix_cache=True, preempt_after_ticks=8, max_seq=ov_seq)
    if rehearse:
        kw.update(page_size=4, prefill_chunk=8)
    blocks = 1 + 256
    reqs = overload_trace(np, Request, cfg.vocab_size, scale, args.seed)
    eng, done, res = run({**kw, "num_blocks": blocks}, reqs,
                         first_alone=False)
    need(len(done) == 12 and all(len(r.out_tokens) == r.max_new_tokens
                                 for r in done),
         f"overload: {len(done)} of 12 finished in full")
    need(res["preempted"] > 0, "overload: no request was preempted")
    need_kernels(res["launches"], "overload", rehearse)
    res["pool"] = pool_returned(eng, "overload")
    res["prompt_lens"] = [len(r.prompt) for r in
                          overload_trace(np, Request, cfg.vocab_size, scale,
                                         args.seed)]
    pre = {r.rid: list(r.out_tokens) for r in done}
    del eng
    reqs = overload_trace(np, Request, cfg.vocab_size, scale, args.seed)
    eng, done, roomy = run(kw, reqs, first_alone=False)
    need(roomy["preempted"] == 0, "overload: the roomy run preempted")
    base_streams = {r.rid: list(r.out_tokens) for r in done}
    del eng
    res["identical_share"] = compare_streams(pre, base_streams)
    res["unpreempted_tokens_per_s"] = roomy["tokens_per_s"]
    div = first_divergence(pre, base_streams)
    if div is not None:
        rid, j = div
        prompt = reqs[rid].prompt
        ctx = np.concatenate([prompt, np.asarray(base_streams[rid][:j])])
        aq = AttnQuant(attn.spec.to(dev), attn.s_in, attn.s_out)
        lk, _ = first_decode_logits(torch, np, dev, cfg, params, aq, [ctx],
                                    ov_seq, 16, 32)
        top = torch.topk(lk[0], 2).values
        res["first_divergence"] = {"rid": rid, "token": j,
                                   "top2_logit_gap": float(top[0] - top[1])}
    out["overload"] = res
    log(f"slice[f] overload: {res['preempted']} preemptions, "
        f"{res['hol_skips']} head-of-line skips, every request complete, "
        f"pool returned {res['pool']}; streams identical to the unpreempted "
        f"run: {res['identical_share']:.4f} of tokens"
        + (f"; first divergence {res['first_divergence']}" if div else ""))
    return out


# ---------------------------------------------------------------------------
# slice (g): glm4-9b and qwen1.5-32b on the card
# ---------------------------------------------------------------------------

QWEN_LAYERS = 16     # of 64: all 64 in bf16 take ~70 GB, which leaves no
# room for the pools and activations on one 80 GB card, and packing needs
# the bf16 tree first


def new_archs_slice(torch, np, dev, args, rehearse):
    """Slice (g), in slice (b)'s setup (GRAU MLP, fused GRAU attention
    epilogue, bf16, 8 slots, max_seq 2048, page 16, chunk 32) and its 8
    requests: glm4-9b at full width and depth (a GQA group of 16, an untied
    head) and qwen1.5-32b at full width and QWEN_LAYERS layers (MHA, QKV
    bias, an untied head), each through the kernels and through the gather
    path, the first decode logits of the two within the GRAU slice's
    tolerance."""
    from repro_torch.configs.archs import get_config
    from repro_torch.models import lm
    from repro_torch.models.config import GRAUConfig, dense_groups
    from repro_torch.nn.attention import AttnQuant
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.serve.engine import Request

    attn = build_lm_grau("identity")
    aq = AttnQuant(attn.spec.to(dev), attn.s_in, attn.s_out)
    dtype = torch.float32 if rehearse else torch.bfloat16
    max_seq = 256 if rehearse else 2048
    lo, hi = (8, 100) if rehearse else (64, 1024)
    ecfg = dict(slots=8, max_seq=max_seq, page_size=16, seed=args.seed,
                attn_grau=attn)
    out = {}
    for arch, label in (("glm4-9b", "glm4_grau"), ("qwen1.5-32b",
                                                   "qwen_grau")):
        cfg = get_config(arch, smoke=rehearse).replace(grau=GRAUConfig())
        cut = None
        if arch == "qwen1.5-32b" and not rehearse:
            cut = (f"{QWEN_LAYERS} of {cfg.num_layers} layers: the bf16 "
                   "weights of all 64 take ~70 GB, leaving no room for the "
                   "pools and activations on one 80 GB card")
            cfg = cfg.replace(groups=dense_groups(QWEN_LAYERS))
        t0 = time.perf_counter()
        params = lm.init_lm(cfg, seed=args.seed, dtype=dtype, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        nparams = sum(t.numel() for t in iter_tensors(params))
        log(f"init_lm {cfg.name} (d_model {cfg.d_model}, {cfg.num_layers} "
            f"layers, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
            f"untied head, qkv_bias {cfg.qkv_bias}; {nparams / 1e9:.2f} B "
            f"parameters) {dtype}: {time.perf_counter() - t0:.1f} s"
            + (f"; depth cut to {cut}" if cut else ""))
        reqs_fn = lambda: make_requests(  # noqa: E731
            np, Request, cfg.vocab_size, 8, lo, hi, 32, args.seed)
        res, streams = serve(torch, np, dev, cfg, params, ecfg, reqs_fn)
        need_kernels(res["launches"], label, rehearse)
        gres, gstreams = serve(torch, np, dev, cfg, params,
                               {**ecfg, "paged_impl": "gather"}, reqs_fn)
        res["gather_tokens_per_s"] = gres["tokens_per_s"]
        res["greedy_identical_share"] = compare_streams(streams, gstreams)
        lk, lg = first_decode_logits(torch, np, dev, cfg, params, aq,
                                     [r.prompt for r in reqs_fn()], max_seq,
                                     16, 32)
        res.update(arch=cfg.name, layers=cfg.num_layers,
                   params_b=nparams / 1e9, depth_cut=cut)
        out[label] = check_logits(torch, label, res, lk, lg)
        del params, lk, lg
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice (h): sampled decoding, telemetry and traces, fault containment
# ---------------------------------------------------------------------------

# (temperature, top_k, top_p) of slice (h)'s sampled requests, in turn
SAMPLED = [(0.0, 0, 1.0), (0.8, 40, 0.9), (1.0, 50, 1.0), (0.7, 0, 0.95)]
CHI2_P = 1e-3           # the 16-way chi-square's p-value must exceed this
NEAR_TIE_ULPS = 2       # a card-vs-CPU token flip is allowed only when its
# two candidates' logit / T + gumbel lie within this many f32 ulps


def f32_ulps(a, b):
    """Distance of two f32 values in units in the last place."""
    import struct

    def key(x):
        i = struct.unpack("<i", struct.pack("<f", float(x)))[0]
        return i if i >= 0 else -(i & 0x7FFFFFFF)
    return abs(key(a) - key(b))


def sampler_check(torch, np, dev, vocab, seed, full):
    """Part 1: the sampler on the card against the sampler on the CPU, on
    the same (8, vocab) f32 logits and keys, 32 draws under each of the
    four SamplingParams: raw bits equal, tokens equal but for reported
    near-ties; then a chi-square of draws at a 16-way distribution, keys
    fold_in(base, i), against its softmax."""
    from repro_torch.serve import prng
    from repro_torch.serve import sampling as samp
    gen = torch.Generator().manual_seed(seed + 41)
    logits = torch.randn(8, vocab, generator=gen) * 3.0
    ldev = logits.to(dev)
    base = prng.prng_key(seed)
    seeds = torch.tensor([(7919 * i + 13) & 0x7FFFFFFF for i in range(8)])
    out = {"vocab": vocab, "draws": 0, "flips": [], "bits_compared": 0}
    for params in SAMPLED:
        sp = samp.pack([samp.SamplingParams(*params)] * 8)
        for d in range(32):
            keys = prng.fold_in(prng.fold_in(base, seeds), d)
            kdev = keys.to(dev)
            bits = prng.random_bits(kdev, (vocab,)).cpu()
            need(torch.equal(bits, prng.random_bits(keys, (vocab,))),
                 f"sampler: card and CPU bits differ ({params}, draw {d})")
            out["bits_compared"] += bits.numel()
            got = samp.sample(ldev, sp, kdev).cpu()
            want = samp.sample(logits, sp, keys)
            out["draws"] += 8
            for s in torch.nonzero(got != want).flatten().tolist():
                a, b = int(want[s]), int(got[s])
                vc = (prng.gumbel(keys[s:s + 1], (vocab,))
                      + samp.filter_logits(logits[s:s + 1], samp.pack(
                          [samp.SamplingParams(*params)])))[0]
                vd = (prng.gumbel(kdev[s:s + 1], (vocab,))
                      + samp.filter_logits(ldev[s:s + 1], samp.pack(
                          [samp.SamplingParams(*params)])))[0].cpu()
                gap = min(f32_ulps(vc[a], vc[b]), f32_ulps(vd[a], vd[b]))
                flip = {"params": params, "draw": d, "slot": s, "cpu": a,
                        "card": b, "gap_ulps": gap}
                log(f"slice[h] sampler flip: {flip}")
                out["flips"].append(flip)
    need(all(f["gap_ulps"] <= NEAR_TIE_ULPS for f in out["flips"]),
         f"sampler: a card/CPU token flip is not a near-tie: {out['flips']}")
    # chi-square at a fixed 16-way distribution
    from scipy import stats
    n = 200_000 if full else 20_000
    l16 = torch.linspace(-2.0, 1.0, 16)
    keys = prng.fold_in(base.to(dev), torch.arange(n, device=dev))
    sp = samp.pack([samp.SamplingParams(1.0)] * n)
    toks = samp.sample(l16.to(dev).expand(n, 16).contiguous(), sp, keys)
    counts = torch.bincount(toks.cpu(), minlength=16).double().numpy()
    expect = torch.softmax(l16.double(), 0).numpy() * n
    chi2, p = stats.chisquare(counts, expect)
    out.update(chi2_draws=n, chi2=float(chi2), chi2_p=float(p))
    need(p > CHI2_P, f"sampler: chi-square p = {p:.3g} <= {CHI2_P} over {n} "
         "draws")
    if dev.type == "cuda":
        sp = samp.pack([samp.SamplingParams(*SAMPLED[1])] * 8)
        keys = prng.fold_in(prng.fold_in(base, seeds), 0).to(dev)
        out["sample_ms"] = device_ms(torch, lambda: samp.sample(ldev, sp,
                                                                keys))
        out["argmax_ms"] = device_ms(torch, lambda: torch.argmax(ldev, -1))
    log(f"slice[h] sampler: {out['bits_compared']} bits equal card / CPU; "
        f"{out['draws']} draws, {len(out['flips'])} flips (near-ties); "
        f"chi-square {out['chi2']:.2f} over {n} draws, p {out['chi2_p']:.3g}"
        + (f"; sample() {out['sample_ms']:.3f} ms, argmax "
           f"{out['argmax_ms']:.4f} ms" if "sample_ms" in out else ""))
    return out


def with_sampling(reqs):
    from repro_torch.serve.sampling import SamplingParams
    for i, r in enumerate(reqs):
        r.sampling = SamplingParams(*SAMPLED[i % len(SAMPLED)])
    return reqs


def timed_drive(eng, reqs, sync):
    """Submit every request, step and poll to the end, recording after each
    step (ticks, seconds since submit, {rid: tokens so far}). Returns
    (done, wall s, timeline)."""
    done, timeline = [], []
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    live = {r.rid: r for r in reqs}
    while eng.scheduler.waiting or any(r is not None for r in eng.slot_req):
        eng.step()
        done.extend(eng.poll())
        timeline.append((eng.stats["ticks"], time.perf_counter() - t0,
                         {rid: len(r.out_tokens) for rid, r in live.items()}))
        need(len(timeline) < 100_000, "the engine did not finish")
    done.extend(eng.poll())
    sync()
    return done, time.perf_counter() - t0, timeline


def phase_quantiles(eng):
    h = eng.registry.get("serve_tick_phase_seconds")
    return {ph: {"p50_s": h.labels(phase=ph).quantile(50),
                 "p99_s": h.labels(phase=ph).quantile(99),
                 "count": h.labels(phase=ph).count}
            for ph in ("schedule", "dispatch", "device_step", "drain")}


def sampled_slice(torch, np, dev, args, rehearse, greedy_f=None,
                  greedy_b=None):
    """Slice (h), at llama3.2-3b's full width and depth in slice (b)'s
    setup (GRAU MLP, fused GRAU attention epilogue, 16-bit pools, 8 slots,
    max_seq 2048, page 16, chunk 32; weights from --seed; EOS off): (1) the
    sampler card vs CPU; (2) (f)'s shared-prefix trace sampled, cache off
    and on; (3) (b)'s 8 requests sampled with telemetry on and off; (4)
    one FaultPlan on them (nan_logits, chunk_error, a deadline, a slow
    step); (5) real NaN in a decoding slot's block under (a)'s float
    setup (gated) and (b)'s epilogue (printed)."""
    from repro_torch import kernels
    from repro_torch.configs.archs import get_config
    from repro_torch.models import lm
    from repro_torch.models.config import GRAUConfig
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.serve import faults as faults_lib
    from repro_torch.serve import trace as trace_lib
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    full = not rehearse
    cfg = get_config("llama3.2-3b", smoke=rehearse)
    gcfg = cfg.replace(grau=GRAUConfig())
    dtype = torch.float32 if rehearse else torch.bfloat16
    params = lm.init_lm(gcfg, seed=args.seed, dtype=dtype, device=dev)
    attn = build_lm_grau("identity")
    max_seq = 256 if rehearse else 2048
    base = dict(slots=8, max_seq=max_seq, page_size=16, prefill_chunk=32,
                attn_grau=attn, eos_id=-1, seed=args.seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "max_seq": max_seq, "launches": {}}

    def engine(kw, c=gcfg):
        eng = ServeEngine(c, params, EngineConfig(**{**base, **kw}),
                          device=dev)
        eng.warmup()
        sync()
        kernels.reset_launches()
        return eng

    def launches(label, need_epilogue=True):
        counts = kernels.launch_counts()
        out["launches"][label] = counts
        if need_epilogue:
            need_kernels(counts, f"slice (h) {label}", rehearse)
        else:
            need(rehearse or (counts["paged_attention"] > 0
                              and counts["paged_prefill"] > 0),
                 f"slice (h) {label}: the attention kernels did not both "
                 f"run: {counts}")
        return counts

    # 1. the sampler, card against CPU
    out["sampler"] = sampler_check(torch, np, dev, cfg.vocab_size, args.seed,
                                   full)

    # 2. sampled serving of (f)'s shared-prefix trace, cache off and on
    plen, _ = shared_prefix_trace(np, Request, cfg.vocab_size, full,
                                  args.seed)
    streams = {}
    for on in (False, True):
        _, trace = shared_prefix_trace(np, Request, cfg.vocab_size, full,
                                       args.seed)
        eng = engine({"prefix_cache": on})
        done, wall = drive(eng, with_sampling(trace), True)
        sync()
        label = f"shared_prefix_sampled_cache_{'on' if on else 'off'}"
        res = served(eng, done, wall, launches(label))
        need(len(done) == 16 and all(len(r.out_tokens) == r.max_new_tokens
                                     for r in done),
             f"{label}: {len(done)} of 16 served in full")
        streams[on] = {r.rid: list(r.out_tokens) for r in done}
        out[label] = res
        log(f"slice[h] {label}: prefill_tokens {res['prefill_tokens']}, "
            f"TTFT mean {res['ttft_mean_s']:.3f} s (p50 "
            f"{res['ttft_p50_s']:.3f}), decode {res['tokens_per_s']:.1f} "
            "tokens/s")
        del eng
    need(streams[True] == streams[False],
         "slice (h): sampled cache-on and cache-off streams differ")
    need(any(len(set(s)) > 1 for s in streams[True].values()),
         "slice (h): the sampled streams are constant")
    on = out["shared_prefix_sampled_cache_on"]
    need(on["cached_prefix_tokens"] == 15 * plen,
         f"slice (h): {on['cached_prefix_tokens']} prefix tokens cached, "
         f"want {15 * plen}")
    out["greedy_shared_prefix"] = greedy_f
    log("slice[h] shared prefix sampled: cache-on and cache-off streams "
        f"identical; {15 * plen} prefix tokens cached"
        + (f"; greedy (slice f) {greedy_f['off']:.1f} / "
           f"{greedy_f['on']:.1f} tokens/s off / on" if greedy_f else ""))

    # 3. telemetry on and off, (b)'s 8 requests sampled
    lo, hi = (8, 100) if rehearse else (64, 1024)

    def b_requests():
        return with_sampling(make_requests(np, Request, cfg.vocab_size, 8,
                                           lo, hi, 32, args.seed))
    tel_runs, timeline = {}, None
    for on in (True, False):
        eng = engine({"telemetry": on})
        done, wall, tl = timed_drive(eng, b_requests(), sync)
        label = f"telemetry_{'on' if on else 'off'}"
        counts = launches(label)
        need(len(done) == 8, f"{label}: {len(done)} of 8 served")
        run = {"tokens_per_s": eng.stats["decode_tokens"] / wall,
               "wall_s": wall, "ticks": eng.stats["ticks"],
               "streams": {r.rid: list(r.out_tokens) for r in done},
               "launches": counts}
        if on:
            text = eng.prometheus_text()
            schema = eng.registry.schema()
            need(len(schema) == 30 and all(
                f"# TYPE {name} {s['kind']}" in text
                for name, s in schema.items()),
                f"{label}: the Prometheus text lacks a golden family")
            snap = eng.registry.snapshot()
            need(snap["serve_decode_tokens_total"]
                 == eng.stats["decode_tokens"]
                 and snap["serve_prefill_tokens_total"] == {
                     "kind=computed": eng.stats["prefill_tokens"],
                     "kind=cached": eng.stats["cached_prefix_tokens"]},
                 f"{label}: registry counters differ from stats")
            path = ROOT / "build" / "slice_h_trace.jsonl"
            path.parent.mkdir(parents=True, exist_ok=True)
            nlines = eng.export_trace(path)
            evs = [json.loads(x) for x in path.read_text().splitlines()]
            bad = [e for e in evs if trace_lib.validate_event(e)]
            spans = {r.rid: [e["event"] for e in evs if e["rid"] == r.rid]
                     for r in done}
            need(not bad and all(k and k[0] == "submit" and k[-1] == "finish"
                                 for k in spans.values()),
                 f"{label}: trace invalid ({bad[:2]}) or a span is not "
                 "submit -> finish")
            run.update(trace_lines=nlines, phases=phase_quantiles(eng))
            timeline = tl
        tel_runs[label] = run
        del eng
    runs = list(tel_runs.values())
    need(all(r["streams"] == runs[0]["streams"] for r in runs),
         "slice (h): telemetry on and off give different streams")
    clean = runs[0]["streams"]
    out["telemetry"] = {k: {kk: vv for kk, vv in v.items() if kk != "streams"}
                        for k, v in tel_runs.items()}
    out["telemetry"]["greedy_b_tokens_per_s"] = greedy_b
    ph = runs[0]["phases"]
    log("slice[h] telemetry: streams identical on / off; tokens/s "
        + " / ".join(f"{r['tokens_per_s']:.1f}" for r in runs)
        + f"; {len(schema)} families; phases p50/p99 ms: "
        + ", ".join(f"{k} {v['p50_s'] * 1e3:.3f}/{v['p99_s'] * 1e3:.3f}"
                    for k, v in ph.items() if v["p50_s"] is not None))

    # 4. one FaultPlan at full width: nan_logits, chunk_error, a deadline
    # that lands inside a 1 s slow step, which trips the armed watchdog
    reqs = b_requests()
    plens = {r.rid: len(r.prompt) for r in reqs}
    chunk_rid = min(plens, key=plens.get)      # the fewest chunks to skip
    nan_rid = max((r for r in plens if r != chunk_rid), key=plens.get)
    pick = None
    for ticks, t, ntok in timeline:
        if ticks < 20:
            continue
        for rid, n in sorted(ntok.items(), key=lambda kv: kv[1]):
            if (rid not in (chunk_rid, nan_rid) and 3 <= n <= 32 - 12
                    and timeline[-1][0] - ticks >= 12):
                pick = (ticks, t, rid)
                break
        if pick:
            break
    need(pick is not None, "slice (h): no request is mid-decode after "
         "tick 20 in the clean run")
    slow_tick, t_slow, dl_rid = pick
    slow_tick -= 1                        # the tick the step enqueued
    plan = faults_lib.FaultPlan()
    plan.arm("nan_logits", rid=nan_rid, nth=4)
    plan.arm("chunk_error", rid=chunk_rid)
    plan.arm("slow_step", tick=slow_tick, delay_s=1.0)
    deadline_ms = (t_slow + 0.5) * 1e3
    for r in reqs:
        if r.rid == dl_rid:
            r.deadline_ms = deadline_ms
    eng = engine({"faults": plan})
    done, wall, _ = timed_drive(eng, reqs, sync)
    counts = launches("faults")
    reasons = {rs.rid: rs.finish_reason for rs in eng.scheduler.finished}
    got = {r.rid: list(r.out_tokens) for r in done}
    want = {nan_rid: "numeric_error", chunk_rid: "internal_error",
            dl_rid: "deadline"}
    need(all(reasons[r] == w for r, w in want.items()),
         f"faults: reasons {reasons}, want {want}")
    need(0 < len(got[dl_rid]) < 32 and got[dl_rid]
         == clean[dl_rid][:len(got[dl_rid])],
         f"faults: the deadline did not cut rid {dl_rid} mid-decode "
         f"({len(got[dl_rid])} tokens)")
    need(got[nan_rid] == clean[nan_rid][:4],
         f"faults: rid {nan_rid} kept {len(got[nan_rid])} tokens, want 4")
    others = [r for r in got if r not in want]
    need(all(got[r] == clean[r] for r in others),
         "faults: a stream without a fault differs from the clean run")
    health = [(e["state"], e["reason"]) for e in eng.trace.events()
              if e["event"] == "health"]
    need(health[:2] == [("degraded", "watchdog"),
                        ("healthy", "watchdog_recovered")],
         f"faults: health trace {health}")
    audit = eng.audit()
    need(audit["leaked_after"] == 0, f"faults: audit {audit}")
    need(eng.allocator.free_blocks == eng.allocator.num_blocks - 1,
         f"faults: {eng.allocator.free_blocks} of "
         f"{eng.allocator.num_blocks - 1} blocks free")
    out["faults"] = {"reasons": reasons, "targets": want,
                     "slow_tick": slow_tick, "deadline_ms": deadline_ms,
                     "deadline_tokens": len(got[dl_rid]), "health": health,
                     "audit": {k: v for k, v in audit.items()
                               if k != "mismatches"},
                     "faults_injected": eng.metrics()["faults_injected"],
                     "wall_s": wall, "launches": counts}
    log(f"slice[h] faults: rid {nan_rid} numeric_error, rid {chunk_rid} "
        f"internal_error, rid {dl_rid} deadline after "
        f"{len(got[dl_rid])} tokens; {len(others)} other streams as the "
        f"clean run; health {health}; audit leaked_after 0; every block "
        "free")
    del eng

    # 5. real NaN in a decoding slot's first block
    def poisoned(c, kw, label):
        two = make_requests(np, Request, cfg.vocab_size, 2, lo, hi, 32,
                            args.seed)
        eng = engine(kw, c)
        ref, _, _ = timed_drive(eng, two, sync)
        ref_streams = {r.rid: list(r.out_tokens) for r in ref}
        del eng
        two = make_requests(np, Request, cfg.vocab_size, 2, lo, hi, 32,
                            args.seed)
        eng = engine(kw, c)
        for r in two:
            eng.submit(r)
        while not all(len(r.out_tokens) >= 2 for r in two):
            eng.step()
            eng.poll()
        eng.drain()
        victim = next(rs for rs in eng.slot_req if rs is not None)
        other = next(r for r in two if r.rid != victim.rid)
        blocks = list(victim.blocks)
        for group in eng.caches:
            for pool in group:
                pool.k[:, blocks[0]] = float("nan")
                pool.v[:, blocks[0]] = float("nan")
        res = {"victim": victim.rid, "blocks": len(blocks),
               "scrubbed_zero": None}
        fresh = None
        steps = 0
        while (eng.scheduler.waiting
               or any(r is not None for r in eng.slot_req)):
            eng.step()
            eng.poll()
            steps += 1
            need(steps < 100_000, f"{label}: the engine did not finish")
            if victim.finish_reason and fresh is None:
                # the victim's private blocks, scrubbed at its quarantine,
                # top the free list: a fresh request of its size reuses them
                sync()
                if victim.finish_reason == "numeric_error":
                    res["scrubbed_zero"] = all(
                        not bool(pool.k[:, b].any())
                        and not bool(pool.v[:, b].any())
                        for group in eng.caches for pool in group
                        for b in blocks)
                fresh = Request(rid=99, prompt=np.random.default_rng(
                    args.seed).integers(2, cfg.vocab_size, size=len(
                        blocks) * base["page_size"] - 8), max_new_tokens=8)
                eng.submit(fresh)
        eng.poll()
        fin = {rs.rid: rs for rs in eng.scheduler.finished}
        fr = fin.get(99)
        res.update(
            victim_reason=fin[victim.rid].finish_reason,
            victim_tokens=len(victim.out_tokens),
            other_identical=list(other.out_tokens)
            == ref_streams[other.rid],
            fresh_reason=fr.finish_reason if fr else None,
            fresh_tokens=len(fresh.out_tokens) if fresh else 0,
            fresh_reused_blocks=(len(set(int(b) for b in fr.table_row)
                                     & set(blocks)) if fr else 0),
            all_free=eng.allocator.free_blocks
            == eng.allocator.num_blocks - 1,
            audit_leaked=eng.audit()["leaked_after"])
        del eng
        return res

    nan_float = poisoned(cfg, {"attn_grau": None}, "nan_float")
    launches("nan_float", need_epilogue=False)
    need(nan_float["victim_reason"] == "numeric_error"
         and nan_float["other_identical"]
         and nan_float["scrubbed_zero"] is True
         and nan_float["fresh_reason"] == "max_tokens"
         and nan_float["fresh_reused_blocks"] > 0
         and nan_float["all_free"] and nan_float["audit_leaked"] == 0,
         f"real NaN (float setup): {nan_float}")
    out["nan_float"] = nan_float
    out["nan_grau"] = poisoned(gcfg, {}, "nan_grau")
    launches("nan_grau")
    log(f"slice[h] real NaN, float: {nan_float}")
    log(f"slice[h] real NaN under the GRAU epilogue (not gated): "
        f"{out['nan_grau']}")
    return out


def iter_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from iter_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from iter_tensors(v)
    else:
        yield tree


def paper_flow(torch, np, dev, args, rehearse):
    """Slice (d): the quickstart's steps, then Table III for SFC and CNV
    with SiLU through the GRAU unit kernel, then the kernel path against the
    plain unit on the same trained parameters. Returns the report."""
    from repro_torch import kernels
    from repro_torch.kernels import grau as gk
    from repro_torch.kernels import ops
    from repro_torch.launch import quickstart
    from repro_torch.models.vision import apply_vision, make_grau_acts
    from repro_torch.tables import table3_small_models as t3

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    qs = quickstart.run(dev, seed=args.seed, verbose=False)
    sync()
    qs["launches"] = kernels.launch_counts()
    qs["seconds"] = time.perf_counter() - t0
    need(rehearse or qs["launches"]["matmul_grau"] >= 1,
         f"quickstart: matmul_grau did not launch: {qs['launches']}")
    out["quickstart"] = qs
    log(f"paper[quickstart]: {json.dumps(qs)}")

    # Table III at the paper-table settings (a short rehearsal on the CPU)
    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = t3.run(device=dev, settings=[("sfc", "silu"), ("cnv", "silu")],
                  steps=20 if rehearse else None)
    sync()
    launches = kernels.launch_counts()
    # every pot/apot evaluation sends each activation layer's batch through
    # the unit once
    int_calls = sum(2 * t3.EVAL_STEPS * r["layers"] for r in rows)
    need(rehearse or launches["grau"] == int_calls,
         f"table3: grau launched {launches['grau']} times, want the "
         f"{int_calls} integer activation calls of the pot/apot rows")
    out["table3"] = {"seconds": time.perf_counter() - t0,
                     "launches": launches, "int_act_calls": int_calls,
                     "rows": [{k: v for k, v in r.items() if k != "state"}
                              for r in rows]}
    log(f"paper[table3]: {json.dumps(out['table3'])}")

    # the kernel path against the plain unit, on the same card tensors
    def recording(unit, seen):
        def call(a, spec):
            y = unit(a, spec)
            seen.append(y)
            return y
        return call

    def plain_unit(a, spec):
        return gk.grau_plain(a, spec.packed(a.device),
                             num_exponents=spec.num_exponents,
                             qmin=spec.qmin,
                             qmax=spec.qmax).to(gk.out_dtype(spec.qmin))

    compared = 0
    same_logits = True
    for r in rows:
        cfg, params, pipe, ranges = r["state"]
        for mode in ("pot", "apot"):
            seen_k, seen_p = [], []
            ik = make_grau_acts(cfg, ranges, mode=mode, unit=recording(
                ops.grau, seen_k), **t3.GRAU_KW)
            ip = make_grau_acts(cfg, ranges, mode=mode, unit=recording(
                plain_unit, seen_p), **t3.GRAU_KW)
            with torch.no_grad():
                for step in range(t3.EVAL_STEPS):
                    img = pipe.batch(10_000 + step)["image"]
                    lk = apply_vision(params, cfg, img, act_impls=ik)
                    lp = apply_vision(params, cfg, img, act_impls=ip)
                    need(torch.equal(lk.argmax(-1), lp.argmax(-1)),
                         f"table3 {r['model']}-{r['act']} {mode}: kernel "
                         "and plain predictions differ")
                    same_logits &= bool(torch.equal(lk, lp))
            need(len(seen_k) == len(seen_p) == t3.EVAL_STEPS * r["layers"]
                 and all(a.dtype == b.dtype and torch.equal(a, b)
                         for a, b in zip(seen_k, seen_p)),
                 f"table3 {r['model']}-{r['act']} {mode}: GRAU kernel "
                 "outputs differ from the plain unit's")
            compared += len(seen_k)
    out["kernel_vs_plain"] = {"grau_outputs_compared": compared,
                              "bit_exact": True, "same_logits": same_logits}
    log(f"paper[kernel vs plain]: {json.dumps(out['kernel_vs_plain'])}")
    return out


def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def grau_flips(torch, cfg, params, batch, dev, chunk):
    """GRAU activation outputs that differ between a forward through the
    flash kernel and one through the plain scan (no grad, no remat): the
    first pass records each layer's activation, the second compares."""
    from repro_torch.models import lm
    act = lm.make_act(cfg, dev)
    seen, counts = [], {"flips": 0, "elements": 0}

    def record(z):
        y = act(z)
        seen.append(y)
        return y

    def compare(z):
        y = act(z)
        ref = seen.pop(0)
        counts["flips"] += int((y != ref).sum())
        counts["elements"] += y.numel()
        return y
    with torch.no_grad():
        for impl, a in (("kernel", record), ("plain", compare)):
            lm.apply_lm(params, cfg, batch["tokens"], act=a, q_chunk=chunk,
                        kv_chunk=chunk, attn_impl=impl)
    return counts


def train_slice(torch, np, dev, args, rehearse):
    """Slice (e): GRAU-QAT training of full-width llama3.2-3b (bf16 weights
    from --seed, f32 AdamW moments, GRAU apot 6 x 8, sequence 4096 x batch 1,
    remat "full"), through launch/steps.make_train_step and train/loop.run.
    1. before the optimizer state exists: loss and gradients on batch 0
       through the flash kernel and through the plain scan, held together,
       and the GRAU activation flips between the two forwards;
    2. 8 steps, launches of the flash kernel counted;
    3. checkpoint and resume on the card at llama3-smoke size."""
    from repro_torch import kernels
    from repro_torch.configs.archs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.config import GRAUConfig
    from repro_torch.nn.common import tree_flatten
    from repro_torch.train import optim
    from repro_torch.train.loop import LoopConfig, run

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    grau = GRAUConfig(mode="apot", segments=6, num_exponents=8)
    cfg = get_config("llama3.2-3b", smoke=rehearse).replace(grau=grau)
    dtype = torch.float32 if rehearse else torch.bfloat16
    seq, batch_size = (64, 2) if rehearse else (4096, 1)
    chunk = min(1024, seq)
    out = {"config": cfg.name, "layers": cfg.num_layers, "seq": seq,
           "batch": batch_size, "dtype": str(dtype)}
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=args.seed, dtype=dtype, device=dev)
    pipe = TokenPipeline(cfg.vocab_size, seq, batch_size, seed=args.seed,
                         device=str(dev))
    sync()
    out["init_s"] = time.perf_counter() - t0

    # 1. kernel vs plain scan on batch 0, before the moments exist
    t0 = time.perf_counter()
    batch0 = pipe.batch(0)
    res = {}
    for impl in ("kernel", "plain"):
        fn = steps.make_loss_and_grads(cfg, remat="full", q_chunk=chunk,
                                       kv_chunk=chunk, attn_impl=impl)
        res[impl] = fn(params, batch0)
        sync()
    (lk, gk), (lp, gp) = res["kernel"], res["plain"]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    grad_rel = {path: rel_l2(a, b) for (path, a), (_, b)
                in zip(tree_flatten(gk), tree_flatten(gp))}
    del res, gk, gp
    worst_path = max(grad_rel, key=grad_rel.get)
    flips = grau_flips(torch, cfg, params, batch0, dev, chunk)
    out["kernel_vs_plain"] = {
        "loss_kernel": float(lk), "loss_plain": float(lp),
        "loss_rel": loss_rel, "grad_rel_l2_max": grad_rel[worst_path],
        "grad_rel_l2_max_leaf": worst_path,
        "grad_rel_l2_median": float(np.median(list(grad_rel.values()))),
        "grau_flips": flips["flips"], "grau_elements": flips["elements"],
        "seconds": time.perf_counter() - t0}
    log(f"train[kernel vs plain]: {json.dumps(out['kernel_vs_plain'])}")
    need(np.isfinite(float(lk)) and loss_rel <= TRAIN_LOSS_TOL,
         f"train: loss through the kernel {float(lk)} vs plain {float(lp)}: "
         f"rel {loss_rel:.3g} > {TRAIN_LOSS_TOL}")
    need(grad_rel[worst_path] <= TRAIN_GRAD_TOL,
         f"train: gradient {worst_path} rel L2 {grad_rel[worst_path]:.3g} > "
         f"{TRAIN_GRAD_TOL}")
    if cuda:
        torch.cuda.empty_cache()

    # 2. eight steps through the loop
    steps_n = 8
    opt_cfg = optim.AdamWConfig(peak_lr=3e-3, warmup_steps=5,
                                total_steps=steps_n)
    train_step = steps.make_train_step(cfg, opt_cfg, remat="full",
                                       q_chunk=chunk, kv_chunk=chunk)
    opt_state = optim.init_opt_state(params)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    try:
        params, opt_state, hist = run(
            train_step=train_step, params=params, opt_state=opt_state,
            batch_fn=pipe.batch, loop=LoopConfig(total_steps=steps_n,
                                                 log_every=1),
            log=lambda m: log(f"train: {m}"))
    except FloatingPointError as e:
        raise SmokeError(f"train: {e}") from e
    sync()
    launches = kernels.launch_counts()
    want = 2 * cfg.num_layers * steps_n
    need(rehearse or launches["flash_attention"] == want,
         f"train: flash_attention launched {launches['flash_attention']} "
         f"times, want {want} (forward + remat recompute, {cfg.num_layers} "
         f"layers x {steps_n} steps)")
    step_s = float(np.median(hist["times"]))
    tokens = seq * batch_size
    out["train"] = {
        "losses": hist["losses"], "step_s": hist["times"],
        "median_step_s": step_s, "tokens_per_s": tokens / step_s,
        "model_flops_per_step": train_flops(cfg, batch_size, seq),
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if cuda else None),
        "flash_launches": launches["flash_attention"],
        "flash_launches_want": want}
    out["train"]["flops_share_of_989e12"] = (
        out["train"]["model_flops_per_step"] / step_s / PEAK_OPS["bf16"])
    out["train"]["card"] = args.card
    log(f"train[8 steps]: {json.dumps(out['train'])}")
    if args.profile:
        out["profile"] = profile_train(torch, dev, train_step, params,
                                       opt_state, pipe.batch,
                                       f"{args.profile}.train.txt")
    del params, opt_state, train_step
    if cuda:
        torch.cuda.empty_cache()

    # 3. checkpoint and resume at llama3-smoke size
    out["resume"] = resume_check(torch, dev, args, grau, sync)
    log(f"train[resume]: {json.dumps(out['resume'])}")
    return out


def train_flops(cfg, batch, seq):
    """Model FLOPs of one training step (no remat recompute): 6 per
    parameter and token for the projections, MLP and tied head, and the
    causal attention's 4 b h s^2 d / 2 forward times 3 (forward and the
    two-product backward)."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
                 + 3 * d * cfg.d_ff)
    matmul = 6 * batch * seq * (cfg.num_layers * per_layer
                                + d * cfg.vocab_size)
    attn = 3 * cfg.num_layers * 4 * batch * cfg.num_heads * seq * seq * hd / 2
    return matmul + attn


def resume_check(torch, dev, args, grau, sync):
    """llama3-smoke with GRAU in f32 on the card: 6 steps uninterrupted;
    then 3 steps committing a checkpoint at step 3, and a fresh run from the
    same directory that must resume at 3. Every tensor restored from the
    checkpoint equals the saved one byte for byte; the resumed losses agree
    with the uninterrupted run's within RESUME_TOL (relative: the embedding
    backward sums with atomics on the card), and the uninterrupted loss
    falls by RESUME_FALL: the update on the card trains."""
    import tempfile

    from repro_torch.ckpt import checkpoint as ckpt_lib
    from repro_torch.configs.archs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.nn.common import tree_flatten
    from repro_torch.train import optim
    from repro_torch.train.loop import LoopConfig, run

    cfg = get_config("llama3.2-3b", smoke=True).replace(grau=grau)
    pipe = TokenPipeline(cfg.vocab_size, 64, 4, seed=args.seed,
                         device=str(dev))
    opt_cfg = optim.AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=6)

    def fresh(total, ckpt_dir=None):
        params = lm.init_lm(cfg, seed=args.seed, dtype=torch.float32,
                            device=dev)
        step = steps.make_train_step(cfg, opt_cfg, remat="full", q_chunk=32,
                                     kv_chunk=32)
        return run(train_step=step, params=params,
                   opt_state=optim.init_opt_state(params),
                   batch_fn=pipe.batch,
                   loop=LoopConfig(total_steps=total, ckpt_every=3,
                                   ckpt_dir=ckpt_dir, log_every=100),
                   log=lambda m: log(f"train[resume]: {m}"))

    t0 = time.perf_counter()
    _, _, full = fresh(6)
    with tempfile.TemporaryDirectory() as d:
        p3, o3, first = fresh(3, d)
        sync()
        restored = ckpt_lib.restore(d, 3, {"params": p3, "opt": o3})
        saved = tree_flatten({"params": p3, "opt": o3})
        same = all(a.device == b.device and a.dtype == b.dtype
                   and torch.equal(a, b) for (_, a), (_, b)
                   in zip(saved, tree_flatten(restored)))
        _, _, resumed = fresh(6, d)
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"],
                                                   full["losses"][3:]))
    out = {"uninterrupted_losses": full["losses"],
           "first_losses": first["losses"], "resumed_start": resumed["start"],
           "resumed_losses": resumed["losses"], "restored_identical": same,
           "tensors": len(saved), "max_rel_diff": rel,
           "seconds": time.perf_counter() - t0}
    need(resumed["start"] == 3 and len(resumed["losses"]) == 3,
         f"resume: started at {resumed['start']}, want 3")
    need(same, "resume: a restored tensor differs from the saved one")
    need(rel <= RESUME_TOL, f"resume: losses off by {rel:.3g} relative > "
         f"{RESUME_TOL}")
    need(full["losses"][-1] < full["losses"][0] - RESUME_FALL,
         f"resume: the loss did not fall by {RESUME_FALL} in 6 steps: "
         f"{full['losses']}")
    return out


def check_logits(torch, label, res, lk, lg):
    rel = float((lk - lg).norm() / lg.norm())
    res["first_step_logits_rel_l2"] = rel
    res["first_step_logits_max_abs"] = float((lk - lg).abs().max())
    need(torch.isfinite(lk).all(), f"{label}: non-finite logits")
    need(rel <= SLICE_TOL[label],
         f"{label}: first decode logits kernel vs gather rel L2 {rel:.3g}"
         f" > {SLICE_TOL[label]}")
    log(f"slice[{label}]: " + json.dumps(res))
    return res


def profile_serve(torch, dev, cfg, params, ecfg, reqs_fn, path, label,
                  skip=8, window=24):
    """Where the time goes: one more served run, with `window` engine steps
    after the first `skip` (prefill chunks and decode ticks interleaved)
    under torch.profiler; writes the per-kernel device-time table of the
    window to `path` and returns its device-busy share and top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import EngineConfig, ServeEngine
    eng = ServeEngine(cfg, params, EngineConfig(**ecfg), device=dev)
    eng.warmup()
    for r in reqs_fn():
        eng.submit(r)

    def busy():
        return eng.scheduler.waiting or any(r is not None
                                            for r in eng.slot_req)

    def steps(n):
        for _ in range(n):
            if not busy():
                return
            eng.step()
            eng.poll()

    steps(skip)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ticks0, chunks0 = eng.stats["ticks"], eng.stats["chunks"]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps(window)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ticks, chunks = (eng.stats["ticks"] - ticks0,
                     eng.stats["chunks"] - chunks0)
    while busy():
        steps(1)
    busy_s, top = kernel_table(prof, path)
    out = {"window_steps": window, "decode_ticks": ticks,
           "prefill_chunks": chunks, "wall_s": wall,
           "device_busy_s": busy_s, "device_busy_share": busy_s / wall,
           "top": top}
    log(f"profile[{label}]: " + json.dumps(out))
    return out


def kernel_table(prof, path, top=10):
    """Device time by kernel over a profiled window, written to `path`
    (host ops are skipped: their kernels are listed); returns the busy
    seconds and the `top` kernels."""
    from torch.autograd import DeviceType
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = (getattr(evt, "self_device_time_total", None)
                  or getattr(evt, "self_cuda_time_total", 0) or 0)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(
        f"{us / 1e3:12.3f} ms  {n:8d}x  {key}" for us, key, n in rows))
    return (sum(r[0] for r in rows) / 1e6,
            [{"kernel": key[:80], "ms": us / 1e3, "calls": n}
             for us, key, n in rows[:top]])


def profile_train(torch, dev, train_step, params, opt_state, batch_fn,
                  path, steps_n=2):
    """Where a training step's time goes: `steps_n` more steps under
    torch.profiler (device time by kernel to `path`)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps_n):
            params, opt_state, m = train_step(params, opt_state,
                                              batch_fn(100 + i))
        float(m["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_s, top = kernel_table(prof, path, top=15)
    out = {"steps": steps_n, "wall_s": wall, "device_busy_s": busy_s,
           "device_busy_share": busy_s / wall, "top": top}
    log("profile[train]: " + json.dumps(out))
    return out


def time_kernels_from(torch, np, dev, args):
    """--kernels-from: the graph-replay times of the matmul_wq, decode,
    prefill, flash, matmul_grau and GRAU-unit rows at the main paths'
    shapes, for the port on sys.path; one JSON line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    s = dict(slots=8, h=24, kvh=8, d=128, bs=16, max_len=2048, chunk=32,
             mlp={"w_gate": (3072, 8192), "w_down": (8192, 3072)})
    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul_wq as mm
    rows = []
    for wname in s["mlp"]:
        for bits in (4, 8):
            for M in (8, 32):
                x, ws = matmul_wq_case(torch, dev, s, wname, M, bits)
                rows.append({"name": "matmul_wq", "weight": wname,
                             "bits": bits, "M": M, "ms": graph_ms(
                                 torch, cycling([(lambda w=w: mm.matmul_wq(
                                     x, w)) for w in ws]))})
    for name in ("paged_attention", "paged_prefill"):
        for kv_bits in (16, 8, 4):
            kerns, _, _, _, _ = paged_timing_case(torch, np, dev, name, s, 3,
                                                  rng, kv_bits)
            rows.append({"name": name, "kv_bits": kv_bits,
                         "ms": graph_ms(torch, cycling(kerns)),
                         "pool_copies": len(kerns)})
            del kerns
    # decode in the smaller buckets most served ticks run
    for width in DECODE_BUCKETS_TIMED:
        kerns, _, nbytes, flops, _ = paged_timing_case(
            torch, np, dev, "paged_attention", s, 3, rng, 16, bucket=width)
        rows.append({"name": "paged_attention", "kv_bits": 16,
                     "bucket": width, "ms": graph_ms(torch, cycling(kerns)),
                     "bound_ms": bound(nbytes, flops, "bf16")[0],
                     "pool_copies": len(kerns)})
        del kerns
    b, sq, h, kvh, d = 1, 4096, 24, 8, 128
    q = torch.randn((b, sq, h, d), device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, sq, kvh, d), device=dev).to(torch.bfloat16)
            for _ in range(2))
    rows.append({"name": "flash_attention", "shape": [b, sq, h, kvh, d],
                 "ms": graph_ms(torch, lambda: fa.flash_attention(q, k, v),
                                calls=10, replays=5)})
    # matmul_grau at the quickstart's and the MLP's shapes over weight
    # copies past L2; the GRAU unit at slice (d)'s shapes and 2048 x 8192
    spec = quickstart_unit()
    regs = spec.packed(dev)
    kw = dict(num_exponents=spec.num_exponents, qmin=spec.qmin,
              qmax=spec.qmax)
    from repro_torch.kernels import grau as gk
    from repro_torch.kernels import matmul_grau as mg
    for M, K, N in MM_GRAU_TIMED:
        x, ws = matmul_grau_case(torch, dev, M, K, N)
        rows.append({"name": "matmul_grau", "M": M, "K": K, "N": N,
                     "ms": graph_ms(torch, cycling([
                         (lambda w=w: mg.matmul_grau(x, w, regs, **kw))
                         for w in ws]))})
        del ws
    for r, c in GRAU_TIMED:
        xs = grau_timing_case(torch, np, dev, r, c, rng)
        rows.append({"name": "grau", "shape": [r, c], "copies": len(xs),
                     "ms": graph_ms(torch, cycling([
                         (lambda x=x: gk.grau_unit(x, regs, **kw))
                         for x in xs]))})
        del xs
    report = {"kernels_from": str(args.kernels_from), "card": card,
              "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    log(json.dumps(report))
    return 0


def ptxas_summary(log_text):
    """(kernel, registers, spill bytes) of each entry function in an nvcc
    -Xptxas=-v log, the kernel named by its base name and template
    integers (e.g. flash_wgmma_kernel<128>)."""
    import re
    out, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d+([a-z_0-9]+kernel)", mangled)
            ints = re.findall(r"Li(\d+)E", mangled)
            name = ((base.group(1) if base else mangled)
                    + (f"<{','.join(ints)}>" if ints else ""))
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="also profile one served run per configuration "
                         "and two training steps; per-kernel device times "
                         "go to PATH.<config>.txt")
    ap.add_argument("--rehearse", action="store_true",
                    help="smoke-size control-flow run on the CPU; exits 1")
    ap.add_argument("--kernels-from", default=None, metavar="DIR",
                    help="time only the kernel rows (graph replay) of the "
                         "port in DIR/src and print them as JSON")
    args = ap.parse_args(argv)
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this check "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    src = Path(args.kernels_from or ROOT) / "src"
    sys.path.insert(0, str(src))
    try:
        from repro_torch.kernels import build as kbuild
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e}); run from a checkout "
              "of the repository", file=sys.stderr)
        return 2

    dev = torch.device("cpu" if args.rehearse else "cuda")
    timed = not args.rehearse
    if args.kernels_from:
        return time_kernels_from(torch, np, dev, args)
    report = {}
    args.card = "cpu rehearsal"
    if timed:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
        log(card)
        report["card"] = args.card = card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        took = kbuild.build()
        report["build_s"] = time.perf_counter() - t0
        report["phase_s"] = {"build": report["build_s"]}
        log(f"kernel build: {report['build_s']:.1f} s "
            f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
        report["ptxas"] = {}
        for name in kbuild.SOURCES:
            rows = ptxas_summary(kbuild.ptxas_report(name))
            report["ptxas"][name] = rows
            for kern, regs, spill in rows:
                log(f"  ptxas[{name}]: {kern}: {regs} registers, {spill} "
                    "bytes of spill stores")

    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    # the main path's shapes: llama3.2-3b (d_model 3072, d_ff 8192, 24/8
    # heads of 128) at 8 slots, 32-token prefill chunks; its MLP products
    # at 8 (decode) and 32 (prefill) rows
    shapes = (dict(slots=8, h=24, kvh=8, d=128, bs=16, max_len=2048,
                   chunk=32, grau=(32 * 24, 128),
                   mlp={"w_gate": (3072, 8192), "w_down": (8192, 3072)},
                   rows=(8, 32)) if timed else
              dict(slots=8, h=4, kvh=2, d=32, bs=16, max_len=128, chunk=32,
                   grau=(32 * 4, 32),
                   mlp={"w_gate": (128, 256), "w_down": (256, 128)},
                   rows=(8, 32)))
    # matmul_grau: the quickstart's product, the kernel bench's, ragged M,
    # N and K (K = 200, 260: not multiples of 32), the batched case, and the
    # llama3.2-3b MLP products at 32 and 2048 rows
    mm_small = [((128, 256), (256, 128)), ((1, 200), (200, 128)),
                ((33, 260), (260, 96)), ((2, 17, 128), (128, 96))]
    mlp_mkn = ([(m, k, n) for m in (32, 2048)
                for k, n in ((3072, 8192), (8192, 3072))] if timed else
               [(m, k, n) for m in (32, 64) for k, n in ((128, 256),
                                                         (256, 128))])
    shapes["mm_grau"] = (mm_small + ([((256, 512), (512, 256)),
                                      ((512, 1024), (1024, 512))]
                                     if timed else [])
                         + [((m, k), (k, n)) for m, k, n in mlp_mkn])
    shapes["mm_grau_timed"] = (MM_GRAU_TIMED if timed else
                               [(128, 256, 128)] + mlp_mkn)
    # flash attention: slice (e)'s (b, s, h, kvh, d)
    shapes["flash"] = (1, 4096, 24, 8, 128) if timed else (1, 128, 4, 2, 32)
    phase_s = report.setdefault("phase_s", {})

    def phase(name, fn):
        t0 = time.perf_counter()
        res = fn()
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return res

    try:
        grau_row = phase("grau", lambda: check_grau(torch, np, dev, shapes,
                                                    rng, timed))
        rows = phase("paged_attention", lambda: check_paged(
            torch, np, dev, shapes, rng, timed))
        groups = phase("paged_groups", lambda: check_paged_groups(
            torch, np, dev, shapes, rng, timed))
        rows["matmul_wq"] = phase("matmul_wq", lambda: check_matmul_wq(
            torch, np, dev, shapes, rng, timed))
        rows["matmul_grau"] = phase("matmul_grau", lambda: check_matmul_grau(
            torch, np, dev, shapes, rng, timed))
        rows["flash_attention"] = phase("flash_attention", lambda: check_flash(
            torch, np, dev, shapes, rng, timed))
        slice_res = phase("slices_abc", lambda: slice_phase(
            torch, np, dev, args, args.rehearse))
        paper = phase("slice_d", lambda: paper_flow(torch, np, dev, args,
                                                     args.rehearse))
        train = phase("slice_e", lambda: train_slice(torch, np, dev, args,
                                                      args.rehearse))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        prefix = phase("slice_f", lambda: prefix_slice(torch, np, dev, args,
                                                       args.rehearse))
        archs = phase("slice_g", lambda: new_archs_slice(
            torch, np, dev, args, args.rehearse))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        greedy_f = {k: prefix[f"shared_prefix_cache_{k}"]["tokens_per_s"]
                    for k in ("off", "on")}
        greedy_b = {k: slice_res["grau"][k] for k in (
            "tokens_per_s", "ttft_mean_s", "ttft_p50_s")}
        sampled = phase("slice_h", lambda: sampled_slice(
            torch, np, dev, args, args.rehearse, greedy_f, greedy_b))
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    report["slice"] = slice_res
    report["paper_flow"] = paper
    report["train"] = train
    report["paged_groups"] = groups
    report["prefix_cache"] = prefix
    report["new_archs"] = archs
    report["sampled"] = sampled
    # launches on the main paths: the 16-bit attention rows from (b), where
    # the GRAU datapath runs fused in the attention kernels' epilogue; the
    # 4-bit attention rows and matmul_wq from (c); the GRAU unit and
    # matmul_grau from (d) (the quickstart, and Table III's integer
    # activations); flash_attention from (e)'s eight training steps
    lb = slice_res["grau"]["launches"]
    lc = slice_res["wq4_kv4_grau"]["launches"]
    lq = paper["quickstart"]["launches"]
    lt = paper["table3"]["launches"]
    grau_row.update(launches=lq["grau"] + lt["grau"],
                    launches_quickstart=lq["grau"],
                    launches_table3=lt["grau"])
    rows["matmul_grau"]["launches"] = lq["matmul_grau"] + lt["matmul_grau"]
    for name in ("paged_attention", "paged_prefill"):
        rows[name].update(launches=lb[name],
                          epilogue_launches=lb[f"{name}_epilogue"])
        rows[f"{name}_kv4"].update(launches=lc[f"{name}_kv4"],
                                   epilogue_launches=lc[f"{name}_epilogue"])
    rows["matmul_wq"].update(launches=lc["matmul_wq"],
                             epilogue_launches=lc["matmul_wq_epilogue"])
    rows["flash_attention"]["launches"] = train["train"]["flash_launches"]
    # the attention kernels' launches on slices (f) and (g), each run's
    # counts zeroed just before it and read just after
    runs_f = [prefix[k]["launches"] for k in (
        "shared_prefix_cache_off", "shared_prefix_cache_on", "cancel",
        "overload")]
    for name in ("paged_attention", "paged_prefill"):
        rows[name]["launches_slice_f"] = sum(c[name] for c in runs_f)
        rows[name]["launches_slice_g"] = {
            k: archs[k]["launches"][name] for k in ("glm4_grau", "qwen_grau")}
        # slice (h): every served run, each counted from 0 just before it
        rows[name]["launches_slice_h"] = sum(
            c[name] for c in sampled["launches"].values())
    kernel_rows = [grau_row] + [rows[n] for n in (
        "paged_attention", "paged_prefill", "paged_attention_kv4",
        "paged_prefill_kv4", "matmul_wq", "matmul_grau", "flash_attention")]
    report["kernels"] = kernel_rows
    # the 8-bit pools are on no served path here: checked and timed, kept
    # in the report only
    report["kernels_kv8"] = [rows["paged_attention_kv8"],
                             rows["paged_prefill_kv8"]]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    if args.rehearse:
        log(json.dumps({"kernels": kernel_rows}))
        print("chip_smoke: rehearsal on the CPU passed; no device result",
              file=sys.stderr)
        return 1
    log(json.dumps({"kernels": kernel_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # skip interpreter teardown: after a profiled run, the profiler's CUPTI
    # shutdown has been seen to hang the exit of an otherwise finished run
    os._exit(code)
