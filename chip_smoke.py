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
     pools and matmul_wq (int4 / int8 weights, the llama3.2-3b MLP shapes at
     8 and 32 rows) within the stated tolerances, each with the fused GRAU
     epilogue bit-exact on the kernel's own f32 output — then timed with
     CUDA events beside its plain version, a PyTorch library call for the
     same function where one exists, and the card's bound;
     matmul_grau (the int8 matmul with the GRAU epilogue) bit for bit at the
     quickstart's, the kernel bench's, ragged and the llama3.2-3b MLP
     shapes, on signed, unsigned and random register files;
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
     Launch counters are zeroed before and read after each run.
Each phase prints its seconds. The last two lines are the kernels JSON and
the result line.

Without a CUDA card, or outside a checkout of the repository, it prints why
on stderr and exits 2. `--rehearse` runs the same phases at smoke size on
the CPU (plain versions, no timings) to check the control flow, and exits 1.
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
    # the data sheet has no int32 entry: 64 INT32 lanes per SM are half the
    # 128 FP32 lanes behind its 67e12 float32 rate
    "int32": 33.5e12,
    "int8": 1979e12,              # tensor cores, dense (data sheet)
}
# Kernel vs plain, element by element: |got - want| <= atol + rtol * |want|.
F32_TOL = 2e-5      # f32: the same sums in another order (FMA contraction)
# bf16 output: both sides round an f32 result (held at F32_TOL) to bf16, so
# they may land one bf16 ulp (<= 2**-7 * |want|) apart, and no further
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-6
# relative L2, first decode logits, kernel path vs gather path
SLICE_TOL = {"float": 2e-2, "grau": 5e-2, "wq4_kv4_grau": 5e-2}


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
        spec = specs[0]
        regs = spec.packed(dev)
        kw = dict(num_exponents=spec.num_exponents, qmin=spec.qmin,
                  qmax=spec.qmax)
        row["ms"] = device_ms(torch, lambda: gk.grau_unit(small, regs, **kw))
        row["plain_ms"] = device_ms(torch, lambda: gk.grau_plain(small, regs,
                                                                 **kw), 5, 1)
        # per element: 7 compares + 3 selects + per stage (shift, test, add)
        # + multiply-add + clamp
        ops_per = 7 + 3 + 3 * spec.num_exponents + 4
        row["bound_ms"], row["bound_by"] = bound(5 * n, ops_per * n, "int32")
        row["library_ms"] = None
    return row


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
    their plain versions; rows keyed by kernel name and kv_bits."""
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
            suffix = "" if kv_bits == 16 else f"_kv{kv_bits}"
            row = {"name": name + suffix, "route": "cuda",
                   "source": "src/repro_torch/csrc/paged_attention.cu",
                   "replaces": ("src/repro/kernels/paged_attention.py:189"
                                if name == "paged_attention" else
                                "src/repro/kernels/paged_attention.py:401"),
                   "kv_bits": kv_bits, "max_abs_err": worst}
            if timed:
                row.update(time_paged(torch, np, dev, name, s, group, rng,
                                      kv_bits))
                log(f"timed: {json.dumps(row)}")
            rows[name + suffix] = row
    return rows


def time_paged(torch, np, dev, name, s, group, rng, kv_bits=16):
    """Times at the main path's shape in bf16: a decode tick at the widest
    bucket (8 slots, ragged up to max_len), or one prefill chunk (b = 1)
    starting mid-prompt, over 16-, 8- or 4-bit pools. The bound counts the
    pools' bytes at kv_bits."""
    from functools import partial

    from repro_torch.kernels import paged_attention as pa
    (q, k, v, table, lengths), kv = paged_case(torch, np, dev,
                                               torch.bfloat16, s, rng,
                                               kv_bits)
    kd, vd = dequant_pools(torch, k, v, kv, torch.bfloat16)
    h, d, kvh, bs = s["h"], s["d"], s["kvh"], s["bs"]
    if name == "paged_attention":
        args = (q, k, v, table, lengths)
        ends = [int(n) for n in lengths.cpu()]
        nbytes = (live_bytes(ends, bs, kvh, d, kv_bits) + 2 * 2 * q.numel()
                  + 4 * len(ends))
        flops = sum(4 * h * d * n for n in ends)
        lib = sdpa_yardstick(torch, q, kd, vd, table, lengths, group)
        kern, plain = pa.paged_attention, pa.paged_attention_plain
    else:
        C = s["chunk"]
        start = torch.tensor([s["max_len"] // 2 - C], dtype=torch.int32,
                             device=dev)
        width = -(-(int(start) + C) // bs)
        tab = table[1:2, :width].contiguous()
        qp = torch.randn((1, C, h, d), device=dev).to(torch.bfloat16)
        args = (qp, k, v, tab, start)
        end = int(start) + C
        nbytes = live_bytes([end], bs, kvh, d, kv_bits) + 2 * 2 * qp.numel()
        flops = sum(4 * h * d * (int(start) + r + 1) for r in range(C))
        rows_end = start[:, None] + torch.arange(C, device=dev)[None]
        lib = sdpa_yardstick(torch, qp, kd, vd, tab, None, group, rows_end)
        kern, plain = pa.paged_prefill_attention, pa.paged_prefill_plain
    kern, plain = partial(kern, **kv), partial(plain, **kv)
    t_bound, by = bound(nbytes, flops, "bf16")
    return {"ms": device_ms(torch, lambda: kern(*args)),
            "plain_ms": device_ms(torch, lambda: plain(*args), 5, 1),
            "bound_ms": t_bound, "bound_by": by,
            "library_ms": device_ms(torch, lib),
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


def time_matmul_wq(torch, dev, shapes, wname, M, bits):
    """One MLP product in bf16, timed over enough weight copies to exceed
    L2 (as the served model streams 84 different weights a forward): the
    kernel, its plain version, and torch.matmul on the bf16 dequantized
    weight; the bound counts x, the payload, the exponents and the output
    once."""
    from repro_torch.kernels import matmul_wq as mm
    from repro_torch.quant import weights as wq
    K, N = shapes["mlp"][wname]
    x = torch.randn((M, K), device=dev).to(torch.bfloat16)
    base = wq.pack_tensor(torch.randn((K, N), device=dev) * K ** -0.5, bits,
                          -2)
    copies = max(2, -(-60_000_000 // (K * N * 2)))        # > 50 MB of bf16
    ws = [wq.QuantWeight(q=base.q.clone(), e=base.e.clone(), bits=bits,
                         caxis=-2, kdim=K, tile=base.tile)
          for _ in range(copies)]
    dense = [wq.dense(w, torch.bfloat16) for w in ws]
    nbytes = (x.numel() * 2 + base.q.numel() + base.e.numel() + M * N * 2)
    t_bound, by = bound(nbytes, 2 * M * K * N, "bf16")
    return {"weight": wname, "M": M, "K": K, "N": N, "bits": bits,
            "ms": device_ms(torch, cycling([
                (lambda w=w: mm.matmul_wq(x, w)) for w in ws]), 50, 5),
            "plain_ms": device_ms(torch, cycling([
                (lambda w=w: mm.matmul_wq_plain(x, w.q, w.e, bits=bits,
                                                kdim=K)) for w in ws]), 5, 1),
            "bound_ms": t_bound, "bound_by": by,
            "library_ms": device_ms(torch, cycling([
                (lambda d=d: torch.matmul(x, d)) for d in dense]), 50, 5)}


def matmul_grau_specs(np, rng):
    """The quickstart's SiLU unit (signed bus), a ReLU unit on the unsigned
    (uint8) bus, and random register files (negative pre-shifts, shift
    counts 31-40)."""
    from repro_torch.core.build import build_grau
    from repro_torch.core.folding import fold
    from repro_torch.pwlf.spec import make_spec
    kw = dict(mac_range=(-30000, 30000), segments=6, num_exponents=8,
              mode="apot")
    silu = build_grau(fold("silu", s_in=2 ** -10, s_out=2 ** -4, out_bits=8),
                      bias_mode="lsq", **kw).spec
    relu = build_grau(fold("relu", s_in=2 ** -10, s_out=2 ** -4, out_bits=8,
                           out_signed=False), **kw).spec
    return [silu, relu] + random_specs(np, make_spec, rng, 8)


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


def time_matmul_grau(torch, dev, spec, M, K, N):
    """One int8 product with the GRAU epilogue, timed over enough weight
    copies to exceed L2: the kernel, its plain version, and as the library
    yardstick torch._int_mm (cuBLASLt int8 -> int32, without the epilogue:
    it writes 4 bytes an output where the kernel writes 1). The bound counts
    x, w and the 8-bit output once, and 2 M K N int8 operations."""
    from repro_torch.kernels import matmul_grau as mg
    from repro_torch.kernels.ref import wrap_int32
    x = torch.randint(-128, 128, (M, K), dtype=torch.int8, device=dev)
    base = torch.randint(-128, 128, (K, N), dtype=torch.int8, device=dev)
    ws = [base.clone() for _ in range(max(2, -(-60_000_000 // (K * N))))]
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
    return {"M": M, "K": K, "N": N,
            "ms": device_ms(torch, cycling([
                (lambda w=w: mg.matmul_grau(x, w, regs, **kw)) for w in ws]),
                50, 5),
            "plain_ms": device_ms(torch, cycling([
                (lambda w=w: mg.matmul_grau_plain(x, w, regs, **kw))
                for w in ws]), 5, 1),
            "bound_ms": t_bound, "bound_by": by,
            "library_ms": device_ms(torch, cycling([
                (lambda w=w: torch._int_mm(x, w)) for w in ws]), 50, 5),
            "library_kmajor_ms": device_ms(torch, cycling([
                (lambda w=w: torch._int_mm(x, w)) for w in kmajor]), 50, 5),
            "library_call": "torch._int_mm(x, w) on w row-major (K, N), as "
                            "the kernel takes it (library_kmajor_ms: on a "
                            "column-major copy): int8 -> int32 without the "
                            "GRAU epilogue (the port never calls it)"}


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
    from torch.autograd import DeviceType
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:    # host ops: skip (their
            continue                              # kernels are listed)
        dev_us = (getattr(evt, "self_device_time_total", None)
                  or getattr(evt, "self_cuda_time_total", 0) or 0)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(
        f"{us / 1e3:12.3f} ms  {n:8d}x  {key}" for us, key, n in rows))
    out = {"window_steps": window, "decode_ticks": ticks,
           "prefill_chunks": chunks, "wall_s": wall,
           "device_busy_s": busy_s, "device_busy_share": busy_s / wall,
           "top": [{"kernel": key[:80], "ms": us / 1e3, "calls": n}
                   for us, key, n in rows[:10]]}
    log(f"profile[{label}]: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="also profile one served run per configuration; "
                         "per-kernel device times go to PATH.<config>.txt")
    ap.add_argument("--rehearse", action="store_true",
                    help="smoke-size control-flow run on the CPU; exits 1")
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
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build as kbuild
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e}); run from a checkout "
              "of the repository", file=sys.stderr)
        return 2

    dev = torch.device("cpu" if args.rehearse else "cuda")
    timed = not args.rehearse
    report = {}
    if timed:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
        log(card)
        report["card"] = card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        took = kbuild.build()
        report["build_s"] = time.perf_counter() - t0
        report["phase_s"] = {"build": report["build_s"]}
        log(f"kernel build: {report['build_s']:.1f} s "
            f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
        for name in kbuild.SOURCES:
            for line in kbuild.ptxas_report(name).splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas[{name}]: {line.strip()}")

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
    shapes["mm_grau_timed"] = [(128, 256, 128)] + mlp_mkn
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
        rows["matmul_wq"] = phase("matmul_wq", lambda: check_matmul_wq(
            torch, np, dev, shapes, rng, timed))
        rows["matmul_grau"] = phase("matmul_grau", lambda: check_matmul_grau(
            torch, np, dev, shapes, rng, timed))
        slice_res = phase("slices_abc", lambda: slice_phase(
            torch, np, dev, args, args.rehearse))
        paper = phase("slice_d", lambda: paper_flow(torch, np, dev, args,
                                                     args.rehearse))
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    report["slice"] = slice_res
    report["paper_flow"] = paper
    # launches on the main paths: the 16-bit attention rows from (b), where
    # the GRAU datapath runs fused in the attention kernels' epilogue; the
    # 4-bit attention rows and matmul_wq from (c); the GRAU unit and
    # matmul_grau from (d) (the quickstart, and Table III's integer
    # activations)
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
    kernel_rows = [grau_row] + [rows[n] for n in (
        "paged_attention", "paged_prefill", "paged_attention_kv4",
        "paged_prefill_kv4", "matmul_wq", "matmul_grau")]
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
