"""Serving launcher for the PyTorch port: continuous batching over the paged
KV pool with the CUDA kernels, the radix prefix cache and preemption,
printing the engine's metrics as JSON.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 8 --slots 8 --max-seq 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --grau --attn-grau identity
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --dtype float32 --weight-bits 4 --kv-bits 4 --grau --attn-grau identity
  # a shared 48-token system prompt served through the prefix cache
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --prefix-cache --shared-prefix 48
  # a pool of 10 blocks: a blocked queue head preempts a later arrival
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --num-blocks 10 --prompt-len 4 64 --max-new 16 --requests 8 \
      --preempt-after-ticks 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
      --smoke --device cpu            # also --arch qwen1.5-32b
  # sampled decoding, a per-request deadline, the lifecycle trace as JSONL
  # and a Prometheus /metrics endpoint while it runs
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --temperature 0.8 --top-k 40 --top-p 0.9 --deadline-ms 60000 \
      --trace-out build/trace.jsonl --metrics-port 0

Archs: llama3.2-3b, gemma-7b, glm4-9b, qwen1.5-32b (configs/archs.py).
The journal, snapshots and the mesh are not ported yet. A first SIGINT or
SIGTERM drains (in-flight streams finish, queued requests wait), a second
stops at once.

Weights are random, drawn from --seed on the device (the published weight
files are not in the repository). At startup it prints the analytic KV and
weight memory tables (core/hwcost.py) at 16/8/4 bits. The device defaults
to CUDA; without a card pass --device cpu, which runs the kernels' plain
torch versions.
"""
from __future__ import annotations

import argparse
import json
import signal
import time

import numpy as np


def print_cost_tables(cfg, args) -> None:
    """The startup memory tables from the analytic cost model
    (core/hwcost.py), printed as the JAX package's launcher prints them: KV
    bytes per slot, whole-pool bytes and decode gather bytes per step at
    16/8/4 bits, then the packable matmul weight bytes at 16/8/4 bits (decode
    streams every weight once per token, so total bytes is the
    model-bytes/step term). The serving precision is marked."""
    from repro_torch.core.hwcost import kv_cache_cost, weight_cost
    kv_bits, weight_bits = args.kv_bits or 16, args.weight_bits or 16
    print(f"kv cache @ page_size={args.page_size}, "
          f"max_seq={args.max_seq}, slots={args.slots}:")
    for bits in (16, 8, 4):
        r = kv_cache_cost(num_layers=cfg.num_layers,
                          kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                          block_size=args.page_size, kv_bits=bits,
                          slots=args.slots, max_seq=args.max_seq)
        mark = " <- serving" if bits == kv_bits else ""
        print(f"  kv_bits={bits:2d}: {r.bytes_per_slot / 1e6:8.3f} MB/slot, "
              f"pool {r.pool_bytes / 1e6:8.3f} MB, "
              f"gather {r.gather_bytes_per_step / 1e3:8.1f} KB/step"
              f"{mark}")
    wq_layers = sum(sum(1 for spec in period
                        if spec.kind == "attn" and spec.mlp == "dense")
                    * repeats for period, repeats in cfg.groups)
    print(f"serving weights (attn+dense-mlp layers={wq_layers}):")
    for bits in (16, 8, 4):
        w = weight_cost(num_layers=wq_layers, d_model=cfg.d_model,
                        num_heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                        head_dim=cfg.head_dim, d_ff=cfg.d_ff,
                        gated=cfg.gated_mlp, vocab_size=cfg.vocab_size,
                        tied=cfg.tie_embeddings, weight_bits=bits)
        mark = " <- serving" if bits == weight_bits else ""
        print(f"  weight_bits={bits:2d}: {w.total_bytes / 1e6:8.3f} MB total "
              f"(layers {w.layer_bytes / 1e6:8.3f} MB, "
              f"embed {w.embed_bytes / 1e6:8.3f} MB, "
              f"scales {w.scale_bytes / 1e3:7.1f} KB)"
              f"{mark}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    from repro_torch.configs.archs import ARCHS
    ap.add_argument("--arch", default="llama3.2-3b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never chosen silently")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 12),
                    metavar=("LO", "HI"),
                    help="prompt lengths drawn uniformly from [LO, HI)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--prefill-budget", type=int, default=None)
    ap.add_argument("--policy", choices=["fcfs", "prefill"], default="fcfs")
    ap.add_argument("--max-prefills-per-tick", type=int, default=None,
                    help="admissions per tick (default: 1 under fcfs, every "
                         "free slot under prefill)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree shared-prefix KV reuse")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a shared synthetic system prompt of this "
                         "many tokens to every request (prefix-cache demo)")
    ap.add_argument("--no-preemption", action="store_true",
                    help="disable KV-pressure preemption (a blocked request "
                         "then waits for natural retirements)")
    ap.add_argument("--preempt-after-ticks", type=int, default=8,
                    help="ticks a blocked queue head must wait before it "
                         "may evict later-arrival decode slots")
    ap.add_argument("--paged-impl", choices=["kernel", "gather"],
                    default=None)
    ap.add_argument("--grau", action="store_true",
                    help="GRAU surrogate for the MLP activation (cfg.grau)")
    ap.add_argument("--attn-grau", default=None, metavar="ACT",
                    help="fuse a GRAU epilogue fitted to ACT (e.g. identity) "
                         "on the attention output")
    ap.add_argument("--kv-bits", type=int, choices=[16, 8, 4], default=None,
                    help="KV-pool precision: 16 = float pools, 8/4 = packed "
                         "int pools with power-of-two block exponents")
    ap.add_argument("--weight-bits", type=int, choices=[16, 8, 4],
                    default=None,
                    help="serving-weight precision: 16 = float, 8/4 = packed "
                         "power-of-two planes (the MLP runs the matmul_wq "
                         "kernel)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request wall-clock budget: a request past it "
                         "retires with reason 'deadline' at the next tick "
                         "boundary, keeping the tokens generated before")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable the metrics registry and lifecycle traces "
                         "(on by default; the streams are the same)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics, /metrics.json and "
                         "/healthz on 127.0.0.1 at this port while running; "
                         "0 picks a free port")
    ap.add_argument("--trace-out", default=None,
                    help="write the per-request lifecycle trace as JSONL "
                         "here on exit")
    ap.add_argument("--audit-interval", type=int, default=None,
                    help="run the engine's invariant audit every N ticks "
                         "(default: on demand only)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    telemetry = not args.no_telemetry
    if args.metrics_port is not None and not telemetry:
        ap.error("--metrics-port requires telemetry (drop --no-telemetry)")
    if args.trace_out is not None and not telemetry:
        ap.error("--trace-out requires telemetry (drop --no-telemetry)")

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.models import lm
    from repro_torch.models.config import GRAUConfig
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    device = lm.resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.grau:
        cfg = cfg.replace(grau=GRAUConfig())
    params = lm.init_lm(cfg, seed=args.seed, dtype=getattr(torch, args.dtype),
                        device=device)
    ecfg = EngineConfig(
        slots=args.slots, max_seq=args.max_seq, page_size=args.page_size,
        num_blocks=args.num_blocks, paged_impl=args.paged_impl,
        attn_grau=(build_lm_grau(args.attn_grau) if args.attn_grau
                   else None),
        prefill_chunk=args.prefill_chunk,
        prefill_token_budget=args.prefill_budget, policy=args.policy,
        max_prefills_per_tick=args.max_prefills_per_tick,
        prefix_cache=args.prefix_cache, preemption=not args.no_preemption,
        preempt_after_ticks=args.preempt_after_ticks,
        kv_bits=args.kv_bits, weight_bits=args.weight_bits,
        telemetry=telemetry, audit_interval=args.audit_interval,
        seed=args.seed)
    engine = ServeEngine(cfg, params, ecfg, device=device)
    if args.metrics_port is not None:
        # engine-owned endpoint: engine.close() (the finally below) stops
        # the socket and joins its thread however the launcher exits
        server = engine.serve_metrics(args.metrics_port)
        print(f"metrics: http://{server.server_address[0]}:"
              f"{server.server_address[1]}/metrics")
    print_cost_tables(cfg, args)
    engine.warmup()
    rng = np.random.default_rng(args.seed)
    lo, hi = args.prompt_len
    shared = rng.integers(2, cfg.vocab_size, size=args.shared_prefix)
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    reqs = [Request(rid=i, prompt=np.concatenate(
                [shared, rng.integers(2, cfg.vocab_size,
                                      size=int(rng.integers(lo, hi)))]),
                    max_new_tokens=args.max_new, sampling=sampling,
                    deadline_ms=args.deadline_ms)
            for i in range(args.requests)]

    signals = {"count": 0}

    def on_signal(signum, frame):
        signals["count"] += 1

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, on_signal)
    try:
        t0 = time.perf_counter()
        for req in reqs:
            engine.submit(req)
        done = []
        ticks = 0
        while (engine.scheduler.waiting
               or any(r is not None for r in engine.slot_req)):
            if signals["count"] and engine.health != "draining":
                engine.begin_draining("signal")
                print("draining: finishing in-flight streams (signal again "
                      "to stop now)")
            if signals["count"] > 1 or (
                    signals["count"]
                    and all(r is None for r in engine.slot_req)):
                break
            made_progress = (engine.step() > 0
                             or not engine.scheduler.waiting)
            done.extend(engine.poll())
            ticks += 1
            if ticks >= 100000 or (not made_progress and not any(
                    r is not None for r in engine.slot_req)):
                break    # queue head can never admit: bail, don't spin
        done.extend(engine.poll())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        for r in sorted(done, key=lambda r: r.rid):
            print(f"rid={r.rid} prompt_len={len(r.prompt)} "
                  f"tokens={r.out_tokens}")
        m = engine.metrics()
        print(f"prefix cache: hit_rate={m['prefix_hit_rate']:.2f} "
              f"cached_prefix_tokens={m['cached_prefix_tokens']} "
              f"evictions={m['evictions']}")
        print(f"preemption: preempted={m['preempted']} "
              f"hol_skips={m['hol_skips']}")
        m.update(arch=cfg.name, wall_s=wall,
                 tokens_per_s=m["decode_tokens"] / wall if wall > 0 else None)
        print(json.dumps(m))
        if args.trace_out:
            n = engine.export_trace(args.trace_out)
            print(f"wrote {n} trace events to {args.trace_out}")
    finally:
        engine.close()


if __name__ == "__main__":
    main()
