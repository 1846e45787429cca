"""Serving launcher for the PyTorch port: continuous batching over the paged
KV pool with the CUDA kernels, printing the engine's metrics as JSON.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 8 --slots 8 --max-seq 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --grau --attn-grau identity
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --dtype float32 --weight-bits 4 --kv-bits 4 --grau --attn-grau identity

Weights are random, drawn from --seed on the device (the published weight
files are not in the repository). At startup it prints the analytic KV and
weight memory tables (core/hwcost.py) at 16/8/4 bits. The device defaults
to CUDA; without a card pass --device cpu, which runs the kernels' plain
torch versions.
"""
from __future__ import annotations

import argparse
import json
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
    ap.add_argument("--arch", default="llama3.2-3b")
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.models import lm
    from repro_torch.models.config import GRAUConfig
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

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
        kv_bits=args.kv_bits, weight_bits=args.weight_bits, seed=args.seed)
    engine = ServeEngine(cfg, params, ecfg, device=device)
    print_cost_tables(cfg, args)
    engine.warmup()
    rng = np.random.default_rng(args.seed)
    lo, hi = args.prompt_len
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size,
                                               size=int(rng.integers(lo, hi))),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    for r in sorted(done, key=lambda r: r.rid):
        print(f"rid={r.rid} prompt_len={len(r.prompt)} "
              f"tokens={r.out_tokens}")
    m = engine.metrics()
    m.update(arch=cfg.name, wall_s=wall,
             tokens_per_s=m["decode_tokens"] / wall if wall > 0 else None)
    print(json.dumps(m))


if __name__ == "__main__":
    main()
