"""Table III: Original vs PWLF vs PoT-PWLF vs APoT-PWLF accuracy on SFC (FC
net) and CNV (conv net) across ReLU / Sigmoid / SiLU.

    PYTHONPATH=src python -m repro_torch.tables.table3_small_models \
        [--quick] [--device cuda] [--settings sfc-silu cnv-silu] [--steps N]

Data: deterministic synthetic class-blob images (data/pipeline.py; no image
datasets are in the repository). The reproduced quantity is the paper's
approximation-degradation ordering: PWLF ~ Original; APoT >= PoT; ReLU
easiest, SiLU hardest. Settings and printed rows are the JAX package's
benchmarks/table3_small_models.py: hw 16, 1 / 3 channels, 600 steps (250
with --quick, which also keeps only the SFC rows), batch 128, lr 0.05
(0.5 and at least 800 steps for the SFC sigmoid), 6 segments, 8 exponents,
anchor bias, 6 evaluation batches. `--steps` overrides the step count for
a shorter run. Training, the float evaluation and every integer activation
run on the device (default: CUDA); the pot/apot rows send each activation
through the GRAU unit (kernels.ops.grau), once per layer per batch.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.models.vision import (VisionConfig, eval_vision,
                                       make_grau_acts, train_vision)

SETTINGS = [("sfc", "relu"), ("sfc", "sigmoid"), ("sfc", "silu"),
            ("cnv", "relu"), ("cnv", "sigmoid"), ("cnv", "silu")]
EVAL_STEPS = 6
GRAU_KW = dict(segments=6, num_exponents=8, bias_mode="anchor")


def train_setting(kind: str, act: str, steps: int, device=None):
    """(cfg, params, pipeline) after QAT training at the table's settings."""
    cfg = VisionConfig(kind=kind, activation=act, hw=16,
                       channels=1 if kind == "sfc" else 3)
    # sigmoid saturation needs a hotter schedule to train through
    lr = 0.5 if (kind == "sfc" and act == "sigmoid") else 0.05
    params, pipe = train_vision(cfg, steps=max(steps, 800) if lr > 0.1
                                else steps, lr=lr, device=device)
    return cfg, params, pipe


def run(quick: bool = False, *, device=None,
        settings: Optional[Sequence[Tuple[str, str]]] = None,
        steps: Optional[int] = None) -> List[Dict]:
    """One row per setting; each also holds the trained state under
    "state": (cfg, params, pipeline, ranges)."""
    rows = []
    steps = steps or (250 if quick else 600)
    if settings is None:
        settings = SETTINGS[:3] if quick else SETTINGS
    for kind, act in settings:
        t0 = time.time()
        cfg, params, pipe = train_setting(kind, act, steps, device)
        ranges: Dict[str, List[float]] = {}
        acc0 = eval_vision(params, cfg, pipe, ranges=ranges, steps=EVAL_STEPS)
        row = {"model": kind, "act": act, "original": acc0,
               "layers": len(ranges)}
        for mode in ("pwlf", "pot", "apot"):
            impls = make_grau_acts(cfg, ranges, mode=mode, **GRAU_KW)
            row[mode] = eval_vision(params, cfg, pipe, act_impls=impls,
                                    steps=EVAL_STEPS)
        row["secs"] = round(time.time() - t0, 1)
        print(f"table3,{kind}-{act},orig={row['original']:.4f},"
              f"pwlf={row['pwlf']:.4f},pot={row['pot']:.4f},"
              f"apot={row['apot']:.4f}", flush=True)
        row["state"] = (cfg, params, pipe, ranges)
        rows.append(row)
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never chosen silently")
    ap.add_argument("--settings", nargs="+", default=None,
                    metavar="MODEL-ACT", help="e.g. sfc-silu cnv-relu")
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)
    settings = ([tuple(s.split("-", 1)) for s in args.settings]
                if args.settings else None)
    return run(args.quick, device=args.device, settings=settings,
               steps=args.steps)


if __name__ == "__main__":
    main()
