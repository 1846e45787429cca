"""Tables IV/V: greedy-PWLF quality sweep over segments (4/6/8) x exponent
count (4/8/16) x mode (pot/apot) x activation (relu/sigmoid/silu), on the
folded integer activation function.

    PYTHONPATH=src python -m repro_torch.tables.table45_sweep \
        [--quick] [--device cuda]

The paper's claims reproduced are the trends (more segments help, APoT >
PoT, negative-exponent windows suffice, ReLU << SiLU sensitivity), from the
integer-domain RMS error of each fitted unit against the exact folded
function. Settings and printed rows are the JAX package's
benchmarks/table45_sweep.py (--quick keeps 8 exponents). The fits run on
the host; each fitted register file is then run through the GRAU unit
(kernels.ops.grau) on the device (default: CUDA) over the fit's integer
grid, and a unit that differs from the host's bit-exact reference
(core/grau.grau_reference_int) raises.
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.build import build_grau
from repro_torch.core.folding import fold
from repro_torch.core.grau import grau_reference_int
from repro_torch.kernels import ops
from repro_torch.models.lm import resolve_device

MAC_RANGE = (-30000, 30000)


def _check_unit(spec, device) -> None:
    """The fitted unit on the device equals the host reference on the
    doubled MAC range's integer grid (build_grau's own evaluation grid)."""
    lo, hi = 2 * MAC_RANGE[0], 2 * MAC_RANGE[1]
    xs = np.unique(np.round(np.linspace(lo, hi, 4097)).astype(np.int64))
    got = ops.grau(torch.from_numpy(xs.astype(np.int32)).to(device), spec)
    if not np.array_equal(got.cpu().numpy().astype(np.int64),
                          grau_reference_int(xs, spec)):
        raise RuntimeError("table45: the GRAU unit differs from the host "
                           "reference on a fitted register file")


def run(quick: bool = False, *, device=None) -> List[Dict]:
    device = resolve_device(device)
    rows = []
    acts = [("relu", 2 ** -4), ("sigmoid", 2 ** -8), ("silu", 2 ** -4)]
    segs = (4, 6, 8)
    exps = (4, 8, 16)
    for act, s_out in acts:
        folded = fold(act, s_in=2 ** -10, s_out=s_out, out_bits=8)
        for seg in segs:
            for ne in (exps if not quick else (8,)):
                for mode in ("pot", "apot"):
                    r = build_grau(folded, mac_range=MAC_RANGE,
                                   segments=seg, num_exponents=ne, mode=mode,
                                   bias_mode="anchor")
                    _check_unit(r.spec, device)
                    rows.append({
                        "act": act, "segments": seg, "exponents": ne,
                        "mode": mode, "window": r.window,
                        "pwlf_rms": r.fit.rms_err, "int_rms": r.int_rms,
                        "int_max": r.int_max_abs,
                    })
                    print(f"table45,{act},S={seg},E={ne},{mode},"
                          f"win={r.window},int_rms={r.int_rms:.3f},"
                          f"int_max={r.int_max_abs:.0f}", flush=True)
    return rows


def check_paper_trends(rows) -> dict:
    """The qualitative Table IV/V findings on the sweep."""
    def by(**kw):
        return [r for r in rows if all(r[k] == v for k, v in kw.items())]

    def mean(rs):
        return float(np.mean([r["int_rms"] for r in rs])) if rs else 0.0

    return {
        # APoT consistently outperforms PoT (paper §II-A)
        "apot_beats_pot": mean(by(mode="apot")) <= mean(by(mode="pot")) + 1e-9,
        # more segments help (4 -> 8)
        "more_segments_help": (mean(by(segments=8))
                               <= mean(by(segments=4)) + 1e-9),
        # ReLU is the easiest activation
        "relu_easiest": mean(by(act="relu")) <= min(mean(by(act="sigmoid")),
                                                    mean(by(act="silu"))) + 1e-9,
        # negative exponents suffice (fitted windows are fully negative)
        "negative_windows": all(r["window"][1] <= 0 for r in rows),
    }


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never chosen silently")
    args = ap.parse_args(argv)
    rows = run(args.quick, device=args.device)
    print(check_paper_trends(rows))
    return rows


if __name__ == "__main__":
    main()
