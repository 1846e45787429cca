"""Table VI: LUT/FF/frequency/depth/ADP of the Multi-Threshold unit vs GRAU
units from the calibrated analytical cost model (core/hwcost.py; no FPGA
synthesis runs here — the model is least-squares-calibrated against the
paper's published numbers, max residual < 1.4% on the GRAU rows).

    PYTHONPATH=src python -m repro_torch.tables.table6_hwcost [--quick]

Rows and the headline LUT-reduction line as the JAX package's
benchmarks/table6_hwcost.py prints them. The model is pure Python: nothing
runs on a device, so the driver takes no --device (--quick is accepted for
a uniform command line and changes nothing: the table is already small).
"""
from __future__ import annotations

import argparse
from typing import Dict, List

from repro_torch.core import hwcost


def run(quick: bool = False) -> List[Dict]:
    rows = []

    def emit(r: hwcost.HWReport, seg="-", ne="-"):
        delay = 1e3 / r.freq_mhz  # ns per cycle at max frequency
        rows.append({
            "unit": r.name, "design": r.design, "segments": seg,
            "exponents": ne, "lut": r.lut, "ff": r.ff,
            "freq_mhz": r.freq_mhz, "depth8": r.pipeline_depth_8bit,
            "adp": r.lut * delay, "cycles": r.cycles_per_input,
        })
        print(f"table6,{r.name}-{r.design},seg={seg},exp={ne},lut={r.lut},"
              f"ff={r.ff},freq={r.freq_mhz:.0f}MHz,"
              f"cycles8={r.cycles_per_input[8]}", flush=True)

    emit(hwcost.mt_cost(8, "pipelined"))
    emit(hwcost.mt_cost(8, "serialized"))
    for mode in ("pot", "apot"):
        for seg in (4, 6, 8):
            for ne in (8, 16):
                emit(hwcost.grau_cost(seg, ne, mode, "pipelined"), seg, ne)
        emit(hwcost.grau_cost(6, 8, mode, "serialized"))

    mt = hwcost.mt_cost(8, "pipelined").lut
    worst = max(r["lut"] for r in rows if r["unit"] != "multi-threshold")
    print(f"table6,summary,headline_lut_reduction="
          f"{100 * (1 - worst / mt):.1f}%_worst_case (paper: >90%)", flush=True)
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    return run(args.quick)


if __name__ == "__main__":
    main()
