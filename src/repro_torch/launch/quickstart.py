"""Quickstart: build a GRAU unit for a folded activation, run the bit-exact
integer datapath (the unit kernel and the fused int8 matmul + GRAU kernel),
and reconfigure it at runtime.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cuda]

The steps of the JAX package's examples/quickstart.py, on the port: 1. fold
SiLU with requantization; 2. fit it (greedy PWLF, APoT projection, register
file); 3. the unit through kernels.ops.grau; 4. the fused "end-to-end MAC to
quant" int8 matrix product through kernels.ops.matmul_grau; 5. a new
register file (ReLU) through the same compiled kernel, no rebuild. Every
kernel output is held bit for bit against its plain torch version on the
same device (and the unit against the grau_apply_int oracle); a mismatch
raises. Runs on CUDA unless --device cpu is given (the kernels' plain
versions then run); inputs come from numpy, seeded by --seed.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch


def _same(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise RuntimeError(f"quickstart: {what} differs from its plain "
                           "version")


def run(device=None, seed: int = 0, verbose: bool = True) -> Dict:
    """The quickstart's five steps on `device` (default: CUDA, see
    models/lm.resolve_device); returns what it printed as a dict."""
    from repro_torch.core.build import build_grau
    from repro_torch.core.folding import fold
    from repro_torch.core.grau import grau_apply_int
    from repro_torch.kernels import grau as grau_kernel
    from repro_torch.kernels import matmul_grau as mm_kernel
    from repro_torch.kernels import ops
    from repro_torch.models.lm import resolve_device

    dev = resolve_device(device)
    say = print if verbose else (lambda *a: None)
    rng = np.random.default_rng(seed)
    out: Dict = {"device": str(dev)}

    # 1. The unit's target: SiLU folded with requantization, int MAC in ->
    #    int8 out
    folded = fold("silu", s_in=2 ** -10, s_out=2 ** -4, out_bits=8)

    # 2. Offline flow (paper §II-A): greedy PWLF fit -> APoT projection ->
    #    registers
    result = build_grau(folded, mac_range=(-30000, 30000), segments=6,
                        num_exponents=8, mode="apot", bias_mode="lsq")
    spec = result.spec
    out.update(window=list(result.window), int_rms=result.int_rms)
    say(f"fitted window 2^{result.window[0]}..2^{result.window[1]}, "
        f"int-RMS {result.int_rms:.3f} (of 256 levels)")

    # 3. Integer datapath: the unit kernel agrees with its plain version and
    #    the oracle bit for bit
    x = torch.from_numpy(rng.integers(-60000, 60000, size=(256, 512))
                         .astype(np.int32)).to(dev)
    y_krn = ops.grau(x, spec)
    regs = spec.packed(dev)
    kw = dict(num_exponents=spec.num_exponents, qmin=spec.qmin,
              qmax=spec.qmax)
    _same(y_krn, grau_kernel.grau_plain(x, regs, **kw).to(y_krn.dtype),
          "the GRAU unit")
    _same(y_krn.to(torch.int32), grau_apply_int(x, spec),
          "the GRAU unit (oracle)")
    out["grau"] = {"shape": list(y_krn.shape), "dtype": str(y_krn.dtype)}
    say(f"GRAU unit kernel matches its plain version and the oracle: "
        f"{tuple(y_krn.shape)} {y_krn.dtype}")

    # 4. Fused "end-to-end MAC to quant": int8 GEMM whose epilogue IS the unit
    a = torch.from_numpy(rng.integers(-128, 128, size=(128, 256))
                         .astype(np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(-128, 128, size=(256, 128))
                         .astype(np.int8)).to(dev)
    fused = ops.matmul_grau(a, w, spec)
    _same(fused, mm_kernel.matmul_grau_plain(a, w, regs, **kw),
          "the fused int8 matmul + GRAU")
    out["matmul_grau"] = {"shape": list(fused.shape),
                          "dtype": str(fused.dtype)}
    say(f"fused int8 matmul+GRAU matches its plain version: "
        f"{tuple(fused.shape)} {fused.dtype}")

    # 5. Runtime reconfiguration: the same compiled kernel, a new register
    #    file
    relu_unit = build_grau(fold("relu", s_in=2 ** -10, s_out=2 ** -4,
                                out_bits=8),
                           mac_range=(-30000, 30000), segments=6,
                           num_exponents=8, mode="apot").spec
    head = x[:1, :8].contiguous()
    silu_out, relu_out = ops.grau(head, spec), ops.grau(head, relu_unit)
    rregs = relu_unit.packed(dev)
    _same(relu_out, grau_kernel.grau_plain(
        head, rregs, num_exponents=relu_unit.num_exponents,
        qmin=relu_unit.qmin, qmax=relu_unit.qmax).to(relu_out.dtype),
        "the reconfigured GRAU unit")
    out["silu_out"] = silu_out.cpu().tolist()
    out["relu_out"] = relu_out.cpu().tolist()
    say("silu out:", np.asarray(out["silu_out"]))
    say("relu out:", np.asarray(out["relu_out"]),
        "(no rebuild: the register file is data)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never chosen silently")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.device, args.seed)


if __name__ == "__main__":
    main()
