"""Build the port's CUDA sources with nvcc and bind them through ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
        -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The build happens on first use, into `build/kernels/` at the repository root
(git-ignored); the file name carries a hash of the sources, so an edited
kernel is rebuilt and an unchanged one is loaded as it is. `build()` starts
one nvcc per source, all at once, and waits for them together. Nothing here
runs at import time: the CPU tests import every module without a toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("grau", "paged_attention", "matmul_wq", "matmul_grau")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc): the port's kernels "
                           "build only where CUDA_HOME or nvcc is available")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, one nvcc
    process each, all running together. Returns {name: seconds} for the
    sources that were compiled; the ptxas report (registers, shared memory,
    spills) lands beside each library as `<lib>.log`. Raises with nvcc's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    took: Dict[str, float] = {}
    failed: List[str] = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)       # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def ptxas_report(name: str) -> str:
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` (built if needed), with
    `argtypes` declared from `signatures` ({function: argtypes}); every
    function returns a cudaError_t as int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t)")
