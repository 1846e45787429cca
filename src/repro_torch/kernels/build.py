"""Build the port's CUDA sources with nvcc and bind them through ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
        -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The build happens on first use, into `build/kernels/` at the repository root
(git-ignored); the file name carries a hash of the sources, so an edited
kernel is rebuilt and an unchanged one is loaded as it is.

A source named in `SHARDS` is compiled as several units instead: unit i is
the same file compiled with `-c -DKERNEL_SHARD=i -DKERNEL_SHARDS=n` (the
source then defines only its share of the template instantiations, and unit
0 also the entry points), and the n objects are linked into the one
library. `build()` starts one nvcc per unit of every source, all at once,
and waits for them together, so the build's wall time is that of the
slowest unit. Nothing here runs at import time: the CPU tests import every
module without a toolkit.

    python -m repro_torch.kernels.build

builds every source not built yet and prints each unit's own nvcc seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("grau", "paged_attention", "paged_prefill", "matmul_wq",
           "matmul_grau", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# sources compiled as this many units each (the source reads KERNEL_SHARD):
# paged_attention.cu's 42 f32-query kernels took 127.9 s of nvcc alone, the
# next source 20.0 s (`python -m repro_torch.kernels.build`, one H100 host)
SHARDS: Dict[str, int] = {"paged_attention": 6}

H100_SMS = 132          # streaming multiprocessors of an H100 SXM

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the kernels' part plans
    size their grids to fill them)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    h.update(str(SHARDS.get(name, 1)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _run_all(cmds: Dict[str, List[str]]) -> Dict[str, tuple]:
    """Run every command at once; {unit: (returncode, output, seconds)},
    each unit's seconds from its own start to its own end."""
    res: Dict[str, tuple] = {}

    def wait(unit, proc, t0):
        out, _ = proc.communicate()
        res[unit] = (proc.returncode, out, time.perf_counter() - t0)
    threads = []
    for unit, cmd in cmds.items():
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        threads.append(threading.Thread(target=wait, args=(unit, proc, t0)))
        threads[-1].start()
    for t in threads:
        t.join()
    return res


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, one nvcc
    process a unit (a source, or each of a SHARDS source's units), all
    running together; a sharded source's objects are then linked. Returns
    {unit: its own seconds} for the units compiled ("name" or "name[i/n]",
    and "name[link]"); the ptxas report (registers, shared memory, spills)
    of all of a source's units lands beside its library as `<lib>.log`.
    Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    cmds: Dict[str, List[str]] = {}
    todo: Dict[str, tuple] = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = str(CSRC / f"{name}.cu")
        n = SHARDS.get(name, 1)
        if n == 1:
            cmds[name] = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                          src]
            todo[name] = (out, tmp, [name], [])
            continue
        units, objs = [], []
        for i in range(n):
            unit, obj = f"{name}[{i}/{n}]", tmp.with_suffix(f".{i}.o")
            cmds[unit] = [nvcc, *compile_flags, "-c", f"-DKERNEL_SHARD={i}",
                          f"-DKERNEL_SHARDS={n}", "-I", str(CSRC), "-o",
                          str(obj), src]
            units.append(unit)
            objs.append(obj)
        todo[name] = (out, tmp, units, objs)
    res = _run_all(cmds)
    took = {unit: r[2] for unit, r in res.items()}
    failed: List[str] = []
    links: Dict[str, List[str]] = {}
    for name, (out, tmp, units, objs) in todo.items():
        bad = [u for u in units if res[u][0] != 0]
        failed += [f"nvcc {u} ({name}.cu) failed ({res[u][0]}):\n{res[u][1]}"
                   for u in bad]
        if objs and not bad:
            links[f"{name}[link]"] = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                                      *map(str, objs)]
    lres = _run_all(links)
    for name, (out, tmp, units, objs) in todo.items():
        log = "".join(res[u][1] for u in units)
        link = lres.get(f"{name}[link]")
        if link is not None:
            took[f"{name}[link]"] = link[2]
            log += link[1]
            if link[0] != 0:
                failed.append(f"nvcc link of {name} failed ({link[0]}):\n"
                              f"{link[1]}")
        for obj in objs:
            obj.unlink(missing_ok=True)
        out.with_suffix(".log").write_text(log)
        if tmp.exists() and not failed:
            os.replace(tmp, out)    # atomic: a reader never sees half a file
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


def main() -> int:
    t0 = time.perf_counter()
    took = build()
    wall = time.perf_counter() - t0
    for unit, sec in sorted(took.items(), key=lambda kv: -kv[1]):
        print(f"{unit}: {sec:.1f} s")
    print(f"build wall: {wall:.1f} s ({len(took)} units compiled)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
