"""Hand-written CUDA kernels for Hopper, their plain torch versions and the
wrappers that pick between them by device (CPU tensor: plain version; CUDA
tensor: the kernel)."""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels import (flash_attention, grau, matmul_grau,
                                     matmul_wq, paged_attention)
    return {"grau": grau.grau_unit,
            "paged_attention": paged_attention.paged_attention,
            "paged_prefill": paged_attention.paged_prefill_attention,
            "matmul_wq": matmul_wq.matmul_wq,
            "matmul_grau": matmul_grau.matmul_grau,
            "flash_attention": flash_attention.flash_attention}


# sub-counts some wrappers keep beside `launches`, and their report suffixes:
# launches with the fused GRAU epilogue, and attention launches on 8- and
# 4-bit KV pools
_SUBCOUNTS = (("epilogue_launches", "epilogue"), ("kv8_launches", "kv8"),
              ("kv4_launches", "kv4"))


def reset_launches() -> None:
    """Zero every kernel wrapper's launch counters."""
    for fn in _wrappers().values():
        fn.launches = 0
        for attr, _ in _SUBCOUNTS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def launch_counts() -> Dict[str, int]:
    """{kernel: launches} plus {kernel}_epilogue (fused GRAU epilogue),
    {kernel}_kv8 and {kernel}_kv4 (attention on quantized pools) where the
    wrapper counts them."""
    out = {}
    for name, fn in _wrappers().items():
        out[name] = fn.launches
        for attr, suffix in _SUBCOUNTS:
            if hasattr(fn, attr):
                out[f"{name}_{suffix}"] = getattr(fn, attr)
    return out
