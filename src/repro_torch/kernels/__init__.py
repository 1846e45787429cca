"""Hand-written CUDA kernels for Hopper, their plain torch versions and the
wrappers that pick between them by device (CPU tensor: plain version; CUDA
tensor: the kernel)."""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels import grau, paged_attention
    return {"grau": grau.grau_unit,
            "paged_attention": paged_attention.paged_attention,
            "paged_prefill": paged_attention.paged_prefill_attention}


def reset_launches() -> None:
    """Zero every kernel wrapper's launch counters."""
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "epilogue_launches"):
            fn.epilogue_launches = 0


def launch_counts() -> Dict[str, int]:
    """{kernel: launches} plus {kernel}_epilogue for the fused GRAU
    epilogue launches of the attention kernels."""
    out = {}
    for name, fn in _wrappers().items():
        out[name] = fn.launches
        if hasattr(fn, "epilogue_launches"):
            out[f"{name}_epilogue"] = fn.epilogue_launches
    return out
