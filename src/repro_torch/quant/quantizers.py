"""The integer ranges and per-layer quantizer settings that quant/policy.py
hands out. The QAT half of the JAX package's quant/quantizers.py (STE
rounding, fake quantization, binarization) belongs to the vision/CNN path
and is still to port."""
from __future__ import annotations

import dataclasses


def qrange(bits: int, signed: bool = True):
    if signed:
        return -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return 0, (1 << bits) - 1


@dataclasses.dataclass(frozen=True)
class QConfig:
    bits: int = 8
    signed: bool = True
    per_channel: bool = False
    channel_axis: int = -1
    pot_scale: bool = False   # scales rounded up to a power of two

    @property
    def qmin(self):
        return qrange(self.bits, self.signed)[0]

    @property
    def qmax(self):
        return qrange(self.bits, self.signed)[1]
