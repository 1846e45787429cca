"""Mixed-precision policies — the one object that assigns bits end to end.

A PrecisionPolicy carries three rule sets, each an ordered (regex, bits)
list matched against layer names (first match wins) with a default:

* ``rules`` — weight/activation bits per stage of a network (the paper's
  mixed-precision protocol; ``stage_policy`` builds it);
* ``kv_rules`` — KV-pool bits per transformer layer (16 = float pools, 8/4
  = packed int pools with power-of-two block exponents, quant/kv.py);
* ``weight_rules`` — serving weight bits per layer (16 = float, 8/4 =
  packed planes with power-of-two tile exponents, quant/weights.py).

Serving layer names follow the parameter and pool trees: ``group{gi}.l{li}``,
plus ``embed`` / ``head`` for the vocabulary tensors.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Sequence, Tuple

from repro_torch.quant.kv import KV_BITS
from repro_torch.quant.quantizers import QConfig

WEIGHT_BITS = (16, 8, 4)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    rules: Tuple[Tuple[str, int], ...] = ()
    default_bits: int = 8
    kv_rules: Tuple[Tuple[str, int], ...] = ()
    kv_default_bits: int = 16
    weight_rules: Tuple[Tuple[str, int], ...] = ()
    weight_default_bits: int = 16

    def __post_init__(self):
        for pattern, bits in self.kv_rules + (("<default>",
                                               self.kv_default_bits),):
            if bits not in KV_BITS:
                raise ValueError(
                    f"kv rule {pattern!r}: kv_bits must be one of {KV_BITS}, "
                    f"got {bits}")
        for pattern, bits in (self.weight_rules
                              + (("<default>", self.weight_default_bits),)):
            if bits not in WEIGHT_BITS:
                raise ValueError(
                    f"weight rule {pattern!r}: weight_bits must be one of "
                    f"{WEIGHT_BITS}, got {bits}")

    def bits_for(self, layer_name: str) -> int:
        return _first_match(self.rules, layer_name, self.default_bits)

    def qconfig_for(self, layer_name: str, **kw) -> QConfig:
        return QConfig(bits=self.bits_for(layer_name), **kw)

    def kv_bits_for(self, layer_name: str) -> int:
        return _first_match(self.kv_rules, layer_name, self.kv_default_bits)

    def weight_bits_for(self, layer_name: str) -> int:
        return _first_match(self.weight_rules, layer_name,
                            self.weight_default_bits)

    @property
    def kv_quantized(self) -> bool:
        return (self.kv_default_bits < 16
                or any(b < 16 for _, b in self.kv_rules))

    @property
    def weights_quantized(self) -> bool:
        return (self.weight_default_bits < 16
                or any(b < 16 for _, b in self.weight_rules))

    def with_kv(self, bits: int, rules: Tuple[Tuple[str, int], ...] = ()
                ) -> "PrecisionPolicy":
        return dataclasses.replace(self, kv_default_bits=bits, kv_rules=rules)

    def with_weights(self, bits: int, rules: Tuple[Tuple[str, int], ...] = ()
                     ) -> "PrecisionPolicy":
        return dataclasses.replace(self, weight_default_bits=bits,
                                   weight_rules=rules)


def _first_match(rules, name: str, default: int) -> int:
    for pattern, bits in rules:
        if re.search(pattern, name):
            return bits
    return default


def unified(bits: int) -> PrecisionPolicy:
    return PrecisionPolicy(rules=(), default_bits=bits)


def kv_policy(kv_bits: int) -> PrecisionPolicy:
    """Uniform KV-pool precision (the --kv-bits serving knob)."""
    return PrecisionPolicy(kv_default_bits=kv_bits)


def weight_policy(weight_bits: int) -> PrecisionPolicy:
    """Uniform serving-weight precision (the --weight-bits serving knob)."""
    return PrecisionPolicy(weight_default_bits=weight_bits)


def stage_policy(stage_bits: Sequence[int], fc_bits: int = 8
                 ) -> PrecisionPolicy:
    """The paper's scheme: per-stage bits (e.g. [8, 4, 2, 4]) + FC bits."""
    rules = tuple((rf"stage{i}\b|stage{i}[._/]", b)
                  for i, b in enumerate(stage_bits))
    rules += ((r"\bfc\b|head|classifier", fc_bits),)
    return PrecisionPolicy(rules=rules, default_bits=stage_bits[-1])


PAPER_MIXED = stage_policy([8, 4, 2, 4], fc_bits=8)   # the 8/4/2/4/8 scheme
