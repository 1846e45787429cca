"""The paper's own evaluation models: SFC (FC net) and CNV (VGG-like conv),
with QAT fake-quant and GRAU activation replacement — the Table III/IV flow.

The paper's protocol (§II-A), reproduced end to end:
  1. train the QNN while recording each layer's MAC-output range;
  2. fold BN(-free here) + activation + requant into a scalar function per
     layer, double the recorded range, sample 1000 points;
  3. fit greedy-PWLF, project slopes to PoT/APoT, emit GRAUSpec;
  4. swap the float activation for the integer GRAU path and re-evaluate.

Layouts are the JAX package's at every public function: NHWC activations,
HWIO conv weights, (in, out) dense weights, so parameters and activations
cross between the packages as they are. Inside, the convolutions run as
`F.conv2d` on permuted views ("SAME" at 3 x 3 / stride 1 is padding 1) and
the 2 x 2 VALID max pool as `F.max_pool2d`.

On a CUDA device `apply_vision` turns TF32 off for cuDNN convolutions and
cuBLAS products (`torch.backends.cudnn.allow_tf32` and
`torch.backends.cuda.matmul.allow_tf32`, process-wide): the integer path
rounds z / s_in, and TF32's ~3 decimal digits would flip activation codes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.build import build_grau
from repro_torch.core.folding import ACTIVATIONS, fold
from repro_torch.kernels import ops
from repro_torch.kernels.ref import round_to_int32
from repro_torch.models.lm import resolve_device
from repro_torch.nn.common import act_fn, trunc_normal
from repro_torch.pwlf.spec import GRAUSpec, PWLFunction
from repro_torch.quant.quantizers import QConfig, fake_quant


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    kind: str = "sfc"              # "sfc" | "cnv"
    activation: str = "relu"
    num_classes: int = 10
    hw: int = 16
    channels: int = 1
    widths: Tuple[int, ...] = (256, 256, 256)   # SFC hidden sizes
    conv_channels: Tuple[int, ...] = (16, 32)   # CNV block channels
    act_bits: int = 8
    weight_bits: int = 8


def init_vision(cfg: VisionConfig, seed: int = 0, *,
                device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fan-in truncated-normal weights and zero biases, drawn by an explicit
    torch.Generator seeded with `seed` on `device` (default: CUDA, see
    models/lm.resolve_device)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    kw = dict(device=device, dtype=torch.float32)
    params = {}
    if cfg.kind == "sfc":
        dims = [cfg.hw * cfg.hw * cfg.channels, *cfg.widths, cfg.num_classes]
        for i in range(len(dims) - 1):
            params[f"fc{i}"] = {
                "w": trunc_normal((dims[i], dims[i + 1]),
                                  1.0 / np.sqrt(dims[i]), gen, **kw),
                "b": torch.zeros((dims[i + 1],), **kw)}
        return params
    cin = cfg.channels
    for i, cout in enumerate(cfg.conv_channels):
        params[f"conv{i}"] = {
            "w": trunc_normal((3, 3, cin, cout), 1.0 / np.sqrt(9 * cin), gen,
                              **kw),
            "b": torch.zeros((cout,), **kw)}
        cin = cout
    feat = (cfg.hw // (2 ** len(cfg.conv_channels))) ** 2 * cin
    params["fc_out"] = {
        "w": trunc_normal((feat, cfg.num_classes), 1.0 / np.sqrt(feat), gen,
                          **kw),
        "b": torch.zeros((cfg.num_classes,), **kw)}
    return params


def _act_layer(z, act_impls, layer_name, ranges):
    """Apply the layer's override, if any; record the MAC (pre-activation)
    range when tracking (one host sync per layer, eval only)."""
    if ranges is not None:
        ranges.setdefault(layer_name, [0.0, 0.0])
        lo = float(torch.min(z))
        hi = float(torch.max(z))
        ranges[layer_name][0] = min(ranges[layer_name][0], lo)
        ranges[layer_name][1] = max(ranges[layer_name][1], hi)
    impl = act_impls.get(layer_name) if act_impls else None
    return impl(z) if impl is not None else None


def _exact_f32(device: torch.device) -> None:
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def apply_vision(params, cfg: VisionConfig, x: torch.Tensor, *,
                 act_impls: Optional[Dict[str, Callable]] = None,
                 ranges: Optional[Dict[str, List[float]]] = None,
                 qat: bool = True) -> torch.Tensor:
    """Forward on NHWC images -> logits. act_impls maps layer name ->
    activation override (the float activation by default; the GRAU integer
    path after replacement)."""
    _exact_f32(x.device)
    wq = QConfig(bits=cfg.weight_bits)
    aq = QConfig(bits=cfg.act_bits)
    float_act = act_fn(cfg.activation)

    def quant_w(w):
        return fake_quant(w, wq) if qat else w

    def act(z, lname):
        out = _act_layer(z, act_impls or {}, lname, ranges)
        return out if out is not None else fake_quant(float_act(z), aq)

    if cfg.kind == "sfc":
        h = x.reshape(x.shape[0], -1)
        n_hidden = len(cfg.widths)
        for i in range(n_hidden):
            p = params[f"fc{i}"]
            h = act(h @ quant_w(p["w"]) + p["b"], f"fc{i}")
        p = params[f"fc{n_hidden}"]
        return h @ quant_w(p["w"]) + p["b"]

    h = x
    for i in range(len(cfg.conv_channels)):
        p = params[f"conv{i}"]
        w = quant_w(p["w"]).permute(3, 2, 0, 1)                 # HWIO -> OIHW
        z = F.conv2d(h.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
        h = act(z + p["b"], f"conv{i}")
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    h = h.reshape(h.shape[0], -1)
    p = params["fc_out"]
    return h @ quant_w(p["w"]) + p["b"]


# ---------------------------------------------------------------------------
# GRAU replacement (paper §II-A steps 2-4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IntGRAUAct:
    """The integer path of one layer: a = round(z / s_in) (saturating to
    int32), the GRAU unit on a (kernels.ops.grau: the CUDA kernel for a
    CUDA tensor, its plain version for a CPU tensor), the 8-bit bus times
    s_out."""
    spec: GRAUSpec
    s_in: float
    s_out: float
    unit: Callable[[torch.Tensor, GRAUSpec], torch.Tensor] = ops.grau

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        a = round_to_int32(z / self.s_in)
        return (self.unit(a, self.spec).to(torch.float32)
                * self.s_out).to(z.dtype)


@dataclasses.dataclass(frozen=True)
class PWLAct:
    """The paper's PWLF row: the float piecewise-linear fit, rounded."""
    pwl: PWLFunction
    s_in: float
    s_out: float

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        a = z / self.s_in
        return (torch.round(self.pwl(a)) * self.s_out).to(z.dtype)


def make_grau_acts(cfg: VisionConfig, ranges: Dict[str, List[float]], *,
                   mode: str, segments: int, num_exponents: int,
                   out_bits: Optional[int] = None, bias_mode: str = "anchor",
                   unit: Callable = ops.grau) -> Dict[str, Callable]:
    """One GRAU unit per activation layer from recorded MAC ranges.

    mode: "pwlf" evaluates the float PWL fit (the paper's PWLF row);
    "pot"/"apot" run the bit-exact integer datapath through `unit`
    (default: kernels.ops.grau)."""
    out_bits = out_bits or cfg.act_bits
    f = ACTIVATIONS[cfg.activation]
    impls: Dict[str, Callable] = {}
    for lname, (lo, hi) in ranges.items():
        absmax = max(abs(lo), abs(hi), 1e-3)
        s_in = absmax / 8192.0          # MAC integer domain ~±8k
        ys = f(np.linspace(-absmax, absmax, 4097))
        s_out = (max(float(np.max(np.abs(ys))), 1e-6)
                 / ((1 << (out_bits - 1)) - 1))
        folded = fold(cfg.activation, s_in=s_in, s_out=s_out,
                      out_bits=out_bits)
        res = build_grau(folded, mac_range=(-absmax / s_in, absmax / s_in),
                         segments=segments, num_exponents=num_exponents,
                         mode=("apot" if mode == "pwlf" else mode),
                         bias_mode=bias_mode)
        impls[lname] = (PWLAct(res.pwl, s_in, s_out) if mode == "pwlf" else
                        IntGRAUAct(res.spec, s_in, s_out, unit))
    return impls


# ---------------------------------------------------------------------------
# Train/eval harness
# ---------------------------------------------------------------------------

def train_vision(cfg: VisionConfig, *, steps: int = 600, batch: int = 128,
                 lr: float = 0.05, seed: int = 0, device=None):
    """Plain SGD through torch autograd (the STE of fake_quant) on blob
    images; returns (params, pipeline). Runs on `device` (default: CUDA,
    see models/lm.resolve_device)."""
    from repro_torch.data.pipeline import ImagePipeline

    device = resolve_device(device)
    pipe = ImagePipeline(num_classes=cfg.num_classes, hw=cfg.hw,
                         channels=cfg.channels, global_batch=batch, seed=seed,
                         device=str(device))
    params = init_vision(cfg, seed, device=device)
    leaves = [t for p in params.values() for t in p.values()]
    for t in leaves:
        t.requires_grad_(True)
    for s in range(steps):
        b = pipe.batch(s)
        logits = apply_vision(params, cfg, b["image"])
        loss = F.cross_entropy(logits, b["label"])
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.sub_(lr * g)
    for t in leaves:
        t.requires_grad_(False)
    return params, pipe


@torch.no_grad()
def eval_vision(params, cfg: VisionConfig, pipe, *, act_impls=None,
                ranges=None, steps: int = 8, offset: int = 10_000) -> float:
    correct = total = 0
    for s in range(steps):
        b = pipe.batch(offset + s)
        logits = apply_vision(params, cfg, b["image"], act_impls=act_impls,
                              ranges=ranges)
        pred = torch.argmax(logits, -1)
        correct += int((pred == b["label"]).sum())
        total += int(b["label"].shape[0])
    return correct / total
