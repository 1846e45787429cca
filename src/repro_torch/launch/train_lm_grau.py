"""End-to-end example (the JAX package's examples/train_lm_grau.py): train an
LM whose MLP activations run through the GRAU QAT surrogate (the exact
integer PWL shift-add function, straight-through gradients), with
checkpoint/auto-resume, then compare against the float-activation baseline.

Default: the CPU-sized (smoke) model for a few hundred steps; the same
flow at full width is launch/train.py --grau. Usage:

    PYTHONPATH=src python -m repro_torch.launch.train_lm_grau [--steps 300] \
        [--device cpu]
"""
from __future__ import annotations

import argparse


def train_one(cfg, steps, tag, device, ckpt_dir=None):
    import torch

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import make_lm_batch_for
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.train import optim
    from repro_torch.train.loop import LoopConfig, run

    shape = ShapeSpec("host", 128, 16, "train")
    opt_cfg = optim.AdamWConfig(peak_lr=3e-3, warmup_steps=10,
                                total_steps=steps)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg, remat=None,
                                        q_chunk=64, kv_chunk=64)
    params = lm.init_lm(cfg, seed=0, dtype=torch.float32, device=device)
    opt_state = optim.init_opt_state(params)
    _, _, hist = run(
        train_step=step_fn, params=params, opt_state=opt_state,
        batch_fn=lambda s: make_lm_batch_for(cfg, shape, s, device=device),
        loop=LoopConfig(total_steps=steps, ckpt_every=100, ckpt_dir=ckpt_dir,
                        log_every=50),
    )
    print(f"[{tag}] loss {hist['losses'][0]:.3f} -> {hist['losses'][-1]:.3f}")
    return hist["losses"][-1]


def main(argv=None):
    from repro_torch.configs.archs import get_config
    from repro_torch.models.config import GRAUConfig
    from repro_torch.models.lm import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    base_cfg = get_config(args.arch, smoke=True)
    grau_cfg = base_cfg.replace(grau=GRAUConfig(mode="apot", segments=6,
                                                num_exponents=8))
    l_float = train_one(base_cfg, args.steps, "float-act", device)
    l_grau = train_one(grau_cfg, args.steps, "grau-apot", device,
                       args.ckpt_dir)
    print(f"GRAU-QAT degradation vs float activation: "
          f"{l_grau - l_float:+.4f} nats (paper: small for ReLU-dominant, "
          f"larger for SiLU at low segment counts)")
    return l_float, l_grau


if __name__ == "__main__":
    main()
