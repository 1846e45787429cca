"""Training launcher for the PyTorch port: the LM training loop (data ->
forward -> loss -> backward -> AdamW, with checkpoints and auto-resume) on
one device, attention through the flash kernel on the card.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --grau --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --device cpu --steps 20 --seq-len 128 --batch 8 \
      --ckpt-dir build/ckpt

--smoke (the reference's --host) trains the reduced config in f32 without
rematerialisation, at --seq-len 128 and --batch 8 unless given. Without it
the full config trains in bf16 with remat "full" at sequence 4096 and batch
1: the train_4k cell's shape (configs/shapes.py) on one chip of its
256-chip mesh (training's FSDP x TP mesh is not ported, ROADMAP A11; the
serving mesh is launch/mesh.py). Weights are random, drawn
from --seed on the device. The device defaults to CUDA; without a card pass
--device cpu, which runs the kernels' plain torch versions.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.shapes import SHAPES, ShapeSpec
    from repro_torch.data.pipeline import make_lm_batch_for
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.models.config import GRAUConfig
    from repro_torch.train import optim
    from repro_torch.train.loop import LoopConfig, run

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (the reference's --host)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default=None,
                    help="parameter dtype (default: float32 with --smoke, "
                         "else bfloat16)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grau", action="store_true",
                    help="train with the GRAU activation surrogate")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--remat", choices=["none", "full", "dots"], default=None,
                    help="default: none with --smoke, else full")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = lm.resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.grau:
        cfg = cfg.replace(grau=GRAUConfig())
    full = SHAPES["train_4k"]
    shape = ShapeSpec("smoke" if args.smoke else "train_4k_per_chip",
                      args.seq_len or (128 if args.smoke else full.seq_len),
                      args.batch or (8 if args.smoke else 1), "train")
    dtype = getattr(torch, args.dtype or ("float32" if args.smoke
                                          else "bfloat16"))
    remat = args.remat or ("none" if args.smoke else "full")

    opt_cfg = optim.AdamWConfig(peak_lr=args.lr, warmup_steps=5,
                                total_steps=args.steps)
    chunk = min(1024, shape.seq_len)
    step_fn = steps_lib.make_train_step(
        cfg, opt_cfg, remat=None if remat == "none" else remat,
        q_chunk=chunk, kv_chunk=chunk)
    params = lm.init_lm(cfg, seed=args.seed, dtype=dtype, device=device)
    opt_state = optim.init_opt_state(params)
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{dtype}, seq {shape.seq_len} x batch {shape.global_batch}, "
          f"remat {remat}, on {device}")
    _, _, hist = run(
        train_step=step_fn, params=params, opt_state=opt_state,
        batch_fn=lambda s: make_lm_batch_for(cfg, shape, s, seed=args.seed,
                                             device=device),
        loop=LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir, log_every=1))
    if hist["losses"]:
        print(f"final loss: {hist['losses'][-1]:.4f} "
              f"(first {hist['losses'][0]:.4f})")


if __name__ == "__main__":
    main()
