"""Training launcher for the PyTorch port: the LM training loop (data ->
forward -> loss -> backward -> AdamW, with checkpoints and auto-resume) on
one device or over a (data, model) mesh, attention through the flash
kernel on the card.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --grau --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --device cpu --steps 20 --seq-len 128 --batch 8 \
      --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --device cpu --steps 2 --mesh 2x2

--smoke (the reference's --host) trains the reduced config in f32 without
rematerialisation, at --seq-len 128 and --batch 8 unless given. Without it
the full config trains in bf16 with remat "full" at sequence 4096 and batch
1: the train_4k cell's shape (configs/shapes.py) on one chip of its
256-chip mesh. --mesh DxM trains over a (data, model) mesh of D x M rank
processes (launch/mesh.spawn_ranks): tensor-parallel over the model axis,
FSDP over the data axis, each data rank on its share of the batch's rows
(launch/steps.make_train_step(mesh=)); the batch is the global one, so
--batch must split over D. Collectives run over nccl (default on CUDA, one
card a rank) or gloo (--dist-backend gloo: on the CPU, or ranks sharing a
card). Each rank draws only its shard (launch/steps.draw_train_shard);
global rank 0 alone logs, and the checkpoints are sharded (each rank
writes its pieces) and resume at any mesh shape. Weights are random, drawn
from --seed on the device. The device defaults to CUDA; without a card
pass --device cpu, which runs the kernels' plain torch versions.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    """Run the launcher; returns the run's losses (global rank 0's under a
    mesh: every rank's are the same bits)."""
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
    ap.add_argument("--mesh", default=None, metavar="M|DxM",
                    help="train over a (data, model) mesh of D x M rank "
                         "processes: tensor-parallel over the model axis, "
                         "FSDP and the batch's rows over the data axis")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default=None,
                    help="the mesh's collectives: nccl (default on CUDA, one "
                         "card a rank) or gloo (default on the CPU; on CUDA "
                         "when ranks share a card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mesh is None:
        hist = train(args)
    else:
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.models import lm
        data, model = mesh_lib.parse_mesh_spec(args.mesh)
        device = lm.resolve_device(args.device)
        backend = args.dist_backend or mesh_lib.default_backend(device)
        mesh_lib.check_mesh(data, model, device, backend)
        if data * model == 1:
            try:
                hist = train(args, mesh_lib.make_mesh(
                    data, model, device=device, backend=backend))
            finally:
                mesh_lib.release_mesh()
        else:
            hist = mesh_lib.spawn_ranks(
                _train_rank, data * model,
                args=(args, data, model, device, backend), device=device,
                backend=backend, join_s=None)[0]
    if hist["losses"]:
        print(f"final loss: {hist['losses'][-1]:.8g} "
              f"(first {hist['losses'][0]:.8g})")
    return hist["losses"]


def _train_rank(rank: int, args, data: int, model: int, device,
                backend: str):
    from repro_torch.launch import mesh as mesh_lib
    hist = train(args, mesh_lib.make_mesh(data, model, device=device,
                                          backend=backend))
    return {"losses": hist["losses"]}


def train(args, mesh=None) -> dict:
    """The training loop in this process (one rank of `mesh` when given:
    every rank runs this with the same arguments)."""
    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.shapes import SHAPES, ShapeSpec
    from repro_torch.data.pipeline import make_lm_batch_for
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import global_rank
    from repro_torch.models import lm
    from repro_torch.models.config import GRAUConfig
    from repro_torch.train import optim
    from repro_torch.train.loop import LoopConfig, run

    device = lm.resolve_device(args.device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
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
        q_chunk=chunk, kv_chunk=chunk, mesh=mesh)
    placement = None
    if mesh is None:
        params = lm.init_lm(cfg, seed=args.seed, dtype=dtype, device=device)
    else:
        params = steps_lib.draw_train_shard(cfg, mesh, args.seed, dtype,
                                            device)
        placement = steps_lib.param_placement(cfg, mesh)
    opt_state = optim.init_opt_state(params)
    where = "" if mesh is None else f", mesh {args.mesh}"
    log = print if global_rank(mesh) == 0 else (lambda _: None)
    log(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{dtype}, seq {shape.seq_len} x batch {shape.global_batch}, "
        f"remat {remat}, on {device}{where}")
    _, _, hist = run(
        train_step=step_fn, params=params, opt_state=opt_state,
        batch_fn=lambda s: make_lm_batch_for(cfg, shape, s, seed=args.seed,
                                             device=device),
        loop=LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir, log_every=1),
        mesh=mesh, placement=placement)
    return hist


if __name__ == "__main__":
    main()
