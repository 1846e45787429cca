"""Multi-pod dry run: count every (arch x shape x mesh) cell on the meta
device (the JAX package's launch/dryrun.py).

For each cell: launch/steps.build_cell builds one rank's shard of the
step on the production mesh's stand-in (a shard_ctx.CountMesh: no
processes, no device memory), and roofline/count.py counts the step as it
runs on meta tensors — its products' FLOPs, the bytes it reads and
writes, the collectives the rank issues (recorded, not issued) and the
kernel launches — into <out>/<arch>__<shape>__<mesh>.json with the
rank's memory (parameters, AdamW moments, caches, batch rows) and the
roofline against the H100's peaks (roofline/analyze.py). `build_s` and
`count_s` stand where the reference has lower_s and compile_s.

The production meshes: "single" is (data 16, model 16); "multi" is two
pods of it, (pod 2, data 16, model 16), whose pod and data axes together
are one data axis of 32 (the reference's launch/mesh.data_axes).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

Each cell prints one line: OK, SKIP (configs/shapes.cell_status), NOT
PORTED (a cell or feature the port lacks, with its ROADMAP item) or FAIL;
the sweep exits non-zero only on FAIL.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
from typing import Optional

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")
MESHES = {"single": (16, 16), "multi": (2 * 16, 16)}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides: Optional[dict] = None, tag: str = "",
             out_dir: Optional[pathlib.Path] = None) -> dict:
    """Build and count one cell; write and return its record."""
    from repro_torch.configs.archs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import steps as steps_lib
    from repro_torch.roofline.analyze import roofline_terms
    from repro_torch.roofline.count import count

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    data, model = MESHES[mesh_name]
    t0 = time.perf_counter()
    bundle = steps_lib.build_cell(cfg, shape, (data, model),
                                  **(overrides or {}))
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    with count() as t:
        bundle.fn(*bundle.args)
    t_count = time.perf_counter() - t0
    chips = data * model
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mesh_shape": {"pod": 2, "data": 16, "model": model} if multi_pod
        else {"data": data, "model": model},
        "tag": tag,
        "chips": chips,
        "build_s": t_build,
        "count_s": t_count,
        "flops": t.flops,
        "bytes_accessed": t.bytes,
        "collective_bytes": t.collective,
        "dot_bytes": t.dot_bytes,
        "collective_by_op": t.collective_by_op,
        "ops_by_kind": t.ops_by_kind,
        "launches": t.launches,
        "memory": dict(bundle.memory),
        "roofline": roofline_terms(flops=t.flops, bytes_accessed=t.bytes,
                                   collective_bytes=t.collective,
                                   chips=chips, ops_by_kind=t.ops_by_kind),
    }
    out_dir = pathlib.Path(out_dir) if out_dir is not None else OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    out = out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    out.write_text(json.dumps(record, indent=2))
    return record


def main(argv=None) -> None:
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.shapes import SHAPES, cell_status
    from repro_torch.launch.steps import NotPorted

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full",
                    choices=["dots", "full", "none"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--pad-heads", action="store_true",
                    help="kept for the reference's CLI: the port always "
                         "pads heads to the model axis")
    ap.add_argument("--ep-full", action="store_true",
                    help="serving EP: experts sharded over all mesh axes "
                         "(not ported)")
    ap.add_argument("--mla-cache-shard", action="store_true",
                    help="shard MLA latent cache seq axis over model "
                         "(not ported)")
    ap.add_argument("--out", default=None,
                    help=f"output directory (default {OUT_DIR})")
    args = ap.parse_args(argv)

    overrides = {
        "remat": None if args.remat == "none" else args.remat,
        "fsdp": not args.no_fsdp,
        "microbatches": args.microbatches,
        "pad_heads": args.pad_heads,
        "ep_full": args.ep_full,
        "mla_cache_shard": args.mla_cache_shard,
    }
    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = (list(SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch} x {shape} x {'multi' if mp else 'single'}"
                status = cell_status(arch, shape)
                if status is not None:
                    print(f"SKIP  {label}: {status}", flush=True)
                    continue
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   overrides=overrides, tag=args.tag,
                                   out_dir=args.out)
                except NotPorted as e:
                    print(f"NOT PORTED  {label}: {e}", flush=True)
                    continue
                except Exception as e:  # noqa: BLE001 — report, keep sweeping
                    failures += 1
                    print(f"FAIL  {label}: {type(e).__name__}: {e}",
                          flush=True)
                    traceback.print_exc()
                    continue
                r = rec["roofline"]
                print(f"OK    {label}: build={rec['build_s']:.2f}s "
                      f"count={rec['count_s']:.2f}s "
                      f"flops={rec['flops']:.3e} "
                      f"bytes={rec['bytes_accessed']:.3e} "
                      f"coll={rec['collective_bytes']:.3e} "
                      f"dominant={r['dominant']}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
