"""Checkpointing: a torch.save tensor store, atomic manifests, keep-k GC,
resume (the JAX package's ckpt/checkpoint.py, with its directory protocol).

Layout (one directory per step):
    <dir>/step_000123/
        shard_00000.pt          # torch.save of a flat {path: tensor}
        MANIFEST.json           # written LAST -> atomic commit marker
    <dir>/LATEST                # text file: last committed step

Fault-tolerance contract:
  * a checkpoint is valid iff MANIFEST.json exists (writes are staged to a
    .tmp directory and renamed, so a killed writer never leaves a half
    checkpoint that `latest_step` would pick up);
  * `restore` rejects a shape mismatch and places each tensor on the
    template leaf's device, in its dtype.

The reference stores msgpack shards, which this port cannot read (and the
reference cannot read the port's): a checkpoint belongs to the package that
wrote it. Paths join dict keys, list indices and NamedTuple fields with "/"
(nn/common.tree_flatten), so a tree saves and restores by structure.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import time
from typing import Dict, Optional

import torch

from repro_torch.nn.common import tree_flatten, tree_map

SHARD = "shard_00000.pt"


def save(ckpt_dir, step: int, tree, *, keep: int = 3,
         extra: Optional[dict] = None) -> pathlib.Path:
    root = pathlib.Path(ckpt_dir)
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = dict(tree_flatten(tree))
    torch.save({k: v.detach().cpu().contiguous() for k, v in flat.items()},
               tmp / SHARD)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat),
        "host_count": 1,
        "extra": extra or {},
    }
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                    # atomic commit
    (root / "LATEST").write_text(str(step))
    _gc(root, keep)
    return final


def _gc(root: pathlib.Path, keep: int):
    steps = sorted(p for p in root.glob("step_*")
                   if (p / "MANIFEST.json").exists())
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    root = pathlib.Path(ckpt_dir)
    best = None
    for p in root.glob("step_*"):
        if (p / "MANIFEST.json").exists():       # only committed checkpoints
            s = int(p.name.split("_")[1])
            best = s if best is None else max(best, s)
    return best


def load_flat(ckpt_dir, step: int) -> Dict[str, torch.Tensor]:
    """A checkpoint's raw flat {path: tensor} on the CPU, without a
    template tree (for consumers that discover the contents from the
    checkpoint itself)."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}" / SHARD
    return torch.load(path, map_location="cpu", weights_only=True)


def restore(ckpt_dir, step: int, like_tree):
    """Restore into the structure of `like_tree` (shapes must match); each
    tensor lands on its template leaf's device, in its dtype."""
    payload = load_flat(ckpt_dir, step)
    flat_like = tree_flatten(like_tree)
    for key, like in flat_like:
        if tuple(payload[key].shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{list(payload[key].shape)} vs "
                             f"{list(like.shape)}")
    keys = iter(k for k, _ in flat_like)
    return tree_map(lambda like: payload[next(keys)].to(like.device,
                                                        like.dtype),
                    like_tree)


def read_manifest(ckpt_dir, step: int) -> dict:
    p = pathlib.Path(ckpt_dir) / f"step_{step:08d}" / "MANIFEST.json"
    return json.loads(p.read_text())
