"""Checkpointing: a torch.save tensor store, atomic manifests, keep-k GC,
resume, and sharded checkpoints of a training mesh that restore onto
another mesh shape (the JAX package's ckpt/checkpoint.py, with its
directory protocol and its multi-host layout).

Layout (one directory per step):
    <dir>/step_000123/
        shard_00000.pt          # torch.save of a flat {path: tensor}
        shard_00001.pt          # ... one a rank under a mesh: its pieces
        MANIFEST.json           # written LAST -> atomic commit marker
    <dir>/LATEST                # text file: last committed step

Fault-tolerance contract:
  * a checkpoint is valid iff MANIFEST.json exists (writes are staged to a
    .tmp directory and renamed, so a killed writer never leaves a half
    checkpoint that `latest_step` would pick up);
  * `restore` rejects a shape mismatch and places each tensor on the
    template leaf's device, in its dtype.

Under a (data, model) training mesh (`save(mesh=, placement=)`) each rank
writes shard_{rank:05d}.pt with the pieces it holds — a piece replicated
over an axis only by that axis' rank 0 — and, after a barrier, global rank
0 writes MANIFEST.json (the mesh shape, and each leaf's global shape and
the axes cut over `model` and `data`), renames the directory and commits
LATEST; a second barrier lets no rank read ahead of the commit.
`restore(mesh=)` stitches each leaf whole from the old pieces and cuts
this rank's new shard from it, so a checkpoint saved at one mesh shape
restores at any other (or unsharded, mesh None) bit for bit. Without a mesh (and at (1, 1)) the checkpoint is
the single-shard format, which restores onto a mesh too.

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


def _shard_name(rank: int) -> str:
    return f"shard_{rank:05d}.pt"


def _mesh_of(mesh):
    """(data, model, this rank's data index, model index, global rank), or
    None without a mesh or on a (1, 1) mesh."""
    if mesh is None:
        return None
    from repro_torch.launch.mesh import global_rank
    from repro_torch.nn import shard_ctx
    nd, nm = shard_ctx.data_size(mesh), shard_ctx.model_size(mesh)
    if nd * nm == 1:
        return None
    return (nd, nm, shard_ctx.data_rank(mesh), shard_ctx.model_rank(mesh),
            global_rank(mesh))


def save(ckpt_dir, step: int, tree, *, keep: int = 3,
         extra: Optional[dict] = None, mesh=None,
         placement=None) -> pathlib.Path:
    """Commit `tree` as step `step`. Under a training mesh `tree` is this
    rank's shard and `placement` its train/fsdp.Cut tree (shaped as `tree`;
    launch/steps.state_placement for {"params", "opt"}): every rank of the
    mesh calls save."""
    root = pathlib.Path(ckpt_dir)
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}"
    where = _mesh_of(mesh)
    lead = where is None or where[4] == 0
    if lead:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    flat = dict(tree_flatten(tree))
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat),
        "host_count": 1,
        "extra": extra or {},
    }
    if where is None:
        torch.save({k: v.detach().cpu().contiguous()
                    for k, v in flat.items()}, tmp / SHARD)
    else:
        nd, nm, d, r, g = where
        _barrier(mesh)                        # the staging directory exists
        cuts = dict(tree_flatten(placement))
        mine = {}
        for k, v in flat.items():
            c = cuts[k]
            if (c.model is None and r) or (c.data is None and d):
                continue                      # rank 0 of the axis writes it
            mine[k] = v.detach().cpu().contiguous()
        torch.save(mine, tmp / _shard_name(g))
        manifest["host_count"] = nd * nm
        manifest["mesh"] = {"data": nd, "model": nm}
        manifest["leaves"] = {k: {
            "shape": _global_shape(v, cuts[k], nd, nm),
            "model": cuts[k].model, "data": cuts[k].data}
            for k, v in flat.items()}
        _barrier(mesh)                        # every shard is written
    if lead:
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                # atomic commit
        (root / "LATEST").write_text(str(step))
        _gc(root, keep)
    if where is not None:
        _barrier(mesh)                        # nobody reads ahead of it
    return final


def _barrier(mesh) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import host_group
    dist.barrier(group=host_group(mesh))


def _global_shape(v: torch.Tensor, cut, nd: int, nm: int):
    shape = list(v.shape)
    for axis, n in ((cut.model, nm), (cut.data, nd)):
        if axis is not None:
            shape[axis] *= n
    return shape


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


def restore(ckpt_dir, step: int, like_tree, *, mesh=None, placement=None):
    """Restore into the structure of `like_tree`; each tensor lands on its
    template leaf's device, in its dtype. Without `mesh` the template is
    the whole tree; with it, this rank's shard of a training mesh and
    `placement` its train/fsdp.Cut tree. Either way the checkpoint may
    have been written at any mesh shape: each leaf is stitched whole from
    its pieces, then cut to this rank's range. Shapes must match."""
    root = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    man = json.loads((root / "MANIFEST.json").read_text())
    where = _mesh_of(mesh)
    flat_like = tree_flatten(like_tree)
    if "mesh" not in man and where is None:
        payload = load_flat(ckpt_dir, step)
        for key, like in flat_like:
            _check(key, payload[key].shape, like.shape)
        keys = iter(k for k, _ in flat_like)
        return tree_map(lambda like: payload[next(keys)].to(like.device,
                                                            like.dtype),
                        like_tree)
    src = _Pieces(root, man)
    if where is None:
        out = [src.piece(key, like, None, (0, 0), (1, 1))
               for key, like in flat_like]
    else:
        nd, nm, d, r, _ = where
        cuts = dict(tree_flatten(placement))
        out = [src.piece(key, like, cuts[key], (d, r), (nd, nm))
               for key, like in flat_like]
    it = iter(out)
    return tree_map(lambda _: next(it), like_tree)


def _check(key, got, want) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"shape mismatch for {key}: {list(got)} vs "
                         f"{list(want)}")


class _Pieces:
    """A committed checkpoint's pieces, read lazily (each shard file
    memory-mapped once): a leaf is stitched whole from the pieces its
    writers hold, then cut to a rank's new shard."""

    def __init__(self, root: pathlib.Path, man: dict):
        self.root, self.files = root, {}
        mesh = man.get("mesh", {"data": 1, "model": 1})
        self.nd, self.nm = mesh["data"], mesh["model"]
        self.leaves = man.get("leaves")

    def file(self, rank: int) -> Dict[str, torch.Tensor]:
        if rank not in self.files:
            self.files[rank] = torch.load(
                self.root / _shard_name(rank), map_location="cpu",
                weights_only=True, mmap=True)
        return self.files[rank]

    def whole(self, key: str) -> torch.Tensor:
        """Leaf `key` whole: its writers' pieces (a piece replicated over
        an axis written by that axis' rank 0) concatenated along the axis
        each is cut on, in rank order."""
        if self.leaves is None:               # the single-shard format
            return self.file(0)[key]
        info = self.leaves[key]
        ma, da = info["model"], info["data"]
        rows = []
        for d in range(self.nd if da is not None else 1):
            parts = [self.file(d * self.nm + r)[key]
                     for r in range(self.nm if ma is not None else 1)]
            rows.append(torch.cat(parts, ma) if len(parts) > 1 else parts[0])
        out = torch.cat(rows, da) if len(rows) > 1 else rows[0]
        _check(key, out.shape, info["shape"])
        return out

    def piece(self, key: str, like: torch.Tensor, cut, coords,
              sizes) -> torch.Tensor:
        """The range of leaf `key` that the rank at `coords` (data, model)
        of a mesh of `sizes` holds under `cut` (None: the whole leaf), on
        `like`'s device, in its dtype, a tensor of its own."""
        from repro_torch.train.fsdp import local_piece
        out = self.whole(key)
        if cut is not None:
            out = local_piece(out, cut, coords, sizes)
        _check(key, out.shape, like.shape)
        return out.to(like.device, like.dtype, copy=True)


def read_manifest(ckpt_dir, step: int) -> dict:
    p = pathlib.Path(ckpt_dir) / f"step_{step:08d}" / "MANIFEST.json"
    return json.loads(p.read_text())
