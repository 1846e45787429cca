"""Elastic scaling: re-shard a training checkpoint onto a different mesh
(the JAX package's train/elasticity.py).

A run that loses ranks, or gains them, restarts on a new (data, model)
mesh:

  1. the new mesh's shape is chosen (keeping `model` keeps the tensor-
     parallel layout; validate_transition says whether it is kept);
  2. `reshard_plan` gives every parameter's global shape and its placement
     on the new mesh (launch/steps.param_placement: pure metadata, from
     the leaves' logical axes);
  3. ckpt/checkpoint.restore(mesh=, placement=) builds each new rank's
     shard from the pieces the old ranks wrote, bit for bit;
  4. the data pipeline seeks to the checkpoint's step (a pure function of
     the step); the global batch is kept, so a data rank's rows grow or
     shrink with the data axis (launch/steps.data_rows).

Where the shrunken mesh would not hold a rank's activations, more
`microbatches` (launch/steps.make_train_step) keep the global batch: the
arithmetic is the same, only the step time changes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.nn.common import tree_map
from repro_torch.train.fsdp import local_piece


def reshard_plan(cfg: ModelConfig, new_mesh, *, fsdp: bool = True,
                 dtype=torch.bfloat16):
    """(shapes, placement) of the parameters on `new_mesh` (a DeviceMesh or
    a (data, model) pair): each leaf whole, as a tensor on the meta device
    (its shape and dtype, at train_config's padded heads), and its Cut."""
    shapes = lm.init_lm(steps_lib.train_config(cfg, new_mesh), dtype=dtype,
                        device="meta")
    return shapes, steps_lib.param_placement(cfg, new_mesh, fsdp=fsdp)


def shard_shapes(shapes, placement, mesh):
    """Each leaf as every rank of `mesh` holds it under `placement` (meta
    tensors)."""
    sizes = steps_lib.mesh_shape(mesh)
    return tree_map(lambda x, c: local_piece(x, c, (0, 0), sizes), shapes,
                    placement)


def _model(mesh) -> int:
    return steps_lib.mesh_shape(mesh)[1]


def validate_transition(old_mesh, new_mesh) -> Tuple[bool, str]:
    """A transition is safe if the model axis is unchanged (the tensor-
    parallel layout is kept); the data axes still divide the global batch
    upstream (launch/steps.data_rows raises where they do not)."""
    old, new = _model(old_mesh), _model(new_mesh)
    if old != new:
        return False, (f"model axis changed {old} -> {new}; requires weight "
                       f"re-layout (supported, but costs a full re-shard "
                       f"pass)")
    return True, "ok"
