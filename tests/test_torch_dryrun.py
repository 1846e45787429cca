"""PyTorch port vs the JAX reference: the dry run's cells (configs/shapes,
launch/steps.build_cell, launch/dryrun.py).

  * cell_status and all_cells equal the reference's for every arch and
    shape;
  * a train cell's rank parameter bytes on the production meshes' stand-
    ins, (16, 16) and (2, 16, 16), equal the reference's param_pspecs
    shards (fsdp=True) for every arch whose heads divide the model axis;
    where they do not (llama3.2-3b's 24, qwen1.5-32b's 40), the port pads
    them (D8) and its bytes equal the reference's shards of the config
    padded the port's way; the archs whose train cell the port does not
    build raise NotPorted naming the ROADMAP item;
  * an unsharded smoke-size train step's counted FLOPs agree with the
    reference's analyze_hlo of jax.jit(make_train_step(...)) at the same
    remat, within a stated share;
  * the CLI writes a record with every key of the sweep's JSON.
"""
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.archs import ARCHS  # noqa: E402
from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.roofline.hlo import analyze_hlo  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.roofline import count as rcount  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402


class StandIn:
    """A reference mesh's shape: its axis names and a devices array."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


# the production meshes: (stand-in for the reference, the port's mesh)
MESHES = {"single": (StandIn(("data", "model"), (16, 16)), (16, 16)),
          "multi": (StandIn(("pod", "data", "model"), (2, 16, 16)),
                    (32, 16))}
# train cells the port does not build, and the ROADMAP item each names
NOT_PORTED = {"llama4-maverick-400b-a17b": "A11 item 5",
              "deepseek-v3-671b": "A11 item 5",
              "mamba2-1.3b": "A11 item 5", "jamba-v0.1-52b": "A11 item 5",
              "whisper-medium": "A11 item 5",
              "glm4-9b": "A13", "llava-next-mistral-7b": "A13"}


def test_cell_status_and_all_cells_match_reference():
    assert list(tshapes.all_cells()) == list(jshapes.all_cells())
    assert len(list(tshapes.all_cells())) == len(ARCHS) * 4 == 40
    for arch in ARCHS:
        for shape in jshapes.SHAPES:
            assert (tshapes.cell_status(arch, shape)
                    == jshapes.cell_status(arch, shape))
    assert {k: tuple(vars(v).values()) for k, v in tshapes.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jshapes.SHAPES.items()}


def _ref_bytes(jcfg, stand, fsdp=True, dtype=jnp.bfloat16) -> int:
    shapes, specs = jsteps.param_pspecs(jcfg, stand, fsdp=fsdp, dtype=dtype)
    sizes = dict(zip(stand.axis_names, stand.devices.shape))
    is_leaf = (lambda x: hasattr(x, "shape") and hasattr(x, "dtype"))
    total = 0
    for s, p in zip(jax.tree.leaves(shapes, is_leaf=is_leaf),
                    jax.tree.leaves(specs, is_leaf=lambda x: type(x).__name__
                                    == "PartitionSpec")):
        shape = list(s.shape)
        for i, axes in enumerate(tuple(p)):
            for a in ((axes if isinstance(axes, tuple) else (axes,))
                      if axes is not None else ()):
                shape[i] //= sizes[a]
        total += int(np.prod(shape)) * s.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_cell_rank_bytes_match_reference(arch, mesh):
    stand, pair = MESHES[mesh]
    tcfg = tget_config(arch)
    shape = tshapes.SHAPES["train_4k"]
    if arch in NOT_PORTED:
        with pytest.raises(tsteps.NotPorted, match=NOT_PORTED[arch]):
            tsteps.build_cell(tcfg, shape, pair)
        return
    bundle = tsteps.build_cell(tcfg, shape, pair)
    got = bundle.memory["param_bytes"]
    assert bundle.memory["moment_bytes"] == 2 * 2 * got   # f32 m and v
    assert bundle.memory["batch_bytes"] == 2 * 4 * 4096 * 256 // pair[0]
    jcfg = jget_config(arch)
    if jcfg.num_heads % 16 == 0:
        assert got == _ref_bytes(jcfg, stand)
        assert bundle.cfg.attn_pad is None
    else:
        # D8: the port pads the heads (h / kv x kvp, kvp) and shards them;
        # its bytes are the reference's shards of that padded config, and
        # below the unpadded reference's, which replicates the attention
        # over the model axis (its divisibility fallback)
        pad = bundle.cfg.attn_pad
        assert pad == (jcfg.num_heads // jcfg.num_kv_heads * pad[1], pad[1])
        assert pad[1] % 16 == 0
        assert got == _ref_bytes(jcfg.replace(attn_pad=pad), stand)
        assert got < _ref_bytes(jcfg, stand)


@pytest.mark.parametrize("fsdp", [True, False])
def test_train_cell_fsdp_flag(fsdp):
    """--no-fsdp: a rank's parameters are cut over model only, as the
    reference's param_pspecs(fsdp=False), and its step runs on them (no
    parameter all-gathered over data) and counts the same FLOPs."""
    cfg = tget_config("llama3.2-3b", smoke=True)
    shape = tshapes.ShapeSpec("t", 64, 4, "train")

    def counted(fsdp):
        bundle = tsteps.build_cell(cfg, shape, (2, 2), fsdp=fsdp,
                                   dtype=torch.float32)
        with rcount.count() as t:
            bundle.fn(*bundle.args)
        return bundle, t

    bundle, t = counted(fsdp)
    assert bundle.memory["param_bytes"] == _ref_bytes(
        jget_config("llama3.2-3b", smoke=True),
        StandIn(("data", "model"), (2, 2)), fsdp=fsdp, dtype=jnp.float32)
    assert t.flops > 0
    if not fsdp:
        _, sharded = counted(True)
        assert t.flops == sharded.flops
        assert (t.collective_by_op["all-gather"]
                < sharded.collective_by_op["all-gather"])


@pytest.mark.parametrize("remat", ["full", None])
def test_unsharded_train_step_flops_match_reference_hlo(remat):
    """The count of a meta train step (the card's route: the flash kernel's
    recorded cost) against the reference's HLO of the same step. They
    differ only in the attention: the reference's chunked scan computes
    every (q_chunk x kv_chunk) tile, masked positions included, and its
    autodiff keeps the scores (8 d a pair backward), where the port counts
    the causal pairs the flash kernel attends (4 d forward, 10 d
    backward). At this size (2 x 64 tokens, 2 tiles a side) that puts the
    port 3-5% under; the products outside the attention agree exactly."""
    b, s = 2, 64
    jcfg = jget_config("llama3.2-3b", smoke=True)
    tcfg = tget_config("llama3.2-3b", smoke=True)
    step = jsteps.make_train_step(jcfg, joptim.AdamWConfig(), remat=remat,
                                  q_chunk=32, kv_chunk=32)
    shapes, _ = jsteps.abstract_params(jcfg, jnp.float32)
    opt = jax.eval_shape(joptim.init_opt_state, shapes)
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32)
             for k in ("tokens", "labels")}
    want = analyze_hlo(jax.jit(step).lower(shapes, opt, batch).compile()
                       .as_text()).flops
    params = tlm.init_lm(tcfg, dtype=torch.float32, device="meta")
    tb = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    tstep = tsteps.make_train_step(tcfg, toptim.AdamWConfig(), remat=remat,
                                   q_chunk=32, kv_chunk=32)
    with rcount.count() as t:
        tstep(params, toptim.init_opt_state(params), tb)
    assert 0.95 <= t.flops / want <= 1.0
    # the attention's share of each count, from the shapes: the rest is
    # the same products
    from repro_torch.kernels.flash_attention import pairs
    L, h, d = tcfg.num_layers, tcfg.num_heads, tcfg.head_dim
    recompute = remat is not None
    port_attn = L * b * h * d * pairs(s, s, True) * (4 * (1 + recompute)
                                                      + 10)
    ref_attn = L * b * h * d * s * s * (4 * (1 + recompute) + 8)
    assert t.flops - port_attn == want - ref_attn
    assert t.launches == {"flash_attention": L * (1 + recompute)}


def test_dryrun_cli_writes_every_key(tmp_path, capsys):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-3b", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK    llama3.2-3b x decode_32k x single")
    rec = json.loads((tmp_path / "llama3.2-3b__decode_32k__single.json")
                     .read_text())
    for key in ("flops", "bytes_accessed", "collective_bytes", "dot_bytes",
                "collective_by_op", "memory", "roofline", "chips",
                "build_s", "count_s"):
        assert key in rec, key
    assert set(rec["memory"]) == {"param_bytes", "moment_bytes",
                                  "cache_bytes", "batch_bytes"}
    assert rec["chips"] == 256 and rec["flops"] > 0
    assert rec["roofline"]["dominant"] == "memory"
    assert set(rec["collective_by_op"]) == {"all-reduce", "all-gather"}
    # a cell the port lacks prints its own line and does not fail the
    # sweep (the same main, in this process)
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    assert capsys.readouterr().out.startswith("NOT PORTED")
