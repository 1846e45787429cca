"""PyTorch port vs the JAX reference: elastic re-sharding of training
(train/elasticity.py, launch/steps.param_placement, ckpt/checkpoint.py's
sharded checkpoints).

  * reshard_plan's shard shape of every leaf, and a rank's parameter bytes,
    at (1, 2), (2, 1), (2, 2) and (4, 1) equal the shards of the
    reference's param_pspecs(cfg, mesh, fsdp=True), on llama3-, gemma- and
    llava-smoke. The leaves are matched through convert.from_reference's
    path map; the reference is called with a stand-in mesh holding only
    `axis_names` and `devices`, all that param_pspecs, data_axes and
    validate_transition read.
  * A checkpoint saved at (2, 2) (each rank writes its pieces) restores at
    (1, 2), (2, 1), (4, 1) and unsharded to the same whole tree, bit for
    bit; one step after restoring at (1, 2) is within 1e-5 of the step
    continued at (2, 2).
  * validate_transition's verdicts equal the reference's on pairs that keep
    and that change the model axis.

The port's ranks are gloo processes on the CPU (tests/torch_train_ranks.py),
one spawn a mesh shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_train_ranks as T  # noqa: E402
from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.train import elasticity as jel  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.nn.common import tree_flatten, tree_map  # noqa: E402
from repro_torch.train import elasticity as tel  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

JOIN_S = 240.0
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "4x1": (4, 1)}
ARCHS = ["llama3.2-3b", "gemma-7b", "llava-next-mistral-7b"]
OPT = dict(peak_lr=3e-3, warmup_steps=1, total_steps=4)


class StandIn:
    """A reference mesh's shape: its axis names and a devices array."""

    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.devices = np.empty((data, model), dtype=object)


def _shard(shape, spec, sizes):
    out = list(shape)
    for i, axes in enumerate(tuple(spec) + (None,) * (len(shape)
                                                      - len(spec))):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            out[i] //= sizes[a]
    return tuple(out)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_reshard_plan_shards_match_the_references(arch, mesh):
    d, m = MESHES[mesh]
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    stand = StandIn(d, m)
    shapes, specs = jsteps.param_pspecs(jcfg, stand, fsdp=True,
                                        dtype=jnp.bfloat16)
    sizes = dict(zip(stand.axis_names, stand.devices.shape))
    is_leaf = (lambda x: hasattr(x, "shape") and hasattr(x, "dtype"))
    import jax
    want = jax.tree.map(lambda s, p: np.empty(_shard(s.shape, p, sizes),
                                              np.float32),
                        shapes, specs, is_leaf=is_leaf)
    want = {path: tuple(t.shape) for path, t in tree_flatten(
        from_reference(want, tcfg, device="cpu"))}
    global_shapes, placement = tel.reshard_plan(tcfg, (d, m))
    got = {p: tuple(x.shape) for p, x in tree_flatten(
        tel.shard_shapes(global_shapes, placement, (d, m)))}
    assert got == want
    assert all(x.dtype == torch.bfloat16 and x.device.type == "meta"
               for _, x in tree_flatten(global_shapes))
    ref_bytes = sum(int(np.prod(_shard(s.shape, p, sizes))) * s.dtype.itemsize
                    for s, p in zip(jax.tree.leaves(shapes, is_leaf=is_leaf),
                                    jax.tree.leaves(specs, is_leaf=lambda x:
                                                    type(x).__name__
                                                    == "PartitionSpec")))
    assert sum(int(np.prod(s)) * 2 for s in got.values()) == ref_bytes


@pytest.mark.parametrize("old,new", [((2, 2), (1, 2)), ((1, 2), (2, 2)),
                                     ((2, 2), (4, 1)), ((2, 1), (1, 2)),
                                     ((4, 1), (2, 1)), ((1, 2), (1, 4))])
def test_validate_transition_gives_the_references_verdicts(old, new):
    want = jel.validate_transition(StandIn(*old), StandIn(*new))
    assert tel.validate_transition(old, new) == want


def _batches(vocab, n, b=4, s=24):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, size=(b, s + 1))
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """A (2, 2) run saves its state after one step and takes a second; the
    checkpoint is restored at (1, 2) (which takes the second step too),
    (2, 1) and (4, 1)."""
    cfg = tget_config("llama3.2-3b", smoke=True)
    params = tlm.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    batches = _batches(cfg.vocab_size, 2)
    d = str(tmp_path_factory.mktemp("elastic"))
    out = {"cfg": cfg, "params": params, "dir": d}
    out["2x2"] = tmesh.spawn_ranks(T.run, 4, args=((2, 2), [(
        "run", "save_then_step", dict(cfg=cfg, params=params,
                                      batches=batches, opt_kw=OPT,
                                      ckpt_dir=d))]), join_s=JOIN_S,
        threads=1)[0]["run"]
    for key in ("1x2", "2x1", "4x1"):
        shape = MESHES[key]
        out[key] = tmesh.spawn_ranks(T.run, shape[0] * shape[1], args=(
            shape, [("run", "restore_then_step", dict(
                cfg=cfg, params=params, batch=batches[1], opt_kw=OPT,
                ckpt_dir=d, step_n=1, total=2))]), join_s=JOIN_S,
            threads=1)[0]["run"]
    return out


def _same(a, b):
    fa, fb = tree_flatten(a), tree_flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("target", ["1x2", "2x1", "4x1", "1x1"])
def test_checkpoint_saved_at_2x2_restores_bit_for_bit(elastic, target):
    saved = elastic["2x2"]["state"]
    man = ckpt.read_manifest(elastic["dir"], 1)
    assert man["mesh"] == {"data": 2, "model": 2} and man["host_count"] == 4
    if target == "1x1":
        like = {"params": tree_map(torch.zeros_like, elastic["params"])}
        like["opt"] = toptim.init_opt_state(like["params"])
        got = ckpt.restore(elastic["dir"], 1, like)
    else:
        got = elastic[target]["state"]
    _same(got, saved)


def test_a_step_after_restoring_at_1x2_continues_the_2x2_run(elastic):
    want = elastic["2x2"]["next_loss"]
    assert abs(elastic["1x2"]["next_loss"] - want) <= 1e-5 * abs(want)
