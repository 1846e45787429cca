"""PyTorch port vs the JAX reference: training over a (data, model) mesh —
tensor parallelism over `model`, FSDP and the batch's rows over `data`
(launch/steps.make_train_step(mesh=), train/fsdp.py) — against the
reference's unsharded make_train_step.

The port runs one process a rank (launch/mesh.spawn_ranks, gloo on the
CPU): one spawn a mesh shape, every job of the file run by it
(tests/torch_train_ranks.py); the reference runs unsharded in this process,
once for the module. f32 at smoke size, from the reference's
init_lm(PRNGKey(0)) converted by from_reference:

  * at (1, 2), (2, 1) and (2, 2): the loss within 1e-5 relative and every
    gathered gradient leaf within a relative L2 of 1e-4 (1e-3 with GRAU, as
    tests/test_torch_train.py) of the reference's, on llama3-smoke with GRAU
    off and on, gemma-smoke and llava-smoke (its patch-embedding prefix);
  * three steps at (2, 2) against the reference's three, the clip active at
    the first (its scale below 1): the losses within 1e-4 and the
    parameters within a relative L2 of 1e-4;
  * microbatches 2 at (2, 1) against the reference's microbatches 2;
  * remat "full" and "dots" at (1, 2) give remat None's bits, and at
    (2, 2) every remat gives the same bits with the backward on another
    thread (as autograd runs a CUDA backward);
  * MoE, MLA, Mamba-2 and encoder-decoder archs raise the named error.

Every process group has a 60 s collective timeout and every spawn a join
deadline, so a divergence fails its test instead of hanging the suite.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_train_ranks as T  # noqa: E402
from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.configs.shapes import ShapeSpec  # noqa: E402
from repro.data.pipeline import make_lm_batch_for  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import GRAUConfig as JGRAUConfig  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.config import GRAUConfig as TGRAUConfig  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.nn.common import tree_flatten  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

CHUNK = 16
JOIN_S = 240.0
SHAPES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
CASES = {"llama3": ("llama3.2-3b", False), "llama3_grau": ("llama3.2-3b", True),
         "gemma": ("gemma-7b", False), "llava": ("llava-next-mistral-7b", False)}
OPT = dict(peak_lr=3e-3, warmup_steps=1, total_steps=3)
UNSUPPORTED = ["llama4-maverick-400b-a17b", "deepseek-v3-671b", "mamba2-1.3b",
               "whisper-medium"]


def _configs(arch, grau):
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    if grau:
        jcfg = jcfg.replace(grau=JGRAUConfig(mode="apot", segments=6,
                                             num_exponents=8))
        tcfg = tcfg.replace(grau=TGRAUConfig(mode="apot", segments=6,
                                             num_exponents=8))
    return jcfg, tcfg


def _batch(jcfg, step, b=4, s=24):
    """The reference's make_lm_batch_for batch (LLaVA's patch embeddings
    too) in f32, as numpy."""
    out = make_lm_batch_for(jcfg, ShapeSpec("t", s, b, "train"), step,
                            dtype=jnp.float32)
    return {k: np.array(v) for k, v in out.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def reference():
    """The reference's unsharded loss and gradients per case, its 3-step
    trajectory and its microbatched step; and the port's parameter trees
    and the batches the ranks take."""
    out = {"cases": {}}
    for name, (arch, grau) in CASES.items():
        jcfg, tcfg = _configs(arch, grau)
        jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        batch = _batch(jcfg, 0)
        act = jlm.make_act(jcfg)
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(
            p, jcfg, b, act=act, q_chunk=CHUNK, kv_chunk=CHUNK)))(
                jp, _j(batch))
        if name == "llama3_grau":       # the steps' start
            out.update(jp=jp, jcfg=jcfg, tcfg=tcfg)
        out["cases"][name] = dict(
            tcfg=tcfg, params=from_reference(jp, tcfg, device="cpu"),
            batch=batch, loss=float(loss),
            grads=dict(tree_flatten(from_reference(grads, tcfg,
                                                   device="cpu"))))
    jp, jcfg, tcfg = out.pop("jp"), out["jcfg"], out["tcfg"]
    out["params"] = out["cases"]["llama3_grau"]["params"]
    out["batches"] = [_batch(jcfg, 10 + i) for i in range(3)]
    for key, mb, n in (("trajectory", 1, 3), ("microbatches", 2, 1)):
        step = jax.jit(jsteps.make_train_step(
            jcfg, joptim.AdamWConfig(**OPT), remat=None, q_chunk=CHUNK,
            kv_chunk=CHUNK, microbatches=mb))
        p, s, losses, norms = jp, joptim.init_opt_state(jp), [], []
        for b in out["batches"][:n]:
            p, s, m = step(p, s, _j(b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[key] = dict(losses=losses, grad_norms=norms, params=dict(
            tree_flatten(from_reference(p, tcfg, device="cpu"))))
    return out


def _work(ref, shape):
    work = [(f"grads_{n}", "grads", dict(cfg=c["tcfg"], params=c["params"],
                                          batch=c["batch"], chunk=CHUNK))
            for n, c in ref["cases"].items()]
    base = dict(cfg=ref["tcfg"], params=ref["params"], opt_kw=OPT,
                chunk=CHUNK)
    if shape == (2, 2):
        work.append(("trajectory", "train", dict(
            base, batches=ref["batches"])))
        c = ref["cases"]["llama3_grau"]
        work.append(("thread_bits", "thread_bits", dict(
            cfg=c["tcfg"], params=c["params"], batch=c["batch"],
            chunk=CHUNK)))
    if shape == (2, 1):
        work.append(("microbatches", "train", dict(
            base, batches=ref["batches"][:1], microbatches=2)))
    if shape == (1, 2):
        c = ref["cases"]["llama3_grau"]
        work.append(("remat_bits", "remat_bits", dict(
            cfg=c["tcfg"], params=c["params"], batch=c["batch"],
            chunk=CHUNK)))
    return work


@pytest.fixture(scope="module")
def ranks(reference):
    """Each mesh shape's ranks' results, one spawn a shape."""
    return {key: tmesh.spawn_ranks(
        T.run, shape[0] * shape[1], args=(shape, _work(reference, shape)),
        join_s=JOIN_S, threads=1) for key, shape in SHAPES.items()}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_reference(reference, ranks, shape, case):
    ref = reference["cases"][case]
    got = [r[f"grads_{case}"] for r in ranks[shape]]
    assert len({g["loss"] for g in got}) == 1      # every rank, same bits
    loss = got[0]["loss"]
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    tol = 1e-3 if CASES[case][1] else 1e-4
    flat = tree_flatten(got[0]["grads"])
    assert sorted(p for p, _ in flat) == sorted(ref["grads"])
    for path, g in flat:
        want = ref["grads"][path]
        assert g.shape == want.shape and g.dtype == want.dtype, path
        err = _rel_l2(g.numpy(), want.numpy())
        assert err <= tol, f"{shape} {case} {path}: rel L2 {err:.3g}"


def _params_close(got, want, tol):
    for path, leaf in tree_flatten(got):
        err = _rel_l2(leaf.numpy(), want[path].numpy())
        assert err <= tol, f"{path}: rel L2 {err:.3g}"


def test_three_steps_at_2x2_follow_the_reference(reference, ranks):
    """The clip is active at the first step (the gradient's norm above
    clip_norm 1.0, so its scale is below 1), and every rank clips by the
    whole gradient's norm: the same trajectory as the reference's."""
    ref = reference["trajectory"]
    got = [r["trajectory"] for r in ranks["2x2"]]
    assert all(g["losses"] == got[0]["losses"] for g in got)
    assert all(g["grad_norms"] == got[0]["grad_norms"] for g in got)
    scale = toptim.AdamWConfig(**OPT).clip_norm / got[0]["grad_norms"][0]
    assert scale < 1.0
    for a, b in zip(got[0]["grad_norms"], ref["grad_norms"]):
        assert abs(a - b) <= 1e-4 * b
    for a, b in zip(got[0]["losses"], ref["losses"]):
        assert abs(a - b) <= 1e-4 * abs(b)
    _params_close(got[0]["params"], ref["params"], 1e-4)


def test_microbatches_at_2x1_follow_the_reference(reference, ranks):
    """Two microbatches at (2, 1): each data rank takes its share of each
    of the reference's microbatches (launch/steps.data_rows)."""
    ref = reference["microbatches"]
    got = ranks["2x1"][0]["microbatches"]
    assert abs(got["losses"][0] - ref["losses"][0]) <= 1e-5 * abs(
        ref["losses"][0])
    _params_close(got["params"], ref["params"], 1e-4)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_none_bits_at_1x2(ranks, remat):
    assert all(r["remat_bits"][remat] for r in ranks["1x2"])


@pytest.mark.parametrize("remat", ["None", "full", "dots"])
def test_backward_on_another_thread_gives_the_same_bits_at_2x2(ranks, remat):
    """Autograd runs a CUDA backward (and remat's recomputed forward) on a
    thread of its own: the collectives' Functions keep their groups, and
    the recomputed body runs under the forward's mesh context."""
    assert all(r["thread_bits"][remat] for r in ranks["2x2"])


def test_data_rows_take_each_microbatch_share():
    batch = {"tokens": torch.arange(8)[:, None].repeat(1, 3)}

    class Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, d):
            self.d = d

        def size(self, i):
            return (2, 1)[i]

        def get_local_rank(self, axis):
            return self.d if axis == "data" else 0
    rows = [tsteps.data_rows(batch, Mesh(d), microbatches=2)["tokens"][:, 0]
            for d in (0, 1)]
    assert rows[0].tolist() == [0, 1, 4, 5]
    assert rows[1].tolist() == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="microbatches"):
        tsteps.data_rows(batch, Mesh(0), microbatches=3)


@pytest.mark.parametrize("arch", UNSUPPORTED)
def test_unsupported_archs_raise_the_named_error(arch):
    cfg = tget_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tsteps.param_placement(cfg, (1, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tsteps.make_train_step(cfg, toptim.AdamWConfig(), mesh=(2, 1))
