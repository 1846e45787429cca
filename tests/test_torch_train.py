"""PyTorch port vs the JAX reference: LM training (loss, gradients, AdamW,
the step, the loop, checkpoints, the token pipeline, the launchers).

Reference parameters come from `init_lm(PRNGKey(0), f32)` at llama3-smoke
and gemma-smoke size, converted by `repro_torch.models.convert`; both
packages see the same numpy batches. Tolerances: the loss within 1e-5
relative; every gradient leaf within a relative L2 of 1e-4 with float
activations and 1e-3 with GRAU (a rounding flip of one GRAU activation
moves its output by s_out; the flips between the two forwards are counted
and reported); AdamW's update within 1e-3; a 3-step loss trajectory within
1e-4. The reference is computed once per module. On the CPU the port runs
the kernels' plain versions (the attention is the plain chunked scan).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import GRAUConfig as JGRAUConfig  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline, zipf_tokens  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import GRAUConfig as TGRAUConfig  # noqa: E402
from repro_torch.models.convert import (from_reference,  # noqa: E402
                                        opt_state_from_reference)
from repro_torch.nn.common import tree_flatten, tree_map  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train.loop import LoopConfig, run  # noqa: E402

CHUNK = 16
ARCHS = ["llama3.2-3b", "gemma-7b"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, grau):
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    if grau:
        jcfg = jcfg.replace(grau=JGRAUConfig(mode="apot", segments=6,
                                             num_exponents=8))
        tcfg = tcfg.replace(grau=TGRAUConfig(mode="apot", segments=6,
                                             num_exponents=8))
    return jcfg, tcfg


def _batch(vocab, seed, b=2, s=48):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(b, s + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _recording(act, store, jax_side):
    def call(z):
        y = act(z)
        if jax_side:
            jax.debug.callback(lambda y: store.append(np.asarray(y)), y)
        else:
            store.append(y.detach().numpy())
        return y
    return call


@pytest.fixture(scope="module")
def reference():
    """Per (arch, grau): the reference's params, batch, loss, gradients and
    recorded GRAU activations; computed once for the module."""
    out = {}
    for arch in ARCHS:
        for grau in (False, True):
            jcfg, _ = _configs(arch, grau)
            jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0),
                                dtype=jnp.float32)
            batch = _batch(jcfg.vocab_size, 1)
            act = jlm.make_act(jcfg)
            loss, grads = jax.value_and_grad(lambda p: jlm.lm_loss(
                p, jcfg, _j(batch), act=act, q_chunk=CHUNK,
                kv_chunk=CHUNK))(jp)
            acts = []
            if grau:
                jlm.apply_lm(jp, jcfg, jnp.asarray(batch["tokens"]),
                             act=_recording(act, acts, True), q_chunk=CHUNK,
                             kv_chunk=CHUNK)
                jax.effects_barrier()
            out[(arch, grau)] = dict(params=jp, batch=batch,
                                     loss=float(loss), grads=grads,
                                     acts=acts)
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grau", [False, True])
def test_loss_and_grads_match_reference(reference, arch, grau):
    ref = reference[(arch, grau)]
    _, tcfg = _configs(arch, grau)
    params = from_reference(ref["params"], tcfg, device="cpu")
    loss, grads = tsteps.make_loss_and_grads(
        tcfg, remat=None, q_chunk=CHUNK, kv_chunk=CHUNK)(params,
                                                         _t(ref["batch"]))
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    flips = 0
    if grau:
        acts = []
        tlm.apply_lm(params, tcfg, torch.from_numpy(ref["batch"]["tokens"]),
                     act=_recording(tlm.make_act(tcfg, "cpu"), acts, False),
                     q_chunk=CHUNK, kv_chunk=CHUNK)
        assert len(acts) == len(ref["acts"]) == tcfg.num_layers
        flips = sum(int((a != b).sum()) for a, b in zip(acts, ref["acts"]))
    want = dict(tree_flatten(from_reference(ref["grads"], tcfg,
                                            device="cpu")))
    tol = 1e-3 if grau else 1e-4
    for path, g in tree_flatten(grads):
        assert g.dtype == want[path].dtype
        err = _rel_l2(g.numpy(), want[path].numpy())
        assert err <= tol, f"{path}: rel L2 {err:.3g} ({flips} GRAU flips)"


def test_lr_schedule_matches_reference():
    jc = joptim.AdamWConfig(peak_lr=3e-3, warmup_steps=10, total_steps=100)
    tc = toptim.AdamWConfig(peak_lr=3e-3, warmup_steps=10, total_steps=100)
    for step in range(121):
        want = float(joptim.lr_schedule(jc, jnp.asarray(step, jnp.int32)))
        got = float(toptim.lr_schedule(tc, torch.tensor(step,
                                                        dtype=torch.int32)))
        assert abs(got - want) <= 1e-7, step


def test_adamw_continues_the_reference_state(reference):
    """The reference runs two AdamW steps; the port takes its state at step
    2 (non-zero moments) through opt_state_from_reference and both apply a
    third: the parameter update within a relative L2 of 1e-3 per leaf."""
    ref = reference[("llama3.2-3b", False)]
    _, tcfg = _configs("llama3.2-3b", False)
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=10)
    jc, tc = joptim.AdamWConfig(**kw), toptim.AdamWConfig(**kw)
    p, g, s = ref["params"], ref["grads"], joptim.init_opt_state(
        ref["params"])
    for _ in range(2):
        p, s, _ = joptim.adamw_update(jc, p, g, s)
    p3, s3, jm = joptim.adamw_update(jc, p, g, s)
    tp = from_reference(p, tcfg, device="cpu")
    before = tree_map(torch.clone, tp)
    ts = opt_state_from_reference(s, tp, device="cpu")
    assert int(ts.step) == 2
    tp, ts3, tm = toptim.adamw_update(tc, tp, from_reference(
        g, tcfg, device="cpu"), ts)
    assert int(ts3.step) == 3
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-9
    want = dict(tree_flatten(from_reference(p3, tcfg, device="cpu")))
    start = dict(tree_flatten(before))
    for path, new in tree_flatten(tp):
        d_got = (new - start[path]).numpy()
        d_want = (want[path] - start[path]).numpy()
        assert _rel_l2(d_got, d_want) <= 1e-3, path
    m_want = dict(tree_flatten(from_reference(s3.m, tcfg, device="cpu")))
    for path, m in tree_flatten(ts3.m):
        assert _rel_l2(m.numpy(), m_want[path].numpy()) <= 1e-5, path


def test_train_step_trajectory_matches_reference():
    """Three steps of make_train_step (GRAU, no remat) on the same numpy
    batches: the losses within 1e-4 relative of the reference's."""
    jcfg, tcfg = _configs("llama3.2-3b", True)
    kw = dict(peak_lr=3e-3, warmup_steps=1, total_steps=3)
    jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = from_reference(jp, tcfg, device="cpu")
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, joptim.AdamWConfig(**kw), remat=None, q_chunk=CHUNK,
        kv_chunk=CHUNK))
    tstep = tsteps.make_train_step(tcfg, toptim.AdamWConfig(**kw),
                                   remat=None, q_chunk=CHUNK, kv_chunk=CHUNK)
    js, ts = joptim.init_opt_state(jp), toptim.init_opt_state(tp)
    for i in range(3):
        batch = _batch(jcfg.vocab_size, 10 + i)
        jp, js, jm = jstep(jp, js, _j(batch))
        tp, ts, tm = tstep(tp, ts, _t(batch))
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= 1e-4 * abs(want), i


def _smoke(grau=False):
    cfg = tget_config("llama3.2-3b", smoke=True)
    if grau:
        cfg = cfg.replace(grau=TGRAUConfig())
    return cfg, tlm.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")


def test_microbatches_and_remat_agree_inside_the_port():
    cfg, params = _smoke()
    batch = _t(_batch(cfg.vocab_size, 3, b=4))
    opt = toptim.AdamWConfig(peak_lr=3e-3, warmup_steps=1, total_steps=3)
    out = []
    for mb in (1, 2):
        p = tree_map(torch.clone, params)
        step = tsteps.make_train_step(cfg, opt, remat=None, q_chunk=CHUNK,
                                      kv_chunk=CHUNK, microbatches=mb)
        p, _, m = step(p, toptim.init_opt_state(p), batch)
        out.append((float(m["loss"]), p))
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[0][0])
    for (path, a), (_, b) in zip(tree_flatten(out[0][1]),
                                 tree_flatten(out[1][1])):
        assert _rel_l2(a.numpy(), b.numpy()) <= 1e-5, path
    with pytest.raises(ValueError, match="microbatches"):
        tsteps.make_train_step(cfg, opt, microbatches=3)(
            params, toptim.init_opt_state(params), batch)
    # remat "full" recomputes the same forward: identical loss and grads
    res = [tsteps.make_loss_and_grads(cfg, remat=r, q_chunk=CHUNK,
                                      kv_chunk=CHUNK)(params, batch)
           for r in (None, "full")]
    assert float(res[0][0]) == float(res[1][0])
    for (path, a), (_, b) in zip(tree_flatten(res[0][1]),
                                 tree_flatten(res[1][1])):
        assert torch.equal(a, b), path
    with pytest.raises(NotImplementedError, match="dots"):
        tlm.lm_loss(params, cfg, batch, remat="dots")


def test_training_reduces_loss():
    cfg, params = _smoke(grau=True)
    pipe = TokenPipeline(cfg.vocab_size, 32, 4, seed=3, device="cpu")
    step = tsteps.make_train_step(
        cfg, toptim.AdamWConfig(peak_lr=5e-3, warmup_steps=2,
                                total_steps=30), remat=None, q_chunk=CHUNK,
        kv_chunk=CHUNK)
    _, _, hist = run(train_step=step, params=params,
                     opt_state=toptim.init_opt_state(params),
                     batch_fn=pipe.batch, loop=LoopConfig(total_steps=30),
                     log=lambda *_: None)
    losses = hist["losses"]
    assert losses[-1] < losses[0] - 0.5, losses


def test_loop_nan_fuse():
    calls = {"n": 0}

    def bad_step(params, opt, batch):
        calls["n"] += 1
        return params, opt, {"loss": torch.tensor(
            float("nan") if calls["n"] >= 3 else 1.0)}

    with pytest.raises(FloatingPointError, match="non-finite"):
        run(train_step=bad_step, params={}, opt_state={},
            batch_fn=lambda s: {}, loop=LoopConfig(total_steps=10),
            log=lambda *_: None)
    assert calls["n"] == 3


def test_loop_resume_is_bit_identical(tmp_path):
    """6 uninterrupted steps against 3 steps that commit a checkpoint and a
    fresh run from the same directory (GRAU, remat "full"): it resumes at
    step 3 and every loss and final tensor is bit-identical."""
    cfg, _ = _smoke(grau=True)
    pipe = TokenPipeline(cfg.vocab_size, 32, 2, seed=1, device="cpu")
    opt = toptim.AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=6)

    def fresh(total, ckpt_dir=None):
        params = tlm.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
        step = tsteps.make_train_step(cfg, opt, remat="full", q_chunk=CHUNK,
                                      kv_chunk=CHUNK)
        return run(train_step=step, params=params,
                   opt_state=toptim.init_opt_state(params),
                   batch_fn=pipe.batch,
                   loop=LoopConfig(total_steps=total, ckpt_every=3,
                                   ckpt_dir=ckpt_dir), log=lambda *_: None)

    pf, of, full = fresh(6)
    fresh(3, str(tmp_path))
    assert ckpt.latest_step(tmp_path) == 3
    pr, orr, resumed = fresh(6, str(tmp_path))
    assert resumed["start"] == 3
    assert resumed["losses"] == full["losses"][3:]
    for (path, a), (_, b) in zip(tree_flatten({"p": pf, "o": of}),
                                 tree_flatten({"p": pr, "o": orr})):
        assert torch.equal(a, b), path


def test_ckpt_roundtrip_and_gc(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.int32)},
            "opt": toptim.OptState(torch.tensor(7, dtype=torch.int32),
                                   [torch.zeros(2, dtype=torch.bfloat16)],
                                   [torch.ones(2)])}
    for step in (1, 2, 3, 4):
        ckpt.save(tmp_path, step, tree, keep=2)
    assert ckpt.latest_step(tmp_path) == 4
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_00000003", "step_00000004"]
    assert (tmp_path / "LATEST").read_text() == "4"
    out = ckpt.restore(tmp_path, 4, tree)
    assert isinstance(out["opt"], toptim.OptState)
    for (pa, a), (pb, b) in zip(tree_flatten(out), tree_flatten(tree)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    assert ckpt.read_manifest(tmp_path, 4)["keys"] == sorted(
        ckpt.load_flat(tmp_path, 4))


def test_ckpt_uncommitted_ignored(tmp_path):
    ckpt.save(tmp_path, 5, {"a": torch.zeros((2,))})
    (tmp_path / "step_00000009").mkdir()        # a torn write: no MANIFEST
    (tmp_path / ".tmp_step_00000011").mkdir()   # a staged, unrenamed write
    assert ckpt.latest_step(tmp_path) == 5


def test_ckpt_shape_mismatch_rejected(tmp_path):
    ckpt.save(tmp_path, 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(tmp_path, 1, {"a": torch.zeros((3,))})


def test_token_pipeline_seekable_and_its_structure_matches_reference():
    p = TokenPipeline(vocab_size=128, seq_len=16, global_batch=4, seed=3,
                      device="cpu")
    b1, b2, b3 = p.batch(7), p.batch(7), p.batch(8)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert b1["tokens"].dtype == torch.int64
    assert int(b1["tokens"].max()) < 128 and int(b1["tokens"].min()) >= 0
    # the Zipf transform and the rolling rule on the same base draws, against
    # the reference's expression (data/pipeline.py, TokenPipeline.batch)
    u = np.random.default_rng(0).uniform(1e-6, 1.0, size=(8, 65)).astype(
        np.float32)
    for vocab in (128, 128256):
        ju = jnp.asarray(u)
        base = jnp.minimum((ju ** (-1.0 / 1.2)) - 1.0, vocab - 1.0)
        toks = base.astype(jnp.int32)
        rolled = (toks + jnp.roll(toks, 1, axis=1) * 31) % vocab
        mask = (jnp.arange(65) % 4 == 3)
        want = np.asarray(jnp.where(mask[None, :], rolled, toks))
        got = zipf_tokens(torch.from_numpy(u), vocab).numpy()
        np.testing.assert_array_equal(got, want)


def test_launchers_run_a_few_steps(tmp_path, capsys):
    from repro_torch.launch import train, train_lm_grau
    train.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                "--steps", "3", "--seq-len", "32", "--batch", "2", "--grau",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "final loss" in out and "[ckpt] committed step 2" in out
    l_float, l_grau = train_lm_grau.main(["--steps", "3", "--device", "cpu"])
    assert np.isfinite(l_float) and np.isfinite(l_grau)
    assert "GRAU-QAT degradation" in capsys.readouterr().out
