"""PyTorch port vs the JAX reference: the Mamba-2 (SSD) block and the SSM
archs on the dense backend.

ssd_chunked, apply_mamba2 and decode_mamba2 against the reference's at l <=
chunk and l = 2 * chunk; the ragged tail (D3: l = chunk + 35, which the
reference refuses with an AssertionError) against the reference run on the
same inputs zero-padded to 2 * chunk, then sliced; the tail against the
per-token decode recurrence; mamba2-smoke and jamba-smoke exact-length
prefill-then-decode against the train forward and against the reference;
the engine's streams (jamba's also with GRAU) equal the reference's for
prompts the reference can take. f32 on the CPU: SSD outputs and states within 1e-5 (measured: 1.5e-6
at most), logits within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401
from torch_dense_common import (assert_caches_close, model, serve,  # noqa: E402
                                t)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.nn import mamba2 as jm  # noqa: E402
from repro.nn.common import ParamBuilder  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.nn import mamba2 as tm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK = 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssd_inputs(l, g=1, seed=0, b=2, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(b, l, h, p), (-0.1 * np.abs(f(b, l, h))).astype(np.float32),
            f(b, l, g, n), f(b, l, g, n), f(b, h, p, n))


@pytest.mark.parametrize("l", [5, CHUNK, 2 * CHUNK])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_reference(l, g, init):
    xdt, dA, B, C, s0 = _ssd_inputs(l, g)
    kw = {"chunk": CHUNK}
    jy, js = jm.ssd_chunked(*map(jnp.asarray, (xdt, dA, B, C)),
                            init_state=jnp.asarray(s0) if init else None,
                            **kw)
    ty, ts = tm.ssd_chunked(*map(t, (xdt, dA, B, C)),
                            init_state=t(s0) if init else None, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("tail", [35, 1, 63])
def test_ragged_tail_matches_reference_on_padded_inputs(tail):
    """D3 at mamba2-smoke's chunk 64: at l = chunk + tail the reference's
    own ssd_chunked raises; the port pads the tail with xdt = dA = B = C =
    0. Its rows equal the reference's run on the inputs zero-padded to 2 *
    chunk, sliced to l, and its final state equals that run's (padded rows
    add nothing and do not decay)."""
    chunk = 64
    l = chunk + tail
    xdt, dA, B, C, s0 = _ssd_inputs(l, seed=3)
    with pytest.raises(AssertionError):
        jm.ssd_chunked(*map(jnp.asarray, (xdt, dA, B, C)), chunk=chunk)
    pad = lambda a: np.pad(a, [(0, 0), (0, 2 * chunk - l)]  # noqa: E731
                           + [(0, 0)] * (a.ndim - 2))
    jy, js = jm.ssd_chunked(*(jnp.asarray(pad(a)) for a in (xdt, dA, B, C)),
                            init_state=jnp.asarray(s0), chunk=chunk)
    ty, ts = tm.ssd_chunked(*map(t, (xdt, dA, B, C)), init_state=t(s0),
                            chunk=chunk)
    assert ty.shape[1] == l
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy)[:, :l], **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def _block(seed=0):
    """One Mamba-2 block at mamba2-smoke's width, chunk 16: the reference's
    parameters and the port's copies."""
    cfg = model("mamba2-1.3b")[0].ssm
    cfg = jm.SSMConfig(d_state=cfg.d_state, head_dim=cfg.head_dim,
                       expand=cfg.expand, chunk=CHUNK)
    pb = ParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    jm.init_mamba2(pb, 128, cfg)
    # non-trivial dt_bias / a_log / norm so every term is exercised
    rng = np.random.default_rng(seed)
    for k in ("dt_bias", "a_log", "norm_w", "conv_b"):
        pb.params[k] = jnp.asarray(
            0.3 * rng.standard_normal(pb.params[k].shape), jnp.float32)
    tcfg = tm.SSMConfig(**{f: getattr(cfg, f) for f in (
        "d_state", "head_dim", "expand", "n_groups", "conv_width", "chunk")})
    return cfg, pb.params, tcfg, {k: t(np.asarray(v))
                                  for k, v in pb.params.items()}


@pytest.mark.parametrize("l", [7, CHUNK, 2 * CHUNK])
def test_apply_and_decode_mamba2_match_reference(l):
    """The block over l tokens (out and state), then three decode steps
    from that state (outs and states), against the reference."""
    jcfg, jp, tcfg, tp = _block()
    x = np.random.default_rng(1).standard_normal((2, l + 3, 128)).astype(
        np.float32)
    jo, jst = jm.apply_mamba2(jp, jnp.asarray(x[:, :l]), 128, jcfg)
    to, tst = tm.apply_mamba2(tp, t(x[:, :l]), 128, tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert_caches_close(((jst,),), ((tst,),))
    for i in range(l, l + 3):
        jo, jst = jm.decode_mamba2(jp, jnp.asarray(x[:, i:i + 1]), 128, jcfg,
                                   jst)
        to, tst = tm.decode_mamba2(tp, t(x[:, i:i + 1]), 128, tcfg, tst)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        assert_caches_close(((jst,),), ((tst,),))


def test_ragged_tail_equals_the_decode_recurrence():
    """D3 inside the block: apply_mamba2 over chunk + 35 tokens equals the
    per-token decode_mamba2 recurrence from the zero state, row for row
    and in the final state."""
    _, _, tcfg, tp = _block(seed=2)
    l = CHUNK + 35
    x = t(np.random.default_rng(4).standard_normal((1, l, 128)).astype(
        np.float32))
    out, st = tm.apply_mamba2(tp, x, 128, tcfg)
    di = tcfg.d_inner(128)
    state = tm.SSMState(torch.zeros(1, tcfg.conv_width - 1, di + 2 * 16),
                        torch.zeros(1, tcfg.n_heads(128), tcfg.head_dim, 16))
    rows = []
    for i in range(l):
        o, state = tm.decode_mamba2(tp, x[:, i:i + 1], 128, tcfg, state)
        rows.append(o)
    np.testing.assert_allclose(out.numpy(), torch.cat(rows, 1).numpy(),
                               **TOL)
    np.testing.assert_allclose(st.ssm.numpy(), state.ssm.numpy(), **TOL)
    np.testing.assert_allclose(st.conv.numpy(), state.conv.numpy(), **TOL)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("s", [40, 64, 100])
def test_prefill_then_decode_equals_train_forward(arch, s):
    """Exact-length prefill of s - 1 tokens then one decode step: the
    logits equal the train forward's last ones (the port, and the
    reference where its chunk allows: s - 1 <= 64 here). 100 - 1 = 99
    tokens take D3's tail at mamba2-smoke's chunk 64."""
    jcfg, jp, tcfg, tp = model(arch)
    toks = np.random.default_rng(s).integers(
        2, tcfg.vocab_size, size=(1, s)).astype(np.int32)
    full, _, _ = tlm.apply_lm(tp, tcfg, t(toks))
    caches = tlm.init_caches(tcfg, 1, s, dtype=torch.float32, device="cpu")
    last, caches = tlm.prefill_step(tp, tcfg, t(toks[:, :-1]), caches,
                                    true_length=t(np.array([s - 1])))
    np.testing.assert_allclose(last.numpy(), full[:, -2].numpy(), **TOL)
    step, _ = tlm.decode_step(tp, tcfg, t(toks[:, -1:]), caches)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               **TOL)
    if s - 1 <= jcfg.ssm.chunk:
        jc = jlm.init_caches(jcfg, 1, s, dtype=jnp.float32)
        jlast, jc = jlm.prefill_step(jp, jcfg, jnp.asarray(toks[:, :-1]), jc,
                                     true_length=jnp.asarray([s - 1]))
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
        jstep, _ = jlm.decode_step(jp, jcfg, jnp.asarray(toks[:, -1:]), jc)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **TOL)


@pytest.mark.parametrize("arch,grau", [
    ("mamba2-1.3b", False), ("jamba-v0.1-52b", False),
    ("jamba-v0.1-52b", True)],
    ids=["mamba2-1.3b", "jamba-v0.1-52b", "jamba-v0.1-52b-grau"])
def test_engine_streams_match_reference(arch, grau):
    """Contexts the reference's exact-length prefill takes (<= chunk, or a
    multiple of it; 1 token: the empty context through the slot reset):
    greedy and sampled streams equal; jamba also with the GRAU apot
    activation, the configuration slice (k) serves on the card."""
    lens = [1, 2, 30, 65, 129]        # contexts 0, 1, 29, 64, 128
    ref = serve("ref", arch, lens, grau=grau)
    assert serve("port", arch, lens, grau=grau) == ref


def test_engine_serves_ragged_contexts():
    """Contexts the reference cannot prefill (chunk < ctx, not a multiple):
    the port's greedy stream equals a greedy loop over its own train
    forward."""
    arch = "mamba2-1.3b"
    lens = [100, 150]
    got = serve("port", arch, lens, sampled=False, max_new=4)
    _, _, tcfg, tp = model(arch)
    from torch_dense_common import requests
    from repro_torch.serve import engine as teng
    for req in requests(teng, tcfg, lens, max_new=4, sampled=False):
        toks = list(req.prompt)
        for _ in range(4):
            logits, _, _ = tlm.apply_lm(tp, tcfg, t(np.array([toks])))
            toks.append(int(torch.argmax(logits[0, -1])))
        assert got[req.rid] == toks[len(req.prompt):], req.rid
