"""PyTorch port vs the JAX reference: Whisper's encoder-decoder on the dense
backend.

run_encoder (bidirectional self-attention over the stub frames: on the card
the flash kernel, non-causal), a cross-attention layer's prefill (the
(self cache, CrossKV) pair filled) and decode (the cached cross K/V read
through chunked_attention) against the reference's; whisper-smoke's
prefill then decode, and its engine streams with per-request
encoder_frames; make_lm_batch_for's frames stub. f32 on the CPU, within
1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401
from torch_dense_common import (assert_caches_close, frames_for,  # noqa: E402
                                model, serve, t)

import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import make_lm_batch_for  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn.rope import rope_tables  # noqa: E402

ARCH = "whisper-medium"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("chunk", [16, 1024])
def test_run_encoder_matches_reference(chunk):
    """Two stub-frame batches (64 frames at smoke size), in one chunk and
    in 16-row tiles."""
    jcfg, jp, tcfg, tp = model(ARCH)
    fr = np.stack(frames_for(jcfg, 2))
    jo = jlm.run_encoder(jp, jcfg, jnp.asarray(fr), q_chunk=chunk,
                         kv_chunk=chunk)
    to = tlm.run_encoder(tp, tcfg, t(fr), q_chunk=chunk, kv_chunk=chunk)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_cross_attention_layer_prefill_and_decode_match_reference():
    """Decoder layer 0 in prefill (self KV cache and CrossKV filled from
    the encoder output), then two decode steps reading the cached cross
    K/V: outputs and caches against the reference."""
    jcfg, jp, tcfg, tp = model(ARCH)
    spec = jcfg.groups[0][0][0]
    jl = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in jp["group0"]["l0"].items()}
    tl = tp["group0"][0]["l0"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 128)).astype(np.float32)
    enc = rng.standard_normal((2, 64, 128)).astype(np.float32)
    act = jlm.make_act(jcfg)
    jself, jcross = jlm.init_caches(jcfg, 2, 16, dtype=jnp.float32)[0][0]
    jself = type(jself)(*(a[0] for a in jself))
    jcross = type(jcross)(*(a[0] for a in jcross))
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    jo, jcache, _ = jblocks.apply_layer(
        jl, jnp.asarray(x[:, :10]), spec, jcfg, positions=jnp.asarray(pos),
        act=act, cache=(jself, jcross), encoder_out=jnp.asarray(enc),
        mode="prefill")
    tcaches = tlm.init_caches(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    tself, tcross = (type(c)(*(a[0] for a in c)) for c in tcaches[0][0])
    tact = tlm.make_act(tcfg, "cpu")
    to, tcache, _ = tblocks.apply_layer(
        tl, t(x[:, :10]), tcfg.groups[0][0][0], tcfg,
        rope=rope_tables(t(pos), tcfg.head_dim, tcfg.rope_theta), act=tact,
        cache=(tself, tcross), encoder_out=t(enc), mode="prefill")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert_caches_close(((jcache,),), ((tcache,),))
    for i in (10, 11):
        jo, jcache, _ = jblocks.apply_layer(
            jl, jnp.asarray(x[:, i:i + 1]), spec, jcfg, positions=None,
            act=act, cache=jcache, mode="decode")
        tpos = tcache[0].length[:, None]
        to, tcache, _ = tblocks.apply_layer(
            tl, t(x[:, i:i + 1]), tcfg.groups[0][0][0], tcfg,
            rope=rope_tables(tpos, tcfg.head_dim, tcfg.rope_theta),
            act=tact, cache=tcache, mode="decode")
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        assert_caches_close(((jcache,),), ((tcache,),))


def test_whisper_prefill_then_decode_matches_reference():
    """whisper-smoke end to end: bucket-padded prefill (true lengths 7 and
    16) running the encoder over each row's frames, every cache leaf, then
    two decode steps from the cached cross K/V."""
    jcfg, jp, tcfg, tp = model(ARCH)
    fr = np.stack(frames_for(jcfg, 2, seed=9))
    toks = np.random.default_rng(1).integers(
        2, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    tl = np.array([7, 16], np.int32)
    jlog, jc = jlm.prefill_step(
        jp, jcfg, jnp.asarray(toks),
        jlm.init_caches(jcfg, 2, 20, dtype=jnp.float32),
        true_length=jnp.asarray(tl), encoder_frames=jnp.asarray(fr))
    tlog, tc = tlm.prefill_step(
        tp, tcfg, t(toks),
        tlm.init_caches(tcfg, 2, 20, dtype=torch.float32, device="cpu"),
        true_length=t(tl), encoder_frames=t(fr))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert_caches_close(jc, tc)
    for step in range(2):
        nxt = np.array([[4 + step], [8 + step]], np.int32)
        jd, jc = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        td, tc = tlm.decode_step(tp, tcfg, t(nxt), tc)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    assert_caches_close(jc, tc)


def test_whisper_engine_streams_match_reference():
    """whisper-smoke on the dense engine, each request with its own stub
    frames: greedy and sampled streams equal the reference's."""
    lens = [1, 5, 17, 40, 90]
    ref = serve("ref", ARCH, lens)
    assert serve("port", ARCH, lens) == ref


def test_encoder_frames_stub():
    """make_lm_batch_for's Whisper stub: (global_batch, num_frames,
    d_model) in the asked dtype, 0.02 * normal, the same for the same
    (seed, step) and different for another step or seed; decoder-only
    configs get none."""
    from repro_torch.configs.archs import get_config
    cfg = get_config(ARCH, smoke=True)
    shape = ShapeSpec("t", 24, 3, "train")
    b = make_lm_batch_for(cfg, shape, 2, seed=1, device="cpu",
                          dtype=torch.float32)
    fr = b["encoder_frames"]
    assert fr.shape == (3, cfg.encoder.num_frames, cfg.d_model)
    assert fr.dtype == torch.float32 and "patch_embeds" not in b
    assert 0.015 < float(fr.std()) < 0.025
    again = make_lm_batch_for(cfg, shape, 2, seed=1, device="cpu",
                              dtype=torch.float32)["encoder_frames"]
    assert torch.equal(fr, again)
    for step, seed in ((3, 1), (2, 2)):
        other = make_lm_batch_for(cfg, shape, step, seed=seed, device="cpu",
                                  dtype=torch.float32)["encoder_frames"]
        assert not torch.equal(fr, other)
    assert make_lm_batch_for(cfg, shape, 2, device="cpu")[
        "encoder_frames"].dtype == torch.bfloat16
    llama = get_config("llama3.2-3b", smoke=True)
    assert "encoder_frames" not in make_lm_batch_for(llama, shape, 0,
                                                     device="cpu")


def test_front_door_serves_whisper_with_frames():
    """The port's FrontDoor passes each submit's encoder_frames on (its
    submit signature is the reference's): the streams equal run()'s on the
    same requests."""
    import asyncio

    from torch_dense_common import engine, requests
    from repro_torch.serve import engine as teng
    from repro_torch.serve.frontdoor import FrontDoor
    cfg = model(ARCH)[2]
    lens = [5, 17, 40]
    base = engine("port", ARCH)
    want = {r.rid: list(r.out_tokens)
            for r in base.run(requests(teng, cfg, lens, max_new=5))}
    base.close()
    eng = engine("port", ARCH)

    async def serve():
        async with FrontDoor(eng) as door:
            streams = [await door.submit(
                r.prompt, r.max_new_tokens, sampling=r.sampling,
                encoder_frames=r.encoder_frames, rid=r.rid)
                for r in requests(teng, cfg, lens, max_new=5)]
            return {s.rid: await s.drain() for s in streams}
    assert asyncio.run(serve()) == want
