"""Shared set-up of the port's dense-backend parity tests: each smoke model
once per process (the reference's parameters from init_lm(PRNGKey(0), f32),
carried across by from_reference), request mixes built identically for both
packages, and a runner that serves them on either engine."""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs.archs import get_config as jget_config
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro_torch.configs.archs import get_config as tget_config
from repro_torch.models.convert import from_reference
from repro_torch.serve import engine as teng


@functools.lru_cache(maxsize=None)
def model(arch, grau=False):
    """(reference cfg, reference params, port cfg, port params) at smoke
    size, f32 on the CPU; with `grau`, the default GRAU activation (apot)
    at the model's activation sites."""
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    if grau:
        from repro.models.config import GRAUConfig as JGRAUConfig
        from repro_torch.models.config import GRAUConfig as TGRAUConfig
        jcfg = jcfg.replace(grau=JGRAUConfig())
        tcfg = tcfg.replace(grau=TGRAUConfig())
    jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, tcfg, from_reference(jp, tcfg, device="cpu")


def frames_for(cfg, n, seed=5):
    """n stub encoder-frame arrays (0.02 * normal), or Nones."""
    if cfg.encoder is None:
        return [None] * n
    rng = np.random.default_rng(seed)
    return [(0.02 * rng.standard_normal(
        (cfg.encoder.num_frames, cfg.d_model))).astype(np.float32)
        for _ in range(n)]


def requests(eng_mod, cfg, lens, *, max_new=6, sampled=True, seed=7,
             frames=None):
    """One request per prompt length: even rids greedy, odd rids sampled
    (T 0.8, top-k 8) when `sampled`; the same prompts for both packages."""
    rng = np.random.default_rng(seed)
    frames = frames or frames_for(cfg, len(lens))
    return [eng_mod.Request(
        rid=i, prompt=rng.integers(2, cfg.vocab_size, size=n),
        max_new_tokens=max_new, encoder_frames=f,
        sampling=eng_mod.SamplingParams(
            temperature=0.8 if sampled and i % 2 else 0.0,
            top_k=8 if sampled and i % 2 else 0))
        for i, (n, f) in enumerate(zip(lens, frames))]


def engine(which, arch, *, grau=False, **kw):
    """A reference or port ServeEngine over the arch's smoke model."""
    jcfg, jp, tcfg, tp = model(arch, grau)
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 160)
    kw.setdefault("seed", 11)
    kw.setdefault("eos_id", -1)
    if which == "ref":
        return jeng.ServeEngine(jcfg, jp, jeng.EngineConfig(**kw))
    return teng.ServeEngine(tcfg, tp, teng.EngineConfig(**kw), device="cpu")


def serve(which, arch, lens, *, max_new=6, sampled=True, grau=False, **kw):
    """{rid: tokens} of the length mix served to completion."""
    eng = engine(which, arch, grau=grau, **kw)
    mod = jeng if which == "ref" else teng
    cfg = model(arch, grau)[0 if which == "ref" else 2]
    done = eng.run(requests(mod, cfg, lens, max_new=max_new,
                            sampled=sampled))
    eng.close()
    return {r.rid: list(r.out_tokens) for r in done}


def t(a):
    """numpy -> torch (int32 tokens stay int32, as the engines pass them)."""
    return torch.from_numpy(np.array(a))


def assert_caches_close(jcaches, tcaches, tol=1e-5):
    """A reference dense cache tree against the port's, leaf by leaf."""
    from repro_torch.nn.common import tree_flatten
    want = tree_flatten(jax.tree.map(np.asarray, jcaches,
                                     is_leaf=lambda x: hasattr(x, "shape")))
    got = tree_flatten(tcaches)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=path)
