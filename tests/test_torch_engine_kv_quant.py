"""PyTorch port vs the JAX reference: PoT-quantized KV pools end to end.

The port's ServeEngine on the CPU (its kernels' plain versions: matmul_wq
for the MLP, the paged kernels on packed pools) and the reference's engine
(gather path) serve the same requests with the same f32 weights of
llama3-smoke, at kv_bits 8 and 4 (float weights: the reference's
weight-matmul implementation plays no part), and the greedy token streams
must be identical. With quantized pools, every pool byte outside the null
block must equal the reference's after each prefill chunk of a prompt and
after its first decode write, also with int4 weights and GRAU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import GRAUConfig as JGRAUConfig  # noqa: E402
from repro.nn.common import build_lm_grau as jbuild_lm_grau  # noqa: E402
from repro.quant import weights as jwq  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models.config import GRAUConfig as TGRAUConfig  # noqa: E402
from repro_torch.models.convert import (from_reference,  # noqa: E402
                                        pools_from_reference)
from repro_torch.nn.common import build_lm_grau  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

PAGE = 8
COMPOSITIONS = {
    "kv8": dict(kv_bits=8),
    "kv4": dict(kv_bits=4),
}
WQ4_KV4_GRAU = dict(weight_bits=4, kv_bits=4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke_params():
    jcfg = jget_config("llama3.2-3b", smoke=True)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jparams


def _setup(name):
    jcfg = jget_config("llama3.2-3b", smoke=True)
    tcfg = tget_config("llama3.2-3b", smoke=True)
    jattn = tattn = None
    if name.endswith("grau"):
        jcfg, tcfg = (jcfg.replace(grau=JGRAUConfig()),
                      tcfg.replace(grau=TGRAUConfig()))
        jattn, tattn = jbuild_lm_grau("identity"), build_lm_grau("identity")
    return jcfg, tcfg, jattn, tattn


def _requests(mod, vocab):
    rng = np.random.default_rng(4)
    return [mod.Request(rid=i, prompt=rng.integers(2, vocab, size=n),
                        max_new_tokens=m)
            for i, (n, m) in enumerate([(5, 8), (20, 6), (12, 8), (35, 7)])]


def _ref_streams(jcfg, jparams, jattn, quant, impl):
    with jwq.use_impl(impl):
        je = jeng.ServeEngine(jcfg, jparams, jeng.EngineConfig(
            slots=2, max_seq=64, page_size=PAGE, paged_impl="gather",
            attn_grau=jattn, telemetry=False, **quant))
        done = je.run(_requests(jeng, jcfg.vocab_size))
    return {r.rid: list(r.out_tokens) for r in done}, je


@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_engine_greedy_streams_match_reference(smoke_params, name):
    quant = COMPOSITIONS[name]
    jcfg, tcfg, jattn, tattn = _setup(name)
    te = teng.ServeEngine(tcfg, from_reference(smoke_params, tcfg, device="cpu"),
                          teng.EngineConfig(slots=2, max_seq=64,
                                            page_size=PAGE, attn_grau=tattn,
                                            **quant), device="cpu")
    got = {r.rid: list(r.out_tokens)
           for r in te.run(_requests(teng, tcfg.vocab_size))}
    want, je = _ref_streams(jcfg, smoke_params, jattn, quant, "dense")
    assert got == want
    assert all(len(v) >= 1 for v in got.values())
    assert te.allocator.free_blocks == te.allocator.num_blocks - 1
    jm, tm = je.metrics(), te.metrics()
    for key in ("weight_bits", "weights_quantized", "weight_bytes",
                "kv_bits", "kv_quantized"):
        assert tm[key] == jm[key], key


@pytest.mark.parametrize("name", ["kv4", "wq4_kv4_grau"])
def test_pool_bytes_match_reference_through_prefill(smoke_params, name):
    """One 20-token prompt, 8-token chunks: three prefill chunks (the last
    block partial, its padding kept out of the exponent by ctx), then the
    first decode write; after every step the packed pools and exponent
    planes equal the reference's byte for byte (block 0, the trash block
    that idle slots write, excluded)."""
    quant = COMPOSITIONS.get(name, WQ4_KV4_GRAU)
    jcfg, tcfg, jattn, tattn = _setup(name)
    prompt = np.random.default_rng(8).integers(2, tcfg.vocab_size, size=20)
    kw = dict(slots=2, max_seq=64, page_size=PAGE, prefill_chunk=8, **quant)
    with jwq.use_impl("dense"):
        je = jeng.ServeEngine(jcfg, smoke_params, jeng.EngineConfig(
            paged_impl="gather", attn_grau=jattn, telemetry=False, **kw))
        te = teng.ServeEngine(tcfg, from_reference(smoke_params, tcfg, device="cpu"),
                              teng.EngineConfig(attn_grau=tattn, **kw),
                              device="cpu")
        je.submit(jeng.Request(rid=0, prompt=prompt, max_new_tokens=4))
        te.submit(teng.Request(rid=0, prompt=prompt, max_new_tokens=4))
        for step in range(4):          # chunks at 0, 8, 16, then decode
            je.step()
            te.step()
            want = pools_from_reference(je.caches, device="cpu")
            for jg, tg in zip(want, te.caches):
                for jl, tl in zip(jg, tg):
                    assert tl.bits == jl.bits
                    for f in ("k", "v", "k_exp", "v_exp"):
                        assert torch.equal(getattr(tl, f)[:, 1:],
                                           getattr(jl, f)[:, 1:]), (step, f)
        assert te.stats["chunks"] == 3 and te.stats["ticks"] >= 1
