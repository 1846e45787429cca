"""PyTorch port vs the JAX reference: PoT-quantized serving end to end.

The port's ServeEngine on the CPU (its kernels' plain versions: matmul_wq
for the MLP, the paged kernels on packed pools) and the reference's engine
(gather path) serve the same requests with the same f32 weights of
llama3-smoke, at weight_bits 8 and 4, and int4 weights + int4 KV + the
GRAU MLP activation + the fused GRAU attention epilogue. The reference runs
under both of its weight-matmul implementations (`use_impl("dense")` and
the interpreted Pallas kernel); the greedy token streams must be identical
to both. (kv_bits 8 and 4 alone, and the pool bytes, are in
test_torch_engine_kv_quant.py.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import GRAUConfig as JGRAUConfig  # noqa: E402
from repro.nn.common import build_lm_grau as jbuild_lm_grau  # noqa: E402
from repro.quant import policy as jpol  # noqa: E402
from repro.quant import weights as jwq  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models.config import GRAUConfig as TGRAUConfig  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.nn.common import build_lm_grau  # noqa: E402
from repro_torch.quant import policy as tpol  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

PAGE = 8
COMPOSITIONS = {
    "wq8": dict(weight_bits=8),
    "wq4": dict(weight_bits=4),
    "wq4_kv4_grau": dict(weight_bits=4, kv_bits=4),
}


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
    for impl in ("dense", "kernel_interpret"):
        want, je = _ref_streams(jcfg, smoke_params, jattn, quant, impl)
        assert got == want, impl
    assert all(len(v) >= 1 for v in got.values())
    assert te.allocator.free_blocks == te.allocator.num_blocks - 1
    jm, tm = je.metrics(), te.metrics()
    for key in ("weight_bits", "weights_quantized", "weight_bytes",
                "kv_bits", "kv_quantized"):
        assert tm[key] == jm[key], key


def test_precision_shorthands_match_reference(smoke_params):
    jcfg = jget_config("llama3.2-3b", smoke=True)
    tcfg = tget_config("llama3.2-3b", smoke=True)
    tparams = from_reference(smoke_params, tcfg, device="cpu")
    for kw, pol_j, pol_t in ((dict(kv_bits=8), jpol.kv_policy(8),
                              tpol.kv_policy(8)),
                             (dict(weight_bits=8), jpol.weight_policy(8),
                              tpol.weight_policy(8))):
        msgs = []
        for mod, cfg, params, pol, extra in (
                (jeng, jcfg, smoke_params, pol_j, dict(telemetry=False)),
                (teng, tcfg, tparams, pol_t, {})):
            with pytest.raises(ValueError, match="not both") as e:
                mod.ServeEngine(cfg, params, mod.EngineConfig(
                    slots=1, max_seq=32, precision=pol, **kw, **extra),
                    **({} if mod is jeng else {"device": "cpu"}))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    eng = teng.ServeEngine(tcfg, tparams, teng.EngineConfig(
        slots=1, max_seq=32, page_size=PAGE, weight_bits=8, kv_bits=4),
        device="cpu")
    assert eng.precision.weight_default_bits == 8
    assert eng.precision.kv_default_bits == 4
    # an explicit policy with per-layer rules drives packing and pools
    pol = tpol.PrecisionPolicy(weight_rules=((r"embed", 8),),
                               kv_rules=((r"group0\.l0", 4),))
    eng = teng.ServeEngine(tcfg, tparams, teng.EngineConfig(
        slots=1, max_seq=32, page_size=PAGE, precision=pol), device="cpu")
    m = eng.metrics()
    assert m["weight_bits"] == [8, 16] and m["kv_bits"] == 4
    assert m["weights_quantized"] and m["kv_quantized"]
    with pytest.raises(ValueError, match="weight_bits"):
        teng.ServeEngine(tcfg, tparams, teng.EngineConfig(
            slots=1, max_seq=32, weight_bits=6), device="cpu")
    with pytest.raises(ValueError, match="kv_bits"):
        teng.ServeEngine(tcfg, tparams, teng.EngineConfig(
            slots=1, max_seq=32, kv_bits=2), device="cpu")
