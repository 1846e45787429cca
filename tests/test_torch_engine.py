"""PyTorch port vs the JAX reference: the serving engine and its host-side
bookkeeping. The port's ServeEngine on the CPU and the reference's
ServeEngine (gather path) serve the same requests with the same weights;
greedy token streams must be identical, with float activations and with
GRAU (cfg.grau for the MLP plus the fused attention-output epilogue).
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
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import kv_cache as jkvc  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models.config import GRAUConfig as TGRAUConfig  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.nn.common import build_lm_grau  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import kv_cache as tkvc  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(mod, vocab):
    rng = np.random.default_rng(4)
    return [mod.Request(rid=i, prompt=rng.integers(2, vocab, size=n),
                        max_new_tokens=m)
            for i, (n, m) in enumerate([(5, 8), (20, 6), (12, 8), (35, 7)])]


@pytest.mark.parametrize("grau", [False, True])
def test_engine_greedy_streams_match_reference(grau):
    jcfg = jget_config("llama3.2-3b", smoke=True)
    tcfg = tget_config("llama3.2-3b", smoke=True)
    jattn = tattn = None
    if grau:
        jcfg, tcfg = jcfg.replace(grau=JGRAUConfig()), tcfg.replace(
            grau=TGRAUConfig())
        jattn, tattn = jbuild_lm_grau("identity"), build_lm_grau("identity")
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = from_reference(jparams, tcfg, device="cpu")
    kw = dict(slots=2, max_seq=64, page_size=8)
    je = jeng.ServeEngine(jcfg, jparams, jeng.EngineConfig(
        paged_impl="gather", attn_grau=jattn, telemetry=False, **kw))
    te = teng.ServeEngine(tcfg, tparams, teng.EngineConfig(
        attn_grau=tattn, **kw), device="cpu")
    want = {r.rid: list(r.out_tokens)
            for r in je.run(_requests(jeng, jcfg.vocab_size))}
    got_reqs = te.run(_requests(teng, tcfg.vocab_size))
    got = {r.rid: list(r.out_tokens) for r in got_reqs}
    assert got == want
    assert all(len(v) >= 1 for v in got.values())
    assert te.allocator.free_blocks == te.allocator.num_blocks - 1
    assert te.stats["prefill_tokens"] == sum(n - 1 for n in (5, 20, 12, 35))


def test_engine_requires_a_device_choice_and_greedy_sampling():
    tcfg = tget_config("llama3.2-3b", smoke=True)
    from repro_torch.models import lm as tlm
    params = tlm.init_lm(tcfg, seed=0, dtype=torch.float32, device="cpu")
    eng = teng.ServeEngine(tcfg, params, teng.EngineConfig(
        slots=2, max_seq=64, page_size=8), device="cpu")
    with pytest.raises(NotImplementedError, match="A5"):
        eng.submit(teng.Request(rid=0, prompt=np.array([3, 4]),
                                sampling=SamplingParams(temperature=0.7)))
    with pytest.raises(ValueError):
        eng.submit(teng.Request(rid=1, prompt=np.array([3] * 60),
                                max_new_tokens=8))
    with pytest.raises(ValueError):
        teng.ServeEngine(tcfg, params, teng.EngineConfig(paged_impl="nope"),
                         device="cpu")
    assert eng.warmup() == len(eng.decode_buckets) + len(eng.chunk_widths)
    assert eng.allocator.free_blocks == eng.allocator.num_blocks - 1


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 64, 129])
def test_bucket_ladders_match_reference(n):
    assert tkvc.decode_block_buckets(n) == jkvc.decode_block_buckets(n)
    assert tkvc.default_buckets(n * 8, 8) == jkvc.default_buckets(n * 8, 8)
    for chunk in (8, 16, 32):
        for cached in (0, chunk, 2 * chunk):
            assert (tkvc.chunk_starts(cached, n * 5, chunk)
                    == jkvc.chunk_starts(cached, n * 5, chunk))
        buckets = tkvc.decode_block_buckets(n + chunk // 8)
        for p0 in range(0, n * 8, chunk):
            assert (tkvc.chunk_table_width(p0, chunk, 8, buckets)
                    == jkvc.chunk_table_width(p0, chunk, 8, buckets))


def test_chunk_starts_off_grid_raises_like_reference():
    for mod in (tkvc, jkvc):
        with pytest.raises(ValueError, match="off the chunk grid"):
            mod.chunk_starts(5, 40, 16)


@pytest.mark.parametrize("bad", ["double", "null", "range", "never"])
def test_block_allocator_errors_match_reference(bad):
    outcome = []
    for mod in (tkvc, jkvc):
        a = mod.BlockAllocator(8)
        got = a.alloc(3)
        ids = {"double": [got[0], got[0]], "null": [0], "range": [8],
               "never": [6]}[bad]
        with pytest.raises(ValueError) as e:
            a.free(ids)
        outcome.append((got, str(e.value), a.free_blocks,
                        sorted(a.live_block_ids())))
    assert outcome[0] == outcome[1]
    with pytest.raises(ValueError):
        tkvc.BlockAllocator(1)
