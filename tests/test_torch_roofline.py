"""PyTorch port vs the JAX reference: the roofline count (roofline/) and
ServeEngine.decode_cost.

  * the counterparts of tests/test_roofline.py: roofline_terms' dominance
    at the H100's peaks, a product's exact FLOPs, a stack of layers
    counting its layers;
  * decode_cost against the reference's (its engine on the gather path,
    from one init through models/convert.from_reference): flops within
    2%, gather_bytes equal at 16-bit pools and within 1% at kv_bits 8 and
    4, weight_bytes equal at weight_bits 16, 8 and 4;
  * the count does not move with the pool's capacity, nor with the route
    that does the work: a real CPU decode tick (the kernels' plain
    versions) counts what decode_cost's meta copy counts, on the paged and
    the dense backend, and each kernel wrapper records the same cost for
    CPU and meta inputs;
  * under a (1, 2) gloo mesh a rank's decode_cost records the collectives
    a real tick issues.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.nn.common import tree_flatten  # noqa: E402
from repro_torch.roofline import analyze  # noqa: E402
from repro_torch.roofline import count as rcount  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

import torch_roofline_ranks as R  # noqa: E402

KW = dict(slots=2, max_seq=256, page_size=8)
BUCKETS = (2, 8, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# counterparts of tests/test_roofline.py
# ---------------------------------------------------------------------------

def test_roofline_terms_dominance_at_h100_peaks():
    r = analyze.roofline_terms(flops=989e12, bytes_accessed=0.0,
                               collective_bytes=0.0, chips=1)
    assert r["dominant"] == "compute" and r["compute_s"] == pytest.approx(1.0)
    r = analyze.roofline_terms(flops=0.0, bytes_accessed=3.35e12,
                               collective_bytes=0.0, chips=1)
    assert r["dominant"] == "memory" and r["memory_s"] == pytest.approx(1.0)
    r = analyze.roofline_terms(flops=0.0, bytes_accessed=0.0,
                               collective_bytes=450e9, chips=4)
    assert (r["dominant"] == "collective"
            and r["collective_s"] == pytest.approx(1.0))
    r = analyze.roofline_terms(flops=0.0, bytes_accessed=0.0,
                               collective_bytes=0.0, chips=1,
                               ops_by_kind={"int8": 1979e12, "f32": 67e12})
    assert r["compute_s"] == pytest.approx(2.0)
    assert analyze.H100.name == "NVIDIA H100 80GB HBM3"
    assert analyze.H100.power_limit_w == 700
    assert analyze.bound(3.35e9, 0, "bf16") == (pytest.approx(1.0), "bytes")
    assert analyze.bound(0, 989e9, "bf16") == (pytest.approx(1.0),
                                               "operations")
    assert analyze.model_flops(10, 3) == 180
    assert analyze.model_flops(10, 3, training=False) == 60


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plain_matmul_flops_exact(device):
    a = torch.ones((256, 512), dtype=torch.bfloat16, device=device)
    b = torch.ones((512, 128), dtype=torch.bfloat16, device=device)
    with rcount.count() as t:
        a @ b
    assert t.flops == 2 * 256 * 512 * 128
    assert t.dot_bytes >= (256 * 512 + 512 * 128 + 256 * 128) * 2
    assert t.ops_by_kind == {"bf16": t.flops}


def test_stack_of_layers_counts_each_layer():
    """The counterpart of the reference's trip-count tests: eager code runs
    each of 7 product layers, and each is counted."""
    x = torch.ones((128, 128), device="meta")
    ws = torch.ones((7, 128, 128), device="meta")

    def stack(n):
        with rcount.count() as t:
            y = x
            for i in range(n):
                y = y @ ws[i]
        return t
    one, seven = stack(1), stack(7)
    assert seven.flops == 7 * one.flops == 7 * 2 * 128 ** 3
    assert seven.bytes == 7 * one.bytes
    assert seven.dot_bytes == 7 * one.dot_bytes


def test_counts_nest_and_close():
    a = torch.ones((4, 8))
    with rcount.count() as outer:
        a @ a.t()
        with rcount.count() as inner:
            a @ a.t()
    assert inner.flops == 2 * 4 * 8 * 4 and outer.flops == 2 * inner.flops
    assert not rcount.active()


# ---------------------------------------------------------------------------
# decode_cost against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inits():
    out = {}
    for arch in ("llama3.2-3b", "gemma-7b"):
        jcfg = jget_config(arch, smoke=True)
        tcfg = tget_config(arch, smoke=True)
        jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
        out[arch] = (jcfg, jparams, tcfg,
                     from_reference(jparams, tcfg, device="cpu"))
    return out


def _engines(inits, arch, **kw):
    jcfg, jparams, tcfg, tparams = inits[arch]
    je = jeng.ServeEngine(jcfg, jparams, jeng.EngineConfig(
        paged_impl="gather", telemetry=False, **KW, **kw))
    te = teng.ServeEngine(tcfg, tparams, teng.EngineConfig(**KW, **kw),
                          device="cpu")
    return je, te


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma-7b"])
def test_decode_cost_matches_reference(inits, arch):
    je, te = _engines(inits, arch)
    for b in BUCKETS:
        want, got = je.decode_cost(b), te.decode_cost(b)
        assert got["flops"] == pytest.approx(want["flops"], rel=0.02)
        assert got["gather_bytes"] == want["gather_bytes"]
        assert got["weight_bytes"] == want["weight_bytes"]
        assert got["launches"]["paged_attention"] == te.cfg.num_layers
        assert got["collective_bytes"] == 0 and got["collectives"] == {}
        assert got["roofline"]["dominant"] in ("compute", "memory")
        assert got["param_bytes_by_dtype"]["f32"] > got["weight_bytes"]


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_decode_cost_gather_bytes_at_kv_bits(inits, kv_bits):
    """The counterpart of tests/test_kv_quant.py's gather-bytes gate: the
    packed payload and exponent planes of the bucket's blocks."""
    je, te = _engines(inits, "llama3.2-3b", kv_bits=kv_bits)
    for b in BUCKETS:
        want, got = je.decode_cost(b), te.decode_cost(b)
        assert got["gather_bytes"] == pytest.approx(want["gather_bytes"],
                                                    rel=0.01)
        assert got["launches"][f"paged_attention_kv{kv_bits}"] == (
            te.cfg.num_layers)
    full = te.decode_cost(BUCKETS[-1])["gather_bytes"]
    _, t16 = _engines(inits, "llama3.2-3b")
    assert t16.decode_cost(BUCKETS[-1])["gather_bytes"] / full >= 1.8


@pytest.mark.parametrize("weight_bits", [8, 4])
def test_decode_cost_weight_bytes_at_weight_bits(inits, weight_bits):
    """The counterpart of tests/test_weight_quant.py's weight-bytes gate."""
    je, te = _engines(inits, "llama3.2-3b", weight_bits=weight_bits)
    want, got = je.decode_cost(8), te.decode_cost(8)
    assert got["weight_bytes"] == want["weight_bytes"]
    assert got["weight_bytes"] == te.metrics()["weight_bytes"]
    assert got["param_bytes_by_dtype"]["s8"] > 0
    assert got["launches"]["matmul_wq"] > 0
    assert got["flops"] == pytest.approx(want["flops"], rel=0.02)


def test_decode_cost_invariant_to_pool_capacity(inits):
    _, _, tcfg, tparams = inits["llama3.2-3b"]
    small = teng.ServeEngine(tcfg, tparams, teng.EngineConfig(**KW),
                             device="cpu").decode_cost(8)
    big = teng.ServeEngine(tcfg, tparams, teng.EngineConfig(
        **KW, num_blocks=1024), device="cpu").decode_cost(8)
    for key in ("gather_bytes", "dot_bytes", "flops", "bytes"):
        assert big[key] == small[key], key
    assert big["param_bytes"] > small["param_bytes"]


# ---------------------------------------------------------------------------
# the same count whatever route does the work
# ---------------------------------------------------------------------------

CASES = [("llama3.2-3b", {}), ("llama3.2-3b", {"paged": False}),
         ("llama3.2-3b", {"kv_bits": 4, "weight_bits": 4}),
         ("mamba2-1.3b", {})]


@pytest.mark.parametrize("arch,kw", CASES,
                         ids=["paged", "dense", "wq4-kv4", "mamba2-dense"])
def test_real_cpu_tick_counts_what_decode_cost_counts(arch, kw):
    """One real decode tick on the CPU (every kernel's plain version, the
    engine's tensors) counts exactly what decode_cost counts on meta
    copies; the engine's state is untouched by decode_cost, and the
    engine's meta copy counts what the engine counts."""
    cfg = tget_config(arch, smoke=True)
    params = tlm.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    e = teng.ServeEngine(cfg, params, teng.EngineConfig(
        slots=2, max_seq=64, page_size=8, **kw), device="cpu")
    b = e.decode_buckets[-1] if e.paged else None
    before = [t.clone() for t in e._state]
    meta = e.decode_cost(b)
    assert all(torch.equal(x, y) for x, y in zip(before, e._state))
    assert e.meta_copy().decode_cost(b) == meta
    with rcount.count() as t:
        e._decode_tick(b)
    real = rcount.decode_keys(t)
    for key in ("flops", "bytes", "dot_bytes", "gather_bytes"):
        assert meta[key] == real[key], key
    assert {k: v for k, v in meta["launches"].items() if v} == t.launches


def test_meta_copy_holds_nothing_of_the_engine():
    """ServeEngine.meta_copy: every tensor decode_cost reads is a meta
    tensor, and the copy does not keep the engine (its weights and pools)
    alive."""
    import gc
    import weakref
    cfg = tget_config("llama3.2-3b", smoke=True)
    params = tlm.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    e = teng.ServeEngine(cfg, params, teng.EngineConfig(
        slots=2, max_seq=64, page_size=8, weight_bits=4, kv_bits=4),
        device="cpu")
    want = e.decode_cost(4)
    probe, alive = e.meta_copy(), weakref.ref(e)
    del e, params
    gc.collect()
    assert alive() is None
    leaves = [t for tree in (probe.params, probe.caches, probe._state,
                             probe._key, probe._sp_dev, probe._table_dev)
              for _, x in tree_flatten(tree)
              for t in ((x.q, x.e) if hasattr(x, "q") else (x,))
              if torch.is_tensor(t)]
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert probe.decode_cost(4) == want


def _wrapper_calls(device):
    """Each kernel wrapper on small inputs on `device` (CPU or meta)."""
    from repro_torch.kernels import (flash_attention, grau, matmul_grau,
                                     matmul_wq, paged_attention)
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.quant import kv as kvq
    from repro_torch.quant import weights as wq
    gen = torch.Generator().manual_seed(0)
    rnd = (lambda *s: torch.randn(s, generator=gen))
    spec = build_lm_grau("silu").spec
    regs = spec.packed("cpu")
    kw = dict(num_exponents=spec.num_exponents, qmin=spec.qmin,
              qmax=spec.qmax)
    x32 = torch.randint(-5000, 5000, (4, 8), generator=gen,
                        dtype=torch.int32)
    x8 = torch.randint(-100, 100, (4, 64), generator=gen, dtype=torch.int8)
    w8 = torch.randint(-100, 100, (64, 16), generator=gen, dtype=torch.int8)
    w4 = wq.pack_tensor(rnd(64, 16), 4, -2, tile_k=32)
    xw, qd, qp = rnd(3, 64), rnd(2, 4, 16), rnd(1, 4, 4, 16)
    q, k, v = rnd(1, 8, 4, 16), rnd(1, 8, 2, 16), rnd(1, 8, 2, 16)
    o, lse = flash_attention.flash_attention(q, k, v)
    do = torch.ones_like(o)
    kp, ke = kvq.store_block(rnd(6, 8, 2, 16), 8)
    vp, ve = kvq.store_block(rnd(6, 8, 2, 16), 8)
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    lengths = torch.tensor([11, 5], dtype=torch.int32)
    m = (lambda x: wq.to_meta(x) if device == "meta" else x)
    return {
        "grau": lambda: grau.grau_unit(m(x32), m(regs), **kw),
        "matmul_grau": lambda: matmul_grau.matmul_grau(m(x8), m(w8),
                                                       m(regs), **kw),
        "matmul_wq": lambda: matmul_wq.matmul_wq(m(xw), m(w4),
                                                 spec),
        "flash_attention": lambda: flash_attention.flash_attention(
            m(q), m(k), m(v), causal=True, q_offset=2),
        "flash_attention_backward": lambda: (
            flash_attention.flash_attention_backward(
                m(q), m(k), m(v), m(o), m(lse), m(do))),
        "paged_attention": lambda: paged_attention.paged_attention(
            m(qd), m(kp), m(vp), m(table), m(lengths),
            k_exp=m(ke), v_exp=m(ve), kv_bits=8, spec=spec, s_in=0.01),
        "paged_prefill": lambda: paged_attention.paged_prefill_attention(
            m(qp), m(kp), m(vp), m(table[:1]),
            m(lengths[:1]), k_exp=m(ke), v_exp=m(ve), kv_bits=8),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls("cpu")))
def test_wrapper_cost_same_on_cpu_and_meta(name):
    counts = {}
    for device in ("cpu", "meta"):
        call = _wrapper_calls(device)[name]
        with rcount.count() as t:
            out = call()
        counts[device] = t
        outs = out if isinstance(out, tuple) else (out,)
        assert all(x.device.type == device for x in outs)
    cpu, meta = counts["cpu"], counts["meta"]
    assert cpu == meta
    assert cpu.bytes_by_op == {name: cpu.bytes} | (
        {"gather": cpu.bytes_by_op["gather"]}
        if name.startswith("paged") else {})
    assert cpu.launches == ({} if name.endswith("backward") else
                            {name: 1, **{f"{name}_{s}": 1 for s in
                                         {"grau": (), "matmul_grau": (),
                                          "matmul_wq": ("epilogue",),
                                          "flash_attention": (),
                                          "paged_attention": ("epilogue",
                                                              "kv8"),
                                          "paged_prefill": ("kv8",)}[name]}})
    assert cpu.bytes > 0 and (cpu.flops > 0) == (name != "grau")


def test_paged_cost_counts_the_bucket_blocks():
    """K/V bytes are those of the blocks the table maps (payload plus the
    exponent planes at kv 8), never the pool's capacity; `live_blocks`
    counts the blocks the data needs instead."""
    from repro_torch.kernels import paged_attention as pa
    q = torch.empty((2, 4, 16), device="meta")
    table = torch.empty((2, 3), dtype=torch.int32, device="meta")
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    for nb in (8, 1024):
        pool = torch.empty((nb, 8, 2, 16), dtype=torch.int8, device="meta")
        exp = torch.empty((nb, 2), dtype=torch.int8, device="meta")
        c = pa.cost(q, pool, table, lengths, spec=None,
                    out_dtype=torch.float32, k_exp=exp)
        assert c.gather == 2 * 6 * (8 * 2 * 16 + 2)
        assert c.flops == 4 * 4 * 16 * 6 * 8
    live = pa.cost(q, pool, table, lengths, spec=None,
                   out_dtype=torch.float32, k_exp=exp, live_blocks=4)
    assert live.gather == 2 * 4 * (8 * 2 * 16 + 2)


# ---------------------------------------------------------------------------
# under a mesh
# ---------------------------------------------------------------------------

def test_mesh_rank_counts_its_collectives(inits):
    """(1, 2) gloo ranks on llama3-smoke: each rank's decode_cost records
    the collectives (by op, count and bytes) a real tick issues, and counts
    its shard's work as the real tick does."""
    _, _, tcfg, tparams = inits["llama3.2-3b"]
    res = tmesh.spawn_ranks(R.decode_counts, 2, args=(tcfg, tparams, (2, 8)),
                            threads=1, join_s=300)
    _, te = None, teng.ServeEngine(tcfg, tparams, teng.EngineConfig(
        slots=2, max_seq=64, page_size=8), device="cpu")
    for rank in res:
        for b, c in rank.items():
            meta, real = c["meta"], c["real"]
            for key in ("collective_bytes", "collectives",
                        "collective_count", "flops", "bytes", "dot_bytes",
                        "gather_bytes"):
                assert meta[key] == real[key], (b, key)
            assert meta["collective_count"] > 0
            assert set(meta["collectives"]) == {"all-reduce", "all-gather"}
            # each rank reads its half of the KV heads' blocks
            one = te.decode_cost(b)
            assert one["gather_bytes"] > meta["gather_bytes"] > (
                one["gather_bytes"] / 2)
    assert res[0] == res[1]
    assert np.isfinite(res[0][8]["meta"]["roofline"]["collective_s"])
