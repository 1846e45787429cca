"""PyTorch port vs the JAX reference: the analytic hardware cost model
(Table VI, the KV and weight memory tables) and the Multi-Threshold baseline.

The cost model is pure Python in both packages: every report equals the
reference's field for field over the Table VI sweep and the llama3.2-3b /
smoke configurations. The MT thresholds and `mt_apply_int` are identical on
the same folded targets, and a non-monotone target raises the same error
(paper Fig. 1).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.core import hwcost as jh  # noqa: E402
from repro.core import multithreshold as jmt  # noqa: E402
from repro.core.folding import fold as jfold  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.core import hwcost as th  # noqa: E402
from repro_torch.core import multithreshold as tmt  # noqa: E402
from repro_torch.core.folding import fold as tfold  # noqa: E402


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_table6_sweep_identical():
    assert th.PAPER_TABLE6 == jh.PAPER_TABLE6
    assert th.DATAPATH_BITS == jh.DATAPATH_BITS
    for design in ("pipelined", "serialized"):
        for bits in (1, 2, 4, 8):
            _same(th.mt_cost(bits, design), jh.mt_cost(bits, design))
        for mode in ("pot", "apot"):
            for seg in (4, 6, 8):
                for ne in (4, 8, 16):
                    _same(th.grau_cost(seg, ne, mode, design),
                          jh.grau_cost(seg, ne, mode, design))
    r = th.grau_cost(6, 8, "apot")
    assert th.adp(r, 4.0) == jh.adp(jh.grau_cost(6, 8, "apot"), 4.0)
    assert th.pdp(0.5, 4.0) == jh.pdp(0.5, 4.0)


def test_table6_headline_claims():
    """>90% fewer LUTs than the pipelined MT unit for every GRAU instance;
    the calibrated model within 1.4% of the paper's pipelined GRAU rows."""
    mt = th.mt_cost(8, "pipelined").lut
    assert mt == th.PAPER_TABLE6[("multi-threshold", "pipelined")]["lut"]
    for key, want in th.PAPER_TABLE6.items():
        if key[0] == "multi-threshold" or key[1] != "pipelined":
            continue
        r = th.grau_cost(key[2], key[3], key[0].split("-")[0])
        assert abs(r.lut - want["lut"]) <= 0.014 * want["lut"]
        assert r.lut < 0.1 * mt


def _memory_kw(cfg):
    return dict(num_layers=cfg.num_layers, kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim)


@pytest.mark.parametrize("smoke", [False, True])
def test_kv_and_weight_cost_identical(smoke):
    jc = jget_config("llama3.2-3b", smoke=smoke)
    tc = tget_config("llama3.2-3b", smoke=smoke)
    for bits in (16, 8, 4):
        for bs, slots, max_seq, ctx in ((16, 8, 2048, None), (8, 2, 64, 17)):
            kw = dict(block_size=bs, kv_bits=bits, slots=slots,
                      max_seq=max_seq, ctx=ctx)
            _same(th.kv_cache_cost(**_memory_kw(tc), **kw),
                  jh.kv_cache_cost(num_layers=jc.num_layers,
                                   kv_heads=jc.kv_heads_phys,
                                   head_dim=jc.head_dim, **kw))
        wkw = dict(d_model=tc.d_model, num_heads=tc.num_heads,
                   kv_heads=tc.num_kv_heads, head_dim=tc.head_dim,
                   d_ff=tc.d_ff, gated=tc.gated_mlp,
                   vocab_size=tc.vocab_size, tied=tc.tie_embeddings,
                   weight_bits=bits)
        _same(th.weight_cost(num_layers=tc.num_layers, **wkw),
              jh.weight_cost(num_layers=jc.num_layers, **wkw))
    with pytest.raises(ValueError, match="kv_bits"):
        th.kv_cache_cost(**_memory_kw(tc), block_size=16, kv_bits=2,
                         slots=1, max_seq=16)
    with pytest.raises(ValueError, match="weight_bits"):
        th.weight_cost(num_layers=1, d_model=8, num_heads=1, kv_heads=1,
                       head_dim=8, d_ff=8, gated=True, vocab_size=8,
                       tied=True, weight_bits=2)


@pytest.mark.parametrize("act,bits,signed", [("relu", 8, True),
                                             ("sigmoid", 4, False),
                                             ("relu", 2, False)])
def test_mt_thresholds_and_apply_identical(act, bits, signed):
    s_out = 2 ** -8 if act == "sigmoid" else 2 ** -4
    kw = dict(s_in=2 ** -10, s_out=s_out, out_bits=bits, out_signed=signed)
    jf, tf = jfold(act, **kw), tfold(act, **kw)
    js = jmt.fit_thresholds(jf, -20000, 20000, bits, out_signed=signed)
    ts = tmt.fit_thresholds(tf, -20000, 20000, bits, out_signed=signed)
    assert (ts.out_bits, ts.out_signed, ts.qmin) == (js.out_bits,
                                                     js.out_signed, js.qmin)
    np.testing.assert_array_equal(ts.thresholds.numpy(),
                                  np.asarray(js.thresholds))
    x = np.random.default_rng(0).integers(-30000, 30000, size=(50, 40),
                                          dtype=np.int32)
    got = tmt.mt_apply_int(torch.from_numpy(x), ts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmt.mt_apply_int(jnp.asarray(x), js)))


def test_mt_refuses_a_non_monotone_target_like_the_reference():
    kw = dict(s_in=2 ** -10, s_out=2 ** -6, out_bits=8)
    msgs = []
    for mod, f in ((jmt, jfold("silu", **kw)), (tmt, tfold("silu", **kw))):
        with pytest.raises(ValueError, match="Fig. 1") as e:
            mod.fit_thresholds(f, -20000, 20000, 8)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    js = jmt.fit_thresholds(jfold("silu", **kw), -20000, 20000, 8, force=True)
    ts = tmt.fit_thresholds(tfold("silu", **kw), -20000, 20000, 8, force=True)
    np.testing.assert_array_equal(ts.thresholds.numpy(),
                                  np.asarray(js.thresholds))
