"""PyTorch port vs the JAX reference: the power-of-two quantization substrate
(quant/pot, quant/kv, quant/weights, quant/policy) byte for byte.

Every stored byte must be identical at 8 and 4 bits, with no tolerance:
PoT exponents (including +-0, subnormals and values at the clip), payloads,
requantization shifts for deltas 0..40, int4 nibbles, whole KV blocks with
and without the padding mask, the quantized decode write (setting and
bumping a block's exponent), every packed leaf of llama3-smoke (packed per
repeat in the port, stacked in the reference) and the dequantized f32
views. The error paths raise what the reference raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.quant import kv as jkv  # noqa: E402
from repro.quant import policy as jpol  # noqa: E402
from repro.quant import pot as jpot  # noqa: E402
from repro.quant import weights as jwq  # noqa: E402
from repro.serve import kv_cache as jkvc  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.quant import kv as tkv  # noqa: E402
from repro_torch.quant import policy as tpol  # noqa: E402
from repro_torch.quant import pot as tpot  # noqa: E402
from repro_torch.quant import weights as twq  # noqa: E402
from repro_torch.serve import kv_cache as tkvc  # noqa: E402

BS = 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(want[:0].copy()).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def _edge_values(rng, n):
    """Random magnitudes over many octaves plus the hard cases."""
    x = rng.normal(size=n) * np.exp2(rng.integers(-140, 126, size=n))
    tiny = np.float32(np.finfo(np.float32).tiny)
    edges = [0.0, -0.0, tiny, -tiny, tiny / 2, tiny / 1024, 1e-45, -1e-45,
             np.float32(np.finfo(np.float32).max), 2.0 ** 127, 2.0 ** 126,
             2.0 ** -126, 2.0 ** -133, 1.0, 0.5, 127.0, 127.5, 7.5, 8.0]
    x[:len(edges)] = edges
    return x.astype(np.float32)


def test_exp2i_exact_and_identical_over_full_range():
    e = np.arange(-126, 127, dtype=np.int32)
    got = tpot.exp2i(_t(e))
    _same(got, jpot.exp2i(jnp.asarray(e)))
    np.testing.assert_array_equal(got.double().numpy(),
                                  np.ldexp(1.0, np.arange(-126, 127)))


@pytest.mark.parametrize("bits", [8, 4])
def test_pot_exponent_and_quantize_bytes_match_reference(bits):
    rng = np.random.default_rng(bits)
    amax = np.abs(_edge_values(rng, 4096))
    _same(tpot.pot_exponent(_t(amax), bits),
          jpot.pot_exponent(jnp.asarray(amax), bits))
    x = _edge_values(rng, 4096)
    e = rng.integers(-126, 127, size=x.shape).astype(np.int8)
    e[:64] = np.asarray(jpot.pot_exponent(jnp.abs(jnp.asarray(x[:64])), bits))
    _same(tpot.quantize_pot(_t(x), _t(e), bits),
          jpot.quantize_pot(jnp.asarray(x), jnp.asarray(e), bits))
    q = rng.integers(-tpot.pot_qmax(bits), tpot.pot_qmax(bits) + 1,
                     size=4096).astype(np.int8)
    _same(tpot.dequantize_pot(_t(q), _t(e)),
          jpot.dequantize_pot(jnp.asarray(q), jnp.asarray(e)))


@pytest.mark.parametrize("bits", [8, 4])
def test_requant_shift_bytes_match_reference_for_deltas_0_to_40(bits):
    qmax = tpot.pot_qmax(bits)
    q = np.tile(np.arange(-qmax, qmax + 1, dtype=np.int8), 41)
    delta = np.repeat(np.arange(41, dtype=np.int32), 2 * qmax + 1)
    _same(tpot.requant_shift(_t(q), _t(delta), bits),
          jpot.requant_shift(jnp.asarray(q), jnp.asarray(delta), bits))


def test_int4_pack_unpack_bytes_match_reference():
    rng = np.random.default_rng(3)
    q = rng.integers(-7, 8, size=(5, 3, 64)).astype(np.int8)
    q[0, 0, :16] = [-8, -7, -1, 0, 1, 7, -8, 0, 7, -1, 3, -3, 4, -4, 5, -5]
    packed = tpot.pack_int4(_t(q))
    _same(packed, jpot.pack_int4(jnp.asarray(q)))
    b = rng.integers(-128, 128, size=(4, 32)).astype(np.int8)
    _same(tpot.unpack_int4(_t(b)), jpot.unpack_int4(jnp.asarray(b)))
    _same(tpot.unpack_int4(packed), q)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_store_and_load_block_match_reference(bits, masked):
    rng = np.random.default_rng(10 * bits + masked)
    x = (rng.normal(size=(3, BS, 2, 16))
         * np.exp2(rng.integers(-20, 20, size=(3, 1, 2, 1)))).astype(np.float32)
    x[1, 5:] = 1e4                        # padding rows that must not count
    valid = np.arange(BS)[None].repeat(3, 0) < np.array([[BS], [5], [1]])
    jv = jnp.asarray(valid) if masked else None
    tv = _t(valid) if masked else None
    for i in range(3):
        want_q, want_e = jkv.store_block(jnp.asarray(x[i]), bits,
                                         valid=None if jv is None else jv[i])
        got_q, got_e = tkv.store_block(_t(x[i]), bits,
                                       valid=None if tv is None else tv[i])
        _same(got_q, want_q)
        _same(got_e, want_e)
        _same(tkv.load_block(got_q, got_e, bits),
              jkv.load_block(want_q, want_e, bits))
    # batched over blocks, as the port's prefill write calls it
    got_q, got_e = tkv.store_block(_t(x), bits, valid=tv)
    for i in range(3):
        want_q, want_e = jkv.store_block(jnp.asarray(x[i]), bits,
                                         valid=None if jv is None else jv[i])
        _same(got_q[i], want_q)
        _same(got_e[i], want_e)


def _quant_pools(rng, nb, kvh, hd, bits):
    """The same random quantized pool for both packages (numpy arrays)."""
    hdp = hd // 2 if bits == 4 else hd
    k = rng.integers(-128, 128, size=(nb, BS, kvh, hdp)).astype(np.int8)
    v = rng.integers(-128, 128, size=(nb, BS, kvh, hdp)).astype(np.int8)
    ke = rng.integers(-12, -2, size=(nb, kvh)).astype(np.int8)
    ve = rng.integers(-12, -2, size=(nb, kvh)).astype(np.int8)
    ke[3] = ve[3] = tkv.EXP_EMPTY               # a never-written block
    return k, v, ke, ve


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_decode_write_sets_then_bumps_like_reference(bits):
    """The decode write into a quantized pool (plain torch in both
    packages): first write into an empty block sets its exponent, a larger
    one bumps it and requantizes the resident payload; every byte of the
    pool and its exponent planes equals the reference's after each write."""
    rng = np.random.default_rng(bits)
    kvh, hd, nb = 2, 16, 6
    k, v, ke, ve = _quant_pools(rng, nb, kvh, hd, bits)
    jc = jattn.QuantPagedKVCache(*(jnp.asarray(a) for a in (k, v, ke, ve)),
                                 bits=bits)
    tc = tattn.QuantPagedKVCache(*(_t(a.copy()) for a in (k, v, ke, ve)),
                                 bits=bits)
    table = np.array([[3, 1], [2, 5], [0, 0]], np.int32)   # slot 2 idle
    for length, scale in ((np.array([0, 9, 0]), 0.01),      # sets block 3
                          (np.array([1, 10, 0]), 100.0),    # bumps 3 and 5
                          (np.array([2, 11, 0]), 1e-3)):    # no bump
        new = (rng.normal(size=(3, 1, kvh, hd)) * scale).astype(np.float32)
        st_j = jattn.PagedState(jnp.asarray(table), jnp.asarray(length,
                                                                 jnp.int32))
        st_t = tattn.PagedState(_t(table), _t(length.astype(np.int32)))
        jc = jattn.paged_update(jc, jnp.asarray(new), jnp.asarray(new), st_j)
        tattn.paged_update(tc, _t(new), _t(new), st_t)
        live = [b for b in range(nb) if b != 0]    # block 0: idle-slot trash
        for got, want in ((tc.k, jc.k), (tc.v, jc.v), (tc.k_exp, jc.k_exp),
                          (tc.v_exp, jc.v_exp)):
            _same(got[live], np.asarray(want)[live])
    assert int(tc.k_exp[3].min()) > tkv.EXP_EMPTY


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_prefill_write_matches_reference(bits):
    """Whole-block prefill writes set each block's exponent, with the chunk
    padding (positions >= ctx) kept out of the amax."""
    rng = np.random.default_rng(20 + bits)
    kvh, hd, nb = 2, 16, 10
    k, v, ke, ve = _quant_pools(rng, nb, kvh, hd, bits)
    new = (rng.normal(size=(2, 2 * BS, kvh, hd)) * 0.3).astype(np.float32)
    new[0, 11:] = 1e4                            # padding past ctx = 11
    table = np.array([[4, 7, 2, 0], [8, 1, 0, 0]], np.int32)
    start = np.array([0, 0], np.int32)
    ctx = np.array([11, 16], np.int32)
    for with_ctx in (True, False):
        jc = jattn.QuantPagedKVCache(*(jnp.asarray(a) for a in (k, v, ke, ve)),
                                     bits=bits)
        tc = tattn.QuantPagedKVCache(*(_t(a.copy()) for a in (k, v, ke, ve)),
                                     bits=bits)
        jst = jattn.PagedState(jnp.asarray(table), jnp.asarray(start),
                               jnp.asarray(ctx) if with_ctx else None)
        tst = tattn.PagedState(_t(table), _t(start),
                               _t(ctx) if with_ctx else None)
        jc = jattn.paged_prefill_update(jc, jnp.asarray(new),
                                        jnp.asarray(new), jst)
        tattn.paged_prefill_update(tc, _t(new), _t(new), tst)
        for got, want in ((tc.k, jc.k), (tc.v, jc.v), (tc.k_exp, jc.k_exp),
                          (tc.v_exp, jc.v_exp)):
            _same(got, want)
        kd_t, _ = tattn.paged_view(tc, tst)
        kd_j, _ = jattn.paged_view(jc, jst)
        _same(kd_t, kd_j)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("bits", [8, 4])
def test_pack_params_per_repeat_matches_reference_bytes(bits):
    """Every packable leaf of llama3-smoke: the port packs each repeat on its
    own, the reference packs the stacked leaf whole; the bytes of every
    repeat must be the reference's slice."""
    jcfg = jget_config("llama3.2-3b", smoke=True)
    tcfg = tget_config("llama3.2-3b", smoke=True)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    pol_j, pol_t = jpol.weight_policy(bits), tpol.weight_policy(bits)
    jpacked = jwq.pack_params(jparams, jcfg, pol_j)
    mine = twq.pack_params(from_reference(jparams, tcfg, device="cpu"), tcfg, pol_t)
    theirs = from_reference(jpacked, tcfg, device="cpu")          # the reference's bytes
    want_leaves = dict(_flat_leaves({k: v for k, v in theirs.items()
                                     if not k.startswith("group")}))
    got_leaves = dict(_flat_leaves({k: v for k, v in mine.items()
                                    if not k.startswith("group")}))
    for r, (rep_got, rep_want) in enumerate(zip(mine["group0"],
                                                theirs["group0"])):
        got_leaves.update(_flat_leaves(rep_got, f"group0.{r}"))
        want_leaves.update(_flat_leaves(rep_want, f"group0.{r}"))
    assert got_leaves.keys() == want_leaves.keys()
    packed = 0
    for name, want in want_leaves.items():
        got = got_leaves[name]
        assert type(got) is type(want), name
        if isinstance(want, twq.QuantWeight):
            packed += 1
            for f in ("bits", "caxis", "kdim", "tile"):
                assert getattr(got, f) == getattr(want, f), (name, f)
            assert torch.equal(got.q, want.q), name
            assert torch.equal(got.e, want.e), name
            assert torch.equal(twq.dense(got), twq.dense(want)), name
        else:
            assert torch.equal(got, want), name
    # wq/wk/wv/wo + w_gate/w_up/w_down per layer and repeat, and the embed
    assert packed == 7 * tcfg.num_layers + 1
    assert (twq.packed_param_bytes(mine)
            == jwq.packed_param_bytes(jpacked))


@pytest.mark.parametrize("bits", [8, 4])
def test_pack_params_llama4_leaves_moe_float_matches_reference_bytes(bits):
    """llama4-smoke (a dense layer, then an MoE layer with a shared
    expert, an untied head): the reference packs no MoE subtree, and
    neither does the port; every other leaf's bytes (the dense layer's MLP,
    both layers' attention, the embedding and the head) are the
    reference's, and so is the tree's byte count."""
    arch = "llama4-maverick-400b-a17b"
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    pol_j, pol_t = jpol.weight_policy(bits), tpol.weight_policy(bits)
    jpacked = jwq.pack_params(jparams, jcfg, pol_j)
    mine = twq.pack_params(from_reference(jparams, tcfg, device="cpu"), tcfg,
                           pol_t)
    theirs = from_reference(jpacked, tcfg, device="cpu")

    def flat(tree):
        out = dict(_flat_leaves({k: v for k, v in tree.items()
                                 if not k.startswith("group")}))
        for r, rep in enumerate(tree["group0"]):
            out.update(_flat_leaves(rep, f"group0.{r}"))
        return out
    got, want = flat(mine), flat(theirs)
    assert got.keys() == want.keys()
    packed = []
    for name, w in want.items():
        g = got[name]
        assert type(g) is type(w), name
        if isinstance(w, twq.QuantWeight):
            packed.append(name)
            assert (g.bits, g.caxis, g.kdim, g.tile) == (
                w.bits, w.caxis, w.kdim, w.tile), name
            assert torch.equal(g.q, w.q) and torch.equal(g.e, w.e), name
        else:
            assert torch.equal(g, w), name
    moe = [n for n in got if ".moe." in n]
    assert len(moe) == 7 and not set(moe) & set(packed)
    assert {n.rsplit(".", 1)[-1] for n in packed if ".mlp." in n} == {
        "w_gate", "w_up", "w_down"}
    # 4 attention projections x 2 layers, the dense MLP, embed and head
    assert len(packed) == 8 + 3 + 2
    assert (twq.packed_param_bytes(mine)
            == jwq.packed_param_bytes(jpacked))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,caxis", [((64, 24), -2), ((48, 40), -1),
                                         ((1024, 16), -2),
                                         ((32, 3, 16), -3), ((4, 16, 32), -2)])
def test_pack_tensor_and_dense_match_reference(bits, shape, caxis):
    rng = np.random.default_rng(sum(shape) + bits)
    w = (rng.normal(size=shape)
         * np.exp2(rng.integers(-8, 8, size=shape))).astype(np.float32)
    j = jwq.pack_tensor(jnp.asarray(w), bits, caxis)
    t = twq.pack_tensor(_t(w), bits, caxis)
    assert (t.bits, t.caxis, t.kdim, t.tile) == (j.bits, j.caxis, j.kdim,
                                                 j.tile)
    _same(t.q, j.q)
    _same(t.e, j.e)
    _same(twq.dense(t), jwq.dense(j))
    # bf16 dequant is the same values (exact in bf16)
    assert torch.equal(twq.dense(t, torch.bfloat16).float(), twq.dense(t))


@pytest.mark.parametrize("bits", [8, 4])
def test_take_rows_matches_reference(bits):
    rng = np.random.default_rng(bits)
    w = rng.normal(size=(40, 48)).astype(np.float32)
    idx = np.array([[3, 39, 0], [7, 7, 12]], np.int32)
    j = jwq.pack_tensor(jnp.asarray(w), bits, -1)
    t = twq.pack_tensor(_t(w), bits, -1)
    _same(twq.take_rows(t, _t(idx)), jwq.take_rows(j, jnp.asarray(idx)))
    assert torch.equal(twq.take_rows(_t(w), _t(idx)), _t(w)[_t(idx).long()])
    with pytest.raises(ValueError, match="take_rows"):
        twq.take_rows(twq.pack_tensor(_t(w), bits, -2), _t(idx))


def test_pack_tensor_odd_axis_raises_like_reference():
    """The case the reference's hypothesis generator reaches: a (4, 1)
    tensor packed at 4 bits along its odd last axis."""
    w = np.arange(4, dtype=np.float32).reshape(4, 1)
    msgs = []
    for mod, arr in ((jwq, jnp.asarray(w)), (twq, _t(w))):
        with pytest.raises(ValueError, match="is odd") as e:
            mod.pack_tensor(arr, 4, -1)
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match="16-bit"):
            mod.pack_tensor(arr, 16, -2)
        with pytest.raises(ValueError, match="weight_bits"):
            mod.pack_tensor(arr, 5, -2)
    assert msgs[0] == msgs[1]
    # the even case packs in both
    _same(twq.pack_tensor(_t(w.reshape(2, 2)), 4, -1).q,
          jwq.pack_tensor(jnp.asarray(w.reshape(2, 2)), 4, -1).q)


def test_effective_tile_matches_reference():
    for k in (1, 7, 48, 512, 513, 1024, 1536, 3072, 8192, 24576, 3000):
        assert twq.effective_tile(k) == jwq.effective_tile(k)


@pytest.mark.parametrize("field,value,where", [
    ("d_model", 127, "d_model=127"), ("head_dim", 31, "head_dim=31"),
    ("d_ff", 255, "d_ff=255")])
def test_validate_weight_packing_errors_match_reference(field, value, where):
    jcfg = jget_config("llama3.2-3b", smoke=True).replace(**{field: value})
    tcfg = tget_config("llama3.2-3b", smoke=True).replace(**{field: value})
    msgs = []
    for mod, pol, cfg in ((jwq, jpol, jcfg), (twq, tpol, tcfg)):
        with pytest.raises(ValueError, match=where) as e:
            mod.validate_weight_packing(cfg, pol.weight_policy(4))
        msgs.append(str(e.value))
        mod.validate_weight_packing(cfg, pol.weight_policy(8))
    assert msgs[0] == msgs[1]


def test_validate_pool_packing_errors_match_reference():
    jcfg = jget_config("llama3.2-3b", smoke=True).replace(head_dim=31)
    tcfg = tget_config("llama3.2-3b", smoke=True).replace(head_dim=31)
    for args, match in (((4, "group0.l0"), "head_dim=31 is odd"),
                        ((3,), "kv_bits")):
        msgs = []
        for mod, cfg in ((jkvc, jcfg), (tkvc, tcfg)):
            with pytest.raises(ValueError, match=match) as e:
                mod.validate_pool_packing(cfg, BS, *args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for mod, cfg in ((jkvc, jcfg), (tkvc, tcfg)):
        with pytest.raises(ValueError, match="block_size"):
            mod.validate_pool_packing(cfg, 0, 8)
    with pytest.raises(ValueError, match="head_dim=31 is odd"):
        tkvc.init_paged_caches(tcfg, 9, BS, device="cpu",
                               policy=tpol.kv_policy(4))


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_pool_construction_matches_reference(bits):
    jcfg = jget_config("llama3.2-3b", smoke=True)
    tcfg = tget_config("llama3.2-3b", smoke=True)
    jp = jkvc.init_paged_caches(jcfg, 9, BS, dtype=jnp.float32,
                                policy=jpol.kv_policy(bits))
    tp = tkvc.init_paged_caches(tcfg, 9, BS, dtype=torch.float32,
                                device="cpu", policy=tpol.kv_policy(bits))
    for jg, tg in zip(jp, tp):
        for jl, tl in zip(jg, tg):
            if bits == 16:
                assert isinstance(tl, tattn.PagedKVCache)
                _same(tl.k, jl.k)
                continue
            assert isinstance(tl, tattn.QuantPagedKVCache) and tl.bits == bits
            for name in ("k", "v", "k_exp", "v_exp"):
                _same(getattr(tl, name), getattr(jl, name))
    assert (tkvc.kv_bits_by_layer(tcfg, tpol.kv_policy(bits))
            == jkvc.kv_bits_by_layer(jcfg, jpol.kv_policy(bits)))


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------

def test_policy_rules_match_reference():
    names = ["group0.l0", "group0.l1", "group1.l0", "embed", "head",
             "stage0.conv", "stage2/conv", "fc", "classifier", "x"]
    rules = dict(kv_rules=((r"group0\.l0", 8), (r"group1", 4)),
                 kv_default_bits=16,
                 weight_rules=((r"group0", 4), (r"embed", 8)),
                 weight_default_bits=16)
    pj, pt = jpol.PrecisionPolicy(**rules), tpol.PrecisionPolicy(**rules)
    for n in names:
        assert pt.kv_bits_for(n) == pj.kv_bits_for(n)
        assert pt.weight_bits_for(n) == pj.weight_bits_for(n)
        assert pt.bits_for(n) == pj.bits_for(n)
        assert (tpol.PAPER_MIXED.bits_for(n) == jpol.PAPER_MIXED.bits_for(n))
        assert (tpol.PAPER_MIXED.qconfig_for(n).qmax
                == jpol.PAPER_MIXED.qconfig_for(n).qmax)
    assert pt.kv_quantized == pj.kv_quantized
    assert pt.weights_quantized == pj.weights_quantized
    for b in (16, 8, 4):
        for mod in (tpol, jpol):
            assert mod.kv_policy(b).kv_quantized == (b < 16)
            assert mod.weight_policy(b).weights_quantized == (b < 16)
        assert (tpol.unified(b).default_bits == jpol.unified(b).default_bits)
    w = pt.with_kv(8).with_weights(4, ((r"embed", 8),))
    assert (w.kv_default_bits, w.weight_default_bits, w.weight_rules) == (
        8, 4, ((r"embed", 8),))
    assert not tpol.PAPER_MIXED.kv_quantized
    assert not tpol.PAPER_MIXED.weights_quantized
    tcfg = tget_config("llama3.2-3b", smoke=True)
    jcfg = jget_config("llama3.2-3b", smoke=True)
    assert (twq.weight_bits_by_layer(tcfg, pt)
            == jwq.weight_bits_by_layer(jcfg, pj))
    assert (twq.weight_bits_by_layer(tcfg, None)
            == jwq.weight_bits_by_layer(jcfg, None))


@pytest.mark.parametrize("kw", [dict(kv_default_bits=5),
                                dict(weight_default_bits=2),
                                dict(kv_rules=(("x", 12),)),
                                dict(weight_rules=(("y", 32),))])
def test_policy_rejects_bad_widths_like_reference(kw):
    msgs = []
    for mod in (jpol, tpol):
        with pytest.raises(ValueError) as e:
            mod.PrecisionPolicy(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for mod in (jkv, tkv):
        with pytest.raises(ValueError, match="kv_bits"):
            mod.validate_kv_bits(2)
        with pytest.raises(ValueError, match="odd"):
            mod.packed_head_dim(31, 4)
        assert mod.packed_head_dim(32, 4) == 16
