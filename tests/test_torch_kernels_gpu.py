"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `gpu`: each test skips (inside the test) where no CUDA card is
present. Run on the card with `python -m pytest -m gpu tests/`. Shapes
cover what the main path does not: every head_dim the kernel is built for,
group sizes 1-3, block sizes 8 and 16, ragged GRAU inputs, uint8 buses,
column-sliced block tables, 8- and 4-bit KV pools, and for matmul_wq row
counts 1-70 (a grid over row tiles above 32), ragged N, narrow tiles and
multi-tile K.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _spec(rng, signed, pre_lo=-3, pre_hi=36):
    from repro_torch.pwlf.spec import make_spec
    segments, ne = int(rng.integers(1, 9)), int(rng.integers(1, 9))
    bps = (np.sort(rng.choice(np.arange(-(1 << 20), 1 << 20),
                              size=segments - 1, replace=False))
           if segments > 1 else np.empty((0,), np.int64))
    return make_spec(bps, rng.integers(0, 2, size=(segments, ne)),
                     rng.choice([-1, 1], size=segments),
                     rng.integers(-100, 101, size=segments),
                     pre_shift=int(rng.integers(pre_lo, pre_hi)),
                     num_exponents=ne, out_bits=8, out_signed=signed)


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (256, 512), (17, 1001)])
@pytest.mark.parametrize("signed", [True, False])
def test_grau_kernel_bit_exact(cuda, shape, signed):
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(shape[1])
    for _ in range(4):
        spec = _spec(rng, signed)
        x = rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64)
        edges = [-(1 << 31), (1 << 31) - 1][:x.size]
        x.reshape(-1)[:len(edges)] = edges
        xt = torch.from_numpy(x.astype(np.int32))
        got = ops.grau(xt.to(cuda), spec)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      ref.grau_ref(xt, spec).numpy())
    # a view whose data does not start on a 16-byte boundary
    big = torch.from_numpy(rng.integers(-999, 999, size=(1, 65),
                                        dtype=np.int32)).to(cuda)
    got = ops.grau(big[:, 1:], spec)
    np.testing.assert_array_equal(
        got.cpu().numpy(), ref.grau_ref(big[:, 1:].cpu(), spec).numpy())


def _assert_matches_plain(kern, plain, args, dtype):
    """The kernel's f32 result at 2e-5 element by element; its bf16 output
    at most one bf16 ulp from the plain version's (both round an f32
    result held at 2e-5)."""
    f32 = kern(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(f32, plain(*args, out_dtype=torch.float32),
                               rtol=2e-5, atol=2e-5)
    got = kern(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2 ** -7, 1e-6)
    torch.testing.assert_close(got.float(), plain(*args).float(), rtol=rtol,
                               atol=atol)
    return f32


def _pools(rng, nb, bs, kvh, d, dtype, dev):
    k = torch.from_numpy(rng.normal(size=(nb, bs, kvh, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(nb, bs, kvh, d)).astype(np.float32))
    return k.to(dev, dtype), v.to(dev, dtype)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (6, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
def test_paged_kernels_match_plain(cuda, d, h, kvh, dtype, bs):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.kernels.ref import attn_output_quant
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(d + h + bs)
    nb, width = 40, 6
    k, v = _pools(rng, nb, bs, kvh, d, dt, cuda)
    table = torch.from_numpy(rng.permutation(np.arange(1, nb))[:4 * 8]
                             .reshape(4, 8).astype(np.int32)).to(cuda)
    table[2] = 0                                    # idle slot, NULL row
    sliced = table[:, :width]                       # row stride 8
    lengths = torch.tensor([1, width * bs, 0, 3 * bs + 5], dtype=torch.int32,
                           device=cuda)
    q = torch.from_numpy(rng.normal(size=(4, h, d)).astype(np.float32)).to(
        cuda, dt)
    f32 = _assert_matches_plain(pa.paged_attention, pa.paged_attention_plain,
                                (q, k, v, sliced, lengths), dt)
    g = build_lm_grau("identity")
    quant = pa.paged_attention(q, k, v, sliced, lengths, spec=g.spec,
                               s_in=g.s_in)
    assert torch.equal(quant.cpu(), attn_output_quant(f32.cpu(), g.spec,
                                                      g.s_in))
    chunk = 2 * bs
    qp = torch.from_numpy(rng.normal(size=(2, chunk, h, d)).astype(
        np.float32)).to(cuda, dt)
    start = torch.tensor([0, 2 * bs], dtype=torch.int32, device=cuda)
    f32 = _assert_matches_plain(pa.paged_prefill_attention,
                                pa.paged_prefill_plain,
                                (qp, k, v, sliced[:2], start), dt)
    quant = pa.paged_prefill_attention(qp, k, v, sliced[:2], start,
                                       spec=g.spec, s_in=g.s_in)
    assert torch.equal(quant.cpu(), attn_output_quant(f32.cpu(), g.spec,
                                                      g.s_in))


def test_engine_kernel_and_gather_paths_agree(cuda):
    from repro_torch.configs.archs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    cfg = get_config("llama3.2-3b", smoke=True)
    params = lm.init_lm(cfg, seed=0, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n) for n in (5, 40, 17)]
    streams = []
    for impl in (None, "gather"):
        eng = ServeEngine(cfg, params, EngineConfig(
            slots=2, max_seq=96, page_size=16, paged_impl=impl))
        done = eng.run([Request(rid=i, prompt=p, max_new_tokens=8)
                        for i, p in enumerate(prompts)])
        streams.append({r.rid: r.out_tokens for r in done})
    assert streams[0] == streams[1]


def test_paged_wrapper_rejects_misaligned_pools(cuda):
    from repro_torch.kernels import paged_attention as pa
    flat = torch.zeros(4 * 16 * 2 * 32 + 1, device=cuda)
    k = flat[1:].view(4, 16, 2, 32)                 # 4 bytes past alignment
    q = torch.zeros((2, 4, 32), device=cuda)
    table = torch.ones((2, 2), dtype=torch.int32, device=cuda)
    lengths = torch.tensor([3, 20], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_attention(q, k, k, table, lengths)


def _quant_pools(rng, nb, bs, kvh, d, bits, dev):
    hdp = d // 2 if bits == 4 else d
    k = torch.from_numpy(rng.integers(-128, 128, size=(nb, bs, kvh, hdp))
                         .astype(np.int8)).to(dev)
    v = torch.from_numpy(rng.integers(-128, 128, size=(nb, bs, kvh, hdp))
                         .astype(np.int8)).to(dev)
    ke = torch.from_numpy(rng.integers(-9, -3, size=(nb, kvh))
                          .astype(np.int8)).to(dev)
    ve = torch.from_numpy(rng.integers(-9, -3, size=(nb, kvh))
                          .astype(np.int8)).to(dev)
    ke[0] = ve[0] = -126                 # the never-written null block
    return k, v, ke, ve


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
def test_quant_paged_kernels_match_plain(cuda, d, bits, dtype, bs):
    """8/4-bit pools: dequantized exactly at load, so held at the 16-bit
    tolerances; the fused epilogue bit-exact on the kernel's f32 output."""
    from functools import partial

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import attn_output_quant
    from repro_torch.nn.common import build_lm_grau
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(d + bits + bs)
    nb, width, h, kvh = 40, 6, 6, 2
    k, v, ke, ve = _quant_pools(rng, nb, bs, kvh, d, bits, cuda)
    kw = dict(k_exp=ke, v_exp=ve, kv_bits=bits)
    table = torch.from_numpy(rng.permutation(np.arange(1, nb))[:4 * 8]
                             .reshape(4, 8).astype(np.int32)).to(cuda)
    table[2] = 0
    sliced = table[:, :width]
    lengths = torch.tensor([1, width * bs, 0, 3 * bs + 5], dtype=torch.int32,
                           device=cuda)
    q = torch.from_numpy(rng.normal(size=(4, h, d)).astype(np.float32)).to(
        cuda, dt)
    g = build_lm_grau("identity")
    for kern, plain, args in (
            (pa.paged_attention, pa.paged_attention_plain,
             (q, k, v, sliced, lengths)),
            (pa.paged_prefill_attention, pa.paged_prefill_plain,
             (torch.from_numpy(rng.normal(size=(2, 2 * bs, h, d)).astype(
                 np.float32)).to(cuda, dt), k, v, sliced[:2],
              torch.tensor([0, 2 * bs], dtype=torch.int32, device=cuda)))):
        f32 = _assert_matches_plain(partial(kern, **kw), partial(plain, **kw),
                                    args, dt)
        quant = kern(*args, spec=g.spec, s_in=g.s_in, **kw)
        assert torch.equal(quant.cpu(), attn_output_quant(f32.cpu(), g.spec,
                                                          g.s_in))
        assert kern.kv4_launches + kern.kv8_launches > 0


def _packed(rng, k, n, bits, dev):
    from repro_torch.quant import weights as wq
    w = torch.from_numpy((rng.normal(size=(k, n))
                          * np.exp2(rng.integers(-4, 4, size=(1, n))))
                         .astype(np.float32))
    return wq.pack_tensor(w.to(dev), bits, -2)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 1024, 48), (8, 3072, 256),
                                   (32, 512, 80), (33, 96, 16),
                                   (70, 1536, 64)])
def test_matmul_wq_kernel_matches_plain(cuda, bits, dtype, m, k, n):
    """f32 output within 2e-5 * sum_k |x| |w| element by element (the same
    exact products summed in another order); output in x's dtype within that
    plus one bf16 ulp of the plain version's; the fused epilogue bit-exact
    on the kernel's own f32 output."""
    from repro_torch.kernels import matmul_wq as mm
    from repro_torch.kernels.ref import attn_output_quant
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.quant import weights as wq
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(m + k + n + bits)
    w = _packed(rng, k, n, bits, cuda)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda, dt)
    before = mm.matmul_wq.launches
    got32 = mm.matmul_wq(x.float(), w)
    torch.cuda.synchronize()
    want32 = mm.matmul_wq_plain(x.float(), w.q, w.e, bits=bits, kdim=k)
    bound = 2e-5 * (x.float().abs() @ wq.dense(w).abs())
    assert ((got32 - want32).abs() <= bound).all()
    got = mm.matmul_wq(x, w)
    torch.cuda.synchronize()
    want = mm.matmul_wq_plain(x, w.q, w.e, bits=bits, kdim=k)
    assert got.dtype == dt and torch.isfinite(got.float()).all()
    # both round an f32 sum (held at `bound`) to the output type: at most
    # one bf16 ulp (2^-7 |want|) apart beyond the f32 difference
    slack = 1e-6 + bound + (2 ** -7 if dt == torch.bfloat16 else 0.0) * \
        want.float().abs()
    assert ((got.float() - want.float()).abs() <= slack).all()
    g = build_lm_grau("silu")
    fused = mm.matmul_wq(x.float(), w, g.spec, s_in=g.s_in)
    torch.cuda.synchronize()
    assert torch.equal(fused.cpu(),
                       attn_output_quant(got32.cpu(), g.spec, g.s_in))
    assert mm.matmul_wq.launches == before + 3


def test_matmul_wq_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import matmul_wq as mm
    from repro_torch.quant.weights import QuantWeight
    rng = np.random.default_rng(0)
    w = _packed(rng, 64, 24, 8, cuda)              # N = 24: not 16-aligned
    x = torch.zeros((2, 64), device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        mm.matmul_wq(x, w)
    w = _packed(rng, 64, 32, 8, cuda)
    flat = torch.zeros(64 * 32 + 1, dtype=torch.int8, device=cuda)
    off = QuantWeight(q=flat[1:].view(64, 32), e=w.e, bits=8, caxis=-2,
                      kdim=64, tile=64)
    with pytest.raises(ValueError, match="16-byte"):
        mm.matmul_wq(x, off)
    with pytest.raises(ValueError, match="device"):
        mm.matmul_wq(x.cpu(), w)


@pytest.mark.parametrize("quant", [dict(kv_bits=4), dict(weight_bits=4),
                                   dict(weight_bits=8, kv_bits=8)])
def test_engine_quant_kernel_and_gather_paths_agree(cuda, quant):
    """Smoke-size f32 serving on the card: the kernel path (paged kernels on
    packed pools, matmul_wq for the MLP) and the gather path with the MLP
    weights dequantized to plain float give the same greedy streams."""
    from repro_torch import kernels
    from repro_torch.configs.archs import get_config
    from repro_torch.models import lm
    from repro_torch.quant import weights as wq
    from repro_torch.quant.policy import PrecisionPolicy
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    cfg = get_config("llama3.2-3b", smoke=True)
    params = lm.init_lm(cfg, seed=0, dtype=torch.float32, device=cuda)
    pol = PrecisionPolicy(kv_default_bits=quant.get("kv_bits", 16),
                          weight_default_bits=quant.get("weight_bits", 16))
    packed = wq.pack_params(params, cfg, pol)
    plain = _mlp_dense(packed)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n) for n in (5, 40, 17)]
    streams = []
    kernels.reset_launches()
    for p, impl in ((packed, None), (plain, "gather")):
        eng = ServeEngine(cfg, p, EngineConfig(
            slots=2, max_seq=96, page_size=16, paged_impl=impl,
            kv_bits=quant.get("kv_bits")))
        done = eng.run([Request(rid=i, prompt=pr, max_new_tokens=8)
                        for i, pr in enumerate(prompts)])
        streams.append({r.rid: r.out_tokens for r in done})
    assert streams[0] == streams[1]
    counts = kernels.launch_counts()
    assert (counts["matmul_wq"] > 0) == ("weight_bits" in quant)
    if "kv_bits" in quant:
        assert counts[f"paged_attention_kv{quant['kv_bits']}"] > 0


def _mlp_dense(params):
    """The tree with every packed MLP weight dequantized to a float tensor
    (same values), so the MLP runs as a plain product."""
    from repro_torch.quant import weights as wq
    out = dict(params)
    out["group0"] = [
        {name: (dict(layer, mlp={k: wq.dense(v) for k, v in
                                 layer["mlp"].items()})
                if isinstance(layer, dict) and "mlp" in layer else layer)
         for name, layer in rep.items()}
        for rep in params["group0"]]
    return out
