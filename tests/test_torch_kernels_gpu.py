"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `gpu`: each test skips (inside the test) where no CUDA card is
present. Run on the card with `python -m pytest -m gpu tests/`. Shapes
cover what the main path does not: every head_dim the kernel is built for
(16, 32, 48, 64, 128, 192, 256: the reference's archs'), group sizes 1-3,
block sizes 8 and 16, ragged GRAU inputs, uint8 buses, column-sliced block
tables, 8- and 4-bit KV pools, the split decode over several parts, and for
matmul_wq row counts 1-70 (a grid over row tiles above 32), N and pack
tiles that are not multiples of 16, narrow tiles and multi-tile K; for
flash attention every head_dim on both bf16 kernels, group sizes 1-3,
ragged lengths, q_offset, strided views, the backward, and a training
step.
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


HEAD_DIMS = [16, 32, 48, 64, 128, 192, 256]


@pytest.mark.parametrize("d", HEAD_DIMS)
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


@pytest.mark.parametrize("d", HEAD_DIMS)
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


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(8, 3072, 256), (32, 512, 80),
                                   (70, 1536, 64), (32, 8192, 128)])
def test_matmul_wq_bf16_epilogue_on_the_f32_sum(cuda, bits, m, k, n):
    """bf16 activations, at one K part (K = 512) and several: the f32 sum
    (out_dtype=float32) within 2e-5 * sum_k |x| |w| of the plain version's;
    the bf16 output is that sum rounded; the fused GRAU epilogue bit-exact
    on it and within one code of the plain version's."""
    from repro_torch.kernels import matmul_wq as mm
    from repro_torch.kernels.ref import attn_output_quant
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.quant import weights as wq
    rng = np.random.default_rng(3 * m + k + n + bits)
    w = _packed(rng, k, n, bits, cuda)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    parts, _ = mm.plan_parts(m, n, k, w.tile, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert (parts == 1) == (k == 512)
    f32 = mm.matmul_wq(x, w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = mm.matmul_wq_plain(x, w.q, w.e, bits=bits, kdim=k,
                              out_dtype=torch.float32)
    bound = 2e-5 * (x.float().abs() @ wq.dense(w).abs())
    assert f32.dtype == torch.float32 and ((f32 - want).abs() <= bound).all()
    assert torch.equal(mm.matmul_wq(x, w), f32.to(torch.bfloat16))
    g = build_lm_grau("silu")
    fused = mm.matmul_wq(x, w, g.spec, s_in=g.s_in)
    torch.cuda.synchronize()
    assert torch.equal(fused.cpu(), attn_output_quant(f32.cpu(), g.spec,
                                                      g.s_in))
    plain = mm.matmul_wq_plain(x, w.q, w.e, bits=bits, kdim=k, spec=g.spec,
                               s_in=g.s_in)
    assert int((fused.to(torch.int32) - plain.to(torch.int32)).abs().max()) \
        <= 1


def test_matmul_wq_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """N = 24 (the wrapper pads it to 32 with zero bytes) and pack tiles of
    24 and 8 (the kernel zero-fills the tile's ragged edge; a 4-bit tile of
    24 stages bf16 x element by element) run and match the plain version —
    f32 sums within 2e-5 * sum_k |x| |w|, the epilogue bit-exact on them;
    a misaligned payload and a CPU operand are still refused."""
    from repro_torch.kernels import matmul_wq as mm
    from repro_torch.kernels.ref import attn_output_quant
    from repro_torch.nn.common import build_lm_grau
    from repro_torch.quant import weights as wq
    from repro_torch.quant.weights import QuantWeight
    rng = np.random.default_rng(0)
    g = build_lm_grau("silu")
    for bits in (8, 4):
        for m, k, n, tile_k in ((2, 64, 24, 512), (5, 72, 40, 24),
                                (33, 48, 24, 24), (8, 128, 16, 8)):
            w = wq.pack_tensor(torch.from_numpy(rng.normal(size=(k, n)).astype(
                np.float32)).to(cuda), bits, -2, tile_k)
            for dt in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(rng.normal(size=(m, k)).astype(
                    np.float32)).to(cuda, dt)
                got = mm.matmul_wq(x, w, out_dtype=torch.float32)
                torch.cuda.synchronize()
                want = mm.matmul_wq_plain(x, w.q, w.e, bits=bits, kdim=k,
                                          out_dtype=torch.float32)
                bound = 2e-5 * (x.float().abs() @ wq.dense(w).abs())
                assert got.shape == (m, n)
                assert bool(((got - want).abs() <= bound).all()), \
                    (bits, m, k, n, w.tile, dt)
                fused = mm.matmul_wq(x, w, g.spec, s_in=g.s_in)
                torch.cuda.synchronize()
                assert torch.equal(fused.cpu(), attn_output_quant(
                    got.cpu(), g.spec, g.s_in))
    w = _packed(rng, 64, 32, 8, cuda)
    x = torch.zeros((2, 64), device=cuda)
    flat = torch.zeros(64 * 32 + 1, dtype=torch.int8, device=cuda)
    off = QuantWeight(q=flat[1:].view(64, 32), e=w.e, bits=8, caxis=-2,
                      kdim=64, tile=64)
    with pytest.raises(ValueError, match="16-byte"):
        mm.matmul_wq(x, off)
    with pytest.raises(ValueError, match="device"):
        mm.matmul_wq(x.cpu(), w)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("case", ["long prefix", "batch 2", "two row groups"])
def test_prefill_bf16_parts_match_plain(cuda, d, bits, case):
    """The tensor-core prefill (bf16 q) split over the sequence: batch 1
    after a 1000-position prefix (17 parts), batch 2 at start 0 and
    mid-prompt (9 parts), and 192 query rows (two row groups of 128), on
    bf16, 8- and 4-bit pools, through tables wider than the live range.
    f32 output at 2e-5 element by element, bf16 output within one bf16
    ulp, the fused epilogue bit-exact on the kernel's f32 output."""
    from functools import partial

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import attn_output_quant
    from repro_torch.nn.common import build_lm_grau
    bs, h, kvh = 16, 6, 2
    chunk, starts, width = {"long prefix": (32, [1000], 68),
                            "batch 2": (32, [0, 500], 36),
                            "two row groups": (64, [100], 12)}[case]
    rng = np.random.default_rng(d + bits + len(case))
    b = len(starts)
    nb = b * width + 1
    table = torch.from_numpy(rng.permutation(np.arange(1, nb))
                             .reshape(b, width).astype(np.int32)).to(cuda)
    if bits == 16:
        k, v = _pools(rng, nb, bs, kvh, d, torch.bfloat16, cuda)
        kw = {}
    else:
        k, v, ke, ve = _quant_pools(rng, nb, bs, kvh, d, bits, cuda)
        kw = dict(k_exp=ke, v_exp=ve, kv_bits=bits)
    q = torch.from_numpy(rng.normal(size=(b, chunk, h, d)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    start = torch.tensor(starts, dtype=torch.int32, device=cuda)
    parts, _ = pa.prefill_plan(b, kvh, chunk * h // kvh, width, bs,
                               torch.cuda.get_device_properties(
                                   cuda).multi_processor_count)
    assert parts >= (8 if case == "long prefix" else 2)
    kern = partial(pa.paged_prefill_attention, **kw)
    args = (q, k, v, table, start)
    f32 = _assert_matches_plain(kern, partial(pa.paged_prefill_plain, **kw),
                                args, torch.bfloat16)
    g = build_lm_grau("identity")
    quant = kern(*args, spec=g.spec, s_in=g.s_in)
    torch.cuda.synchronize()
    assert torch.equal(quant.cpu(), attn_output_quant(f32.cpu(), g.spec,
                                                      g.s_in))
    plain = pa.paged_prefill_plain(*args, spec=g.spec, s_in=g.s_in, **kw)
    assert int((quant.to(torch.int32) - plain.to(torch.int32)).abs().max()) \
        <= 1


def _decode_f64(q, k, v, table, lengths, kv):
    """Decode in float64 on the gathered dense view (a masked softmax, not
    the kernels' recurrence)."""
    from repro_torch.kernels.ref import dense_kv_views
    kd, vd = dense_kv_views(k, v, table, **kv)
    slots, h, d = q.shape
    kvh = kd.shape[2]
    qg = q.double().reshape(slots, kvh, h // kvh, d)
    lg = torch.einsum("bkgd,bskd->bkgs", qg, kd.double()) * d ** -0.5
    pos = torch.arange(kd.shape[1], device=q.device)
    live = (pos[None] < lengths.long()[:, None])[:, None, None]
    lg = lg.masked_fill(~live, float("-inf"))
    o = torch.einsum("bkgs,bskd->bkgd", torch.softmax(lg, -1), vd.double())
    return o.reshape(slots, h, d)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_decode_bf16_parts_match_plain(cuda, d, bits):
    """The split decode (bf16 q, 4 position warps a block) over a 128-block
    table of 16-position blocks (several parts), slots ragged to 2048 with
    an idle slot and lengths on part boundaries, on bf16, 8- and 4-bit
    pools: f32 output within 2e-5 (1 + |want|) of the plain version's; the
    bf16 output is that f32 output rounded; the fused epilogue bit-exact on
    it and within one code of the plain version's. Then a float64 gate:
    |f32 - f64| / (1 + |f64|) of the kernel within twice the plain
    version's and 1e-5 (the f32 rounding of one softmax pass)."""
    from functools import partial

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import attn_output_quant
    from repro_torch.nn.common import build_lm_grau
    bs, h, kvh, width, slots = 16, 6, 2, 128, 6
    rng = np.random.default_rng(d + 3 * bits)
    nb = slots * width + 1
    table = torch.from_numpy(rng.permutation(np.arange(1, nb))
                             .reshape(slots, width).astype(np.int32)).to(cuda)
    parts, bpp = pa.decode_plan(slots, kvh, width, bs, kbuild.sm_count(cuda))
    assert parts > 1
    lengths = torch.tensor([0, 1, bpp * bs, bpp * bs + 1, 1000, width * bs],
                           dtype=torch.int32, device=cuda)
    table[0] = 0
    if bits == 16:
        k, v = _pools(rng, nb, bs, kvh, d, torch.bfloat16, cuda)
        kw = {}
    else:
        k, v, ke, ve = _quant_pools(rng, nb, bs, kvh, d, bits, cuda)
        kw = dict(k_exp=ke, v_exp=ve, kv_bits=bits)
    q = torch.from_numpy(rng.normal(size=(slots, h, d)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    kern = partial(pa.paged_attention, **kw)
    plain = partial(pa.paged_attention_plain, **kw)
    args = (q, k, v, table, lengths)
    n0 = pa.paged_attention.launches
    f32 = kern(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    p32 = plain(*args, out_dtype=torch.float32)
    torch.testing.assert_close(f32, p32, rtol=2e-5, atol=2e-5)
    assert torch.isfinite(f32).all()
    assert torch.equal(kern(*args), f32.to(torch.bfloat16))
    g = build_lm_grau("identity")
    quant = kern(*args, spec=g.spec, s_in=g.s_in)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == n0 + 3
    assert torch.equal(quant.cpu(), attn_output_quant(f32.cpu(), g.spec,
                                                      g.s_in))
    qref = plain(*args, spec=g.spec, s_in=g.s_in)
    assert int((quant.to(torch.int32) - qref.to(torch.int32)).abs().max()) \
        <= 1
    live = lengths > 0
    o64 = _decode_f64(q, k, v, table, lengths, kw)[live]
    dist = [float(((o.double()[live] - o64).abs() / (1 + o64.abs())).max())
            for o in (f32, p32)]
    assert dist[0] <= max(2 * dist[1], 1e-6) and dist[0] <= 1e-5, dist


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


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("m,k,n", [(1, 64, 8), (1, 200, 128), (3, 7, 5),
                                   (17, 260, 96), (128, 256, 128),
                                   (130, 260, 300), (129, 1024, 257),
                                   (256, 512, 256), (300, 2048, 136)])
def test_matmul_grau_kernel_bit_exact(cuda, signed, m, k, n):
    """Bit for bit against the plain version and the int64 oracle, for
    ragged M, N and K (K not a multiple of 16 takes the byte-wise loader)
    and both bus types; the int8 extremes included."""
    from repro_torch.kernels import matmul_grau as mg
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(m * 7 + k + n)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    x.reshape(-1)[:2], w.reshape(-1)[:2] = (-128, 127), (-128, -128)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for _ in range(3):
        spec = _spec(rng, signed, pre_lo=-3, pre_hi=40)
        before = mg.matmul_grau.launches
        got = ops.matmul_grau(xt.to(cuda), wt.to(cuda), spec)
        torch.cuda.synchronize()
        assert mg.matmul_grau.launches == before + 1
        assert got.dtype == (torch.int8 if signed else torch.uint8)
        regs = spec.packed(cuda)
        plain = mg.matmul_grau_plain(xt.to(cuda), wt.to(cuda), regs,
                                     num_exponents=spec.num_exponents,
                                     qmin=spec.qmin, qmax=spec.qmax)
        assert torch.equal(got, plain)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      ref.matmul_grau_ref(xt, wt, spec).numpy())


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("m,k,n", [(1, 200, 96), (1, 8192, 3072),
                                   (32, 8192, 3072), (32, 260, 8192),
                                   (33, 8192, 96), (33, 200, 3072),
                                   (2048, 260, 96), (2048, 8192, 3072),
                                   (2048, 3072, 8192)])
def test_matmul_grau_tiles_and_k_parts_bit_exact(cuda, signed, m, k, n):
    """The wgmma kernel at row tiles of 32 and 128, with one K part and
    with several (the plan splits K at 1-33 rows and K 8192), on the TMA
    path (K, N multiples of 16) and the byte-wise one (K 200, 260), both
    buses: bit for bit against the plain version (float64, exact)."""
    from repro_torch.kernels import matmul_grau as mg
    from repro_torch.kernels import ops
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.integers(-128, 128, size=(m, k))
                         .astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, size=(k, n))
                         .astype(np.int8)).to(cuda)
    bm, parts, _ = mg.plan(m, n, k, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert (parts > 1) == (m <= 33 and k == 8192)
    for _ in range(2):
        spec = _spec(rng, signed, pre_lo=-3, pre_hi=40)
        got = ops.matmul_grau(x, w, spec)
        torch.cuda.synchronize()
        want = mg.matmul_grau_plain(x, w, spec.packed(cuda),
                                    num_exponents=spec.num_exponents,
                                    qmin=spec.qmin, qmax=spec.qmax)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("signed", [True, False])
def test_grau_kernel_bit_exact_at_2048x8192(cuda, signed):
    """The unit at an MLP's width (2048 x 8192 MAC outputs) on random
    register files: bit for bit against the plain version."""
    from repro_torch.kernels import grau as gk
    from repro_torch.kernels import ops
    rng = np.random.default_rng(8192 + signed)
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(2048, 8192),
                                      dtype=np.int64).astype(np.int32)).to(cuda)
    for _ in range(3):
        spec = _spec(rng, signed, pre_lo=-40, pre_hi=40)
        got = ops.grau(x, spec)
        torch.cuda.synchronize()
        want = gk.grau_plain(x, spec.packed(cuda),
                             num_exponents=spec.num_exponents,
                             qmin=spec.qmin, qmax=spec.qmax)
        assert torch.equal(got.to(torch.int32), want)


def test_matmul_grau_batched_and_views(cuda):
    """The (2, 17, 128) x (128, 96) batched case, a 1-D x, and operands that
    do not start on an aligned address (a column-sliced view is copied)."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(5)
    spec = _spec(rng, True)
    x = torch.from_numpy(rng.integers(-128, 128, size=(2, 17, 128))
                         .astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, size=(128, 96))
                         .astype(np.int8))
    got = ops.matmul_grau(x.to(cuda), w.to(cuda), spec)
    want = ref.matmul_grau_ref(x.reshape(-1, 128), w, spec).reshape(2, 17, 96)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    got1 = ops.matmul_grau(x[0, 0].to(cuda), w.to(cuda), spec)
    assert got1.shape == (96,)
    np.testing.assert_array_equal(got1.cpu().numpy(), want[0, 0].numpy())
    big = torch.from_numpy(rng.integers(-128, 128, size=(33, 129))
                           .astype(np.int8))
    wbig = torch.from_numpy(rng.integers(-128, 128, size=(129, 65))
                            .astype(np.int8))
    xv, wv = big[:, 1:], wbig[1:, 1:]
    got = ops.matmul_grau(xv.to(cuda), wv.to(cuda), spec)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        ref.matmul_grau_ref(xv.contiguous(), wv.contiguous(), spec).numpy())


def test_matmul_grau_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import ops
    spec = _spec(np.random.default_rng(1), True)
    x = torch.zeros((4, 32), dtype=torch.int8, device=cuda)
    w = torch.zeros((32, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        ops.matmul_grau(x.float(), w, spec)
    with pytest.raises(ValueError, match="K mismatch"):
        ops.matmul_grau(x, w[:16], spec)
    with pytest.raises(ValueError, match="one device"):
        ops.matmul_grau(x, w.cpu(), spec)


# (b, s_q, s_kv, h, kvh, d, causal, q_offset): every head_dim, group sizes
# 1-3, ragged lengths (not multiples of the kernel's 64-row tiles), and
# queries placed after a prefix (q_offset, s_q < s_kv)
FLASH_CASES = [(2, 256, 256, 4, 4, 32, True, 0),
               (2, 256, 256, 8, 2, 64, False, 0),
               (1, 1000, 1000, 6, 3, 128, True, 0),
               (1, 77, 77, 4, 1, 128, False, 0),
               (1, 100, 300, 4, 2, 256, True, 200),
               (2, 130, 130, 2, 1, 256, True, 0),
               (1, 5, 40, 3, 3, 64, True, 35),
               # the head dims of the reference's other archs: 16 and 48 on
               # the mma.sync kernel, 192 on the wgmma kernel
               (1, 300, 300, 4, 2, 16, True, 0),
               (2, 130, 200, 4, 2, 16, False, 0),
               (1, 257, 257, 6, 3, 48, True, 0),
               (1, 100, 300, 4, 2, 48, True, 200),
               (1, 333, 333, 4, 2, 192, True, 0),
               (1, 129, 250, 2, 1, 192, False, 0),
               (1, 60, 300, 4, 4, 192, True, 240),
               (1, 1000, 1000, 6, 3, 64, False, 0),
               (1, 200, 600, 4, 2, 128, True, 400)]


def _flash_inputs(rng, b, s_q, s_kv, h, kvh, d, dev, dtype):
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, dtype)
    return t(b, s_q, h, d), t(b, s_kv, kvh, d), t(b, s_kv, kvh, d)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    """o within the reference tests' tolerances (f32 3e-5, bf16 2e-2) of
    flash_attention_plain on the same inputs; lse within 3e-5 (f32) / 1e-4
    (bf16: the same f32 scores, a fast exp). bf16 o also within twice what
    rounding explains: P rounded to bf16 before P V (2^-9 (P|V|)/l, the
    plain version on |v|) and o rounded on both sides (2^-7 |want|)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_plain
    b, s_q, s_kv, h, kvh, d, causal, off = case
    dt = getattr(torch, dtype)
    q, k, v = _flash_inputs(np.random.default_rng(s_q + d), b, s_q, s_kv, h,
                            kvh, d, cuda, dt)
    n0 = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           q_offset=off)
    assert o.dtype == dt and lse.dtype == torch.float32
    tol, ltol = (3e-5, 3e-5) if dt == torch.float32 else (2e-2, 1e-4)
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=ltol, atol=ltol)
    if dt == torch.bfloat16:
        pv, _ = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                      causal=causal, q_offset=off)
        bound = 1e-5 + 2 ** -8 * pv + 2 ** -6 * want.float().abs()
        assert bool(((o.float() - want.float()).abs() <= bound).all())


def test_flash_kernel_reads_strided_views(cuda):
    """q and k as head slices of one (b, s, h + kvh, d) tensor (what the
    rope step hands over), v transposed from (b, kvh, s, d): read through
    their strides, no copy, same result as on contiguous copies."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(5)
    qk = torch.from_numpy(rng.normal(size=(2, 192, 6, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k = qk.split([4, 2], dim=2)
    v = torch.from_numpy(rng.normal(size=(2, 2, 192, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16).transpose(1, 2)
    assert fa._rows_aligned(k) is k and fa._rows_aligned(v) is v
    o, lse = fa.flash_attention(q, k, v)
    o2, lse2 = fa.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("case", FLASH_CASES[:5], ids=str)
def test_flash_backward_matches_autograd_of_plain(cuda, case):
    """FlashAttention (the kernel forward, flash_attention_backward) against
    autograd through flash_attention_plain, f32, on the card: dq, dk, dv
    within a relative L2 of 1e-5."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s_q, s_kv, h, kvh, d, causal, off = case
    rng = np.random.default_rng(7)
    q, k, v = (x.requires_grad_() for x in _flash_inputs(
        rng, b, s_q, s_kv, h, kvh, d, cuda, torch.float32))
    do = torch.from_numpy(rng.normal(size=(b, s_q, h, d)).astype(
        np.float32)).to(cuda)
    o = fa.FlashAttention.apply(q, k, v, causal, None, off, 64, 96)
    got = torch.autograd.grad(o, (q, k, v), do)
    want_o, _ = flash_attention_plain(q, k, v, causal=causal, q_offset=off)
    want = torch.autograd.grad(want_o, (q, k, v), do)
    for a, w in zip(got, want):
        assert float((a - w).norm() / w.norm()) <= 1e-5


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="head_dim"):      # not in HEAD_DIMS
        fa.flash_attention(q[..., :40], q[..., :40], q[..., :40])
    qb = q.to(torch.bfloat16)       # the wgmma kernel folds scale into exp2
    with pytest.raises(ValueError, match="scale"):
        fa.flash_attention(qb, qb, qb, scale=-0.125)


def test_train_step_through_the_flash_kernel(cuda):
    """llama3-smoke with GRAU, f32, remat "full", on the card: loss and
    gradients through the flash kernel agree with the plain scan's (loss
    1e-5, every leaf within a relative L2 of 1e-3, as on the CPU against
    the reference), and one training step launches the kernel twice a
    layer (the forward and the remat recompute; the backward none)."""
    from repro_torch.configs.archs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.config import GRAUConfig
    from repro_torch.nn.common import tree_flatten
    from repro_torch.train import optim
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3.2-3b", smoke=True).replace(grau=GRAUConfig())
    params = lm.init_lm(cfg, seed=0, dtype=torch.float32, device=cuda)
    batch = TokenPipeline(cfg.vocab_size, 64, 2, device="cuda").batch(0)
    (lk, gk), (lp, gp) = (steps.make_loss_and_grads(
        cfg, remat="full", q_chunk=32, kv_chunk=32, attn_impl=impl)(
            params, batch) for impl in ("kernel", "plain"))
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for (path, a), (_, b) in zip(tree_flatten(gk), tree_flatten(gp)):
        assert float((a - b).norm() / b.norm()) <= 1e-3, path
    step = steps.make_train_step(cfg, optim.AdamWConfig(warmup_steps=1),
                                 remat="full", q_chunk=32, kv_chunk=32)
    n0 = fa.flash_attention.launches
    _, _, m = step(params, optim.init_opt_state(params), batch)
    assert torch.isfinite(m["loss"])
    assert fa.flash_attention.launches - n0 == 2 * cfg.num_layers
