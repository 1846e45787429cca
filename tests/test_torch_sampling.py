"""PyTorch port vs the JAX reference: threefry random numbers and sampled
decoding.

serve/prng.py must reproduce jax.random bit for bit (keys, fold_in, the
partitionable 32-bit bits, the uniform floats); serve/sampling.py must
draw the reference's tokens from the same logits, parameters and keys; and
the port's engine must serve the reference engine's sampled streams.

Tolerances: bits, keys and uniform floats exact. The Gumbel noise is
-log(-log(u)), and torch's `log` and XLA's may differ in the last ulp, so a
token may flip only where its two candidates' `logit/T + gumbel` lie
within 2 f32 ulps of each other; every flip is reported. Engine streams
exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import sampling as jsamp  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import prng  # noqa: E402
from repro_torch.serve import sampling as tsamp  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 1, -1, -12345, 2 ** 32 - 1]
SHAPES = [(1,), (5,), (3, 7), (1001,), (2, 3, 5)]
# (temperature, top_k, top_p) mixes, taken in turn across slots
MIXES = {
    "greedy_topk_topp": [(0.0, 0, 1.0), (0.8, 40, 0.9), (1.0, 50, 1.0),
                         (0.7, 0, 0.95)],
    "top_p_only": [(1.0, 0, 0.5), (0.9, 0, 0.8), (1.3, 0, 0.99)],
    "top_k_only": [(1.0, 1, 1.0), (0.6, 5, 1.0), (1.5, 200, 1.0)],
    "temperature_only": [(0.5, 0, 1.0), (1.0, 0, 1.0), (2.0, 0, 1.0)],
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


# ---------------------------------------------------------------------------
# prng: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    assert np.array_equal(_u32(key), tkey.numpy())
    for d in (0, 1, 7, 12345, 2 ** 31 - 1, 2 ** 32 - 1):
        assert np.array_equal(_u32(jax.random.fold_in(key, d)),
                              prng.fold_in(tkey, d).numpy()), d
    # chained folds, as the engine derives a slot's key
    k2 = jax.random.fold_in(jax.random.fold_in(key, 99), 3)
    assert np.array_equal(_u32(k2),
                          prng.fold_in(prng.fold_in(tkey, 99), 3).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 42, -1])
def test_random_bits_and_uniform_match_jax(seed, shape):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    bits = prng.random_bits(tkey, shape)
    assert np.array_equal(_u32(jax.random.bits(key, shape)), bits.numpy())
    want = np.asarray(jax.random.uniform(key, shape))
    got = prng.uniform(bits).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    want = np.asarray(jax.random.uniform(key, shape, minval=tiny))
    got = prng.uniform(bits, minval=tiny).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


def test_batched_keys_match_vmap():
    """Per-slot keys and their bits, as the engine's vmap-free batch: the
    counters index within each key's own shape (odd vocab included)."""
    seeds = np.array([0, 5, 2 ** 31 - 1, 77, 123456], np.int32)
    steps = np.array([0, 3, 1, 1000, 31], np.int32)
    base = jax.random.PRNGKey(11)
    keys = jax.vmap(lambda s, c: jax.random.fold_in(
        jax.random.fold_in(base, s), c))(jnp.asarray(seeds),
                                         jnp.asarray(steps))
    tkeys = prng.fold_in(prng.fold_in(prng.prng_key(11),
                                      torch.from_numpy(seeds)),
                         torch.from_numpy(steps))
    assert np.array_equal(_u32(keys), tkeys.numpy())
    for n in (1, 2, 1001, 4096):
        want = jax.vmap(lambda k: jax.random.bits(k, (n,)))(keys)
        assert np.array_equal(_u32(want),
                              prng.random_bits(tkeys, (n,)).numpy()), n


def test_gumbel_close_to_jax():
    """The Gumbel noise goes through `log` twice: torch's and XLA's may
    differ in the last ulp of each, so the noise is held to 8e-7 absolute
    + 4 f32 ulps relative, and the share of exact elements is reported."""
    key, tkey = jax.random.PRNGKey(3), prng.prng_key(3)
    want = np.asarray(jax.random.gumbel(key, (20000,)))
    got = prng.gumbel(tkey, (20000,)).numpy()
    exact = float(np.mean(want == got))
    print(f"gumbel: {exact:.4f} of elements bit-exact")
    assert np.all(np.abs(got - want)
                  <= 8e-7 + 4 * np.finfo(np.float32).eps * np.abs(want))


# ---------------------------------------------------------------------------
# sample(): the reference's tokens
# ---------------------------------------------------------------------------

def _packs(mix, n):
    ps = [mix[i % len(mix)] for i in range(n)]
    return (jsamp.pack([jsamp.SamplingParams(*p) for p in ps]),
            tsamp.pack([tsamp.SamplingParams(*p) for p in ps]))


def _reference_masked(logits, sp):
    """The reference sampler's masked, temperature-scaled logits (its
    lines up to `masked`, on XLA-CPU), to see the top-k and top-p keep
    decisions the two packages make."""
    logits = jnp.asarray(logits, jnp.float32)
    vocab = logits.shape[-1]
    scaled = logits / jnp.maximum(sp.temperature, 1e-6)[:, None]
    sorted_desc = -jnp.sort(-scaled, axis=-1)
    k = jnp.where(sp.top_k > 0, jnp.clip(sp.top_k, 1, vocab), vocab)
    kth = jnp.take_along_axis(sorted_desc, (k - 1)[:, None], axis=-1)
    probs = jax.nn.softmax(sorted_desc, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep = (cum - probs) < jnp.clip(sp.top_p, 0.0, 1.0)[:, None]
    keep = keep.at[:, 0].set(True)
    cutoff = jnp.min(jnp.where(keep, sorted_desc, jnp.inf), axis=-1)
    ok = (scaled >= kth) & (scaled >= cutoff[:, None])
    return np.asarray(jnp.where(ok, scaled, jsamp.NEG_INF))


def _exclusive_mass(logits, temperature):
    """Each token's exclusive cumulative probability in the descending
    order (float64): the quantity the top-p cutoff compares with top_p."""
    x = logits.astype(np.float64) / np.maximum(temperature, 1e-6)[:, None]
    order = np.argsort(-x, axis=-1, kind="stable")
    xs = np.take_along_axis(x, order, -1)
    p = np.exp(xs - xs[:, :1])
    p /= p.sum(-1, keepdims=True)
    excl = np.cumsum(p, -1) - p
    out = np.empty_like(excl)
    np.put_along_axis(out, order, excl, -1)
    pt = np.empty_like(p)
    np.put_along_axis(pt, order, p, -1)
    return out, pt


# a top-p keep decision may differ only inside this band around top_p: the
# cutoff compares a running f32 sum of f32 softmax terms, and XLA-CPU's
# exp, its softmax sum and its cumsum each round in their own order (exp
# differs from torch's in ~10% of elements by an ulp; the cumsum is neither
# sequential nor associative_scan past 17 elements), so the two packages'
# sums can straddle top_p only within their rounding error
TOP_P_BAND = 2e-5


@pytest.mark.parametrize("mix", list(MIXES))
def test_sample_tokens_match_reference(mix):
    """64 slots x 32 draws at an odd vocab (1001), per-slot keys derived as
    the engine derives them: the port's tokens are the reference's; a flip
    is allowed only at a near-tie (2 f32 ulps) and is reported. The top-k /
    top-p keep decisions are compared too: they agree except at tokens
    whose exclusive cumulative probability lies within TOP_P_BAND of top_p
    (reported with the probability mass they carry)."""
    S, V, D = 64, 1001, 32
    jsp, tsp = _packs(MIXES[mix], S)
    rng = np.random.default_rng(sum(map(ord, mix)))
    base, tbase = jax.random.PRNGKey(7), prng.prng_key(7)
    seeds = (np.arange(S, dtype=np.int64) * 7919) & 0x7FFFFFFF
    sample = jax.jit(lambda l, k: jsamp.sample(l, jsp, k))
    flips, boundary, mass, worst = [], 0, 0.0, 0.0
    top_p = np.clip(tsp.top_p, 0.0, 1.0).astype(np.float64)
    for d in range(D):
        logits = (rng.standard_normal((S, V)) * 3).astype(np.float32)
        keys = jax.vmap(lambda s: jax.random.fold_in(
            jax.random.fold_in(base, s), d))(jnp.asarray(seeds, jnp.int32))
        tkeys = prng.fold_in(prng.fold_in(tbase, torch.from_numpy(seeds)), d)
        want = np.asarray(sample(jnp.asarray(logits), keys))
        tl = torch.from_numpy(logits)
        got = tsamp.sample(tl, tsp, tkeys).numpy()
        masked = tsamp.filter_logits(tl, tsp).numpy()
        differ = ((masked == tsamp.NEG_INF)
                  != (_reference_masked(logits, jsp) == jsamp.NEG_INF))
        if differ.any():
            excl, p = _exclusive_mass(logits, tsp.temperature)
            rows, cols = np.nonzero(differ)
            worst = max(worst, float(np.max(np.abs(
                excl[rows, cols] - top_p[rows]))))
            boundary += len(rows)
            mass += float(p[rows, cols].sum())
        g = prng.gumbel(tkeys, (V,)).numpy() + masked
        for s in np.nonzero(want != got)[0]:
            a, b = g[s, want[s]], g[s, got[s]]
            ulps = abs(int(np.float32(a).view(np.int32))
                       - int(np.float32(b).view(np.int32)))
            flips.append((d, int(s), int(want[s]), int(got[s]), ulps))
    print(f"{mix}: {len(flips)} flips of {S * D} draws {flips}; "
          f"{boundary} keep decisions differ, carrying probability {mass:.3g}"
          f" in all, at most {worst:.3g} from top_p")
    assert worst <= TOP_P_BAND
    assert all(f[-1] <= 2 for f in flips), flips


def test_sampler_greedy_is_argmax():
    logits = np.array([[0.1, 2.0, -1.0, 0.5], [3.0, -2.0, 0.0, 1.0]],
                      np.float32)
    sp = tsamp.pack([tsamp.SamplingParams(),
                     tsamp.SamplingParams(temperature=0.7, top_k=1)])
    out = tsamp.sample(torch.from_numpy(logits), sp, prng.prng_key(0))
    # slot 0 greedy, slot 1 top_k=1 — both must equal argmax
    assert out.tolist() == [1, 0]
    jout = jsamp.sample(jnp.asarray(logits), jsamp.pack(
        [jsamp.SamplingParams(), jsamp.SamplingParams(0.7, 1)]),
        jax.random.PRNGKey(0))
    assert out.tolist() == np.asarray(jout).tolist()


@pytest.mark.parametrize("top_p", [0.5, 0.0])
def test_sampler_top_p_keeps_only_the_dominant_token(top_p):
    """With one dominant token and a tight nucleus (or top_p=0, which must
    not empty it) only that token can be drawn, one key for the batch."""
    logits = np.full((1, 16), -5.0, np.float32)
    logits[0, 3] = 10.0
    sp = tsamp.pack([tsamp.SamplingParams(temperature=1.0, top_p=top_p)])
    for seed in range(8):
        out = tsamp.sample(torch.from_numpy(logits), sp,
                           prng.prng_key(seed))
        assert int(out[0]) == 3


def test_single_key_batch_matches_reference():
    """One key for the whole (slots, vocab) batch (the reference's
    non-vmapped path): bits over the flat index."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 97)).astype(np.float32)
    jsp, tsp = _packs(MIXES["top_p_only"], 6)
    for seed in range(6):
        want = jsamp.sample(jnp.asarray(logits), jsp,
                            jax.random.PRNGKey(seed))
        got = tsamp.sample(torch.from_numpy(logits), tsp,
                           prng.prng_key(seed))
        assert got.tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# The engine: sampled streams
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_lm():
    jcfg = jget_config("llama3.2-3b", smoke=True)
    tcfg = tget_config("llama3.2-3b", smoke=True)
    jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, tcfg, from_reference(jp, tcfg, device="cpu")


def _requests(mod, mix, n=5, max_new=8, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=100 + 37 * i,
                        prompt=rng.integers(2, 512,
                                            size=int(rng.integers(3, 20))),
                        max_new_tokens=max_new,
                        sampling=mod.SamplingParams(*mix[i % len(mix)]))
            for i in range(n)]


@pytest.mark.parametrize("mix", ["greedy_topk_topp", "top_p_only",
                                 "temperature_only"])
def test_engine_sampled_streams_match_reference(small_lm, mix):
    """The port's engine and the reference engine (gather path, seed 5)
    serve the same sampled requests: identical streams."""
    jcfg, jp, tcfg, tp = small_lm
    kw = dict(slots=3, max_seq=64, page_size=8, seed=5)
    je = jeng.ServeEngine(jcfg, jp, jeng.EngineConfig(
        paged_impl="gather", telemetry=False, **kw))
    te = teng.ServeEngine(tcfg, tp, teng.EngineConfig(**kw), device="cpu")
    jr, tr = _requests(jeng, MIXES[mix]), _requests(teng, MIXES[mix])
    je.run(jr)
    te.run(tr)
    want = {r.rid: list(r.out_tokens) for r in jr}
    got = {r.rid: list(r.out_tokens) for r in tr}
    assert got == want
    assert any(len(set(t)) > 1 for t in got.values())


def test_sampler_determinism_fixed_key(small_lm):
    """Identical seed => identical sampled generations, end to end; another
    seed gives other streams."""
    _, _, tcfg, tp = small_lm
    sp = (0.9, 50, 0.9)

    def run_once(seed):
        eng = teng.ServeEngine(tcfg, tp, teng.EngineConfig(
            slots=2, max_seq=64, seed=seed), device="cpu")
        reqs = _requests(teng, [sp], n=4, max_new=5)
        eng.run(reqs)
        return {r.rid: r.out_tokens for r in reqs}

    a, b = run_once(123), run_once(123)
    assert a == b
    assert any(len(set(toks)) > 1 for toks in a.values())
    assert run_once(124) != a


def test_sampled_stream_is_schedule_invariant(small_lm):
    """A sampled request's stream does not depend on the slot count, the
    co-batched requests or when it was admitted: keys come from the rid
    and the draw count, never the tick."""
    _, _, tcfg, tp = small_lm
    mix = MIXES["greedy_topk_topp"]
    out = []
    for slots, n in ((1, 5), (4, 5), (2, 3)):
        eng = teng.ServeEngine(tcfg, tp, teng.EngineConfig(
            slots=slots, max_seq=64, seed=9), device="cpu")
        reqs = _requests(teng, mix, n=n)
        eng.run(reqs)
        out.append({r.rid: list(r.out_tokens) for r in reqs})
    for other in out[1:]:
        assert {rid: out[0][rid] for rid in other} == other
