"""PyTorch port vs the JAX reference: the QAT quantizers, the SFC/CNV vision
models, GRAU replacement and the image pipeline (the paper's Table III flow).

The same numpy inputs and parameters go to both packages. Tolerances:
quantizer values, scales and GRAU register files are identical; logits
within 1e-5 (the same f32 products and convolutions summed in another
order; the models are small enough that no fake-quant code lands within
that error of a rounding boundary); one SGD step's gradients within 1e-5,
for the same reason; the integer path's activations identical wherever
z / s_in is not within 1e-6 (relative) of a .5 rounding boundary, and at
least 99% identical over all.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import vision as jv  # noqa: E402
from repro.quant import quantizers as jq  # noqa: E402
from repro_torch.data.pipeline import ImagePipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from repro_torch.models.convert import vision_from_reference  # noqa: E402
from repro_torch.quant import quantizers as tq  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kind, act="silu"):
    kw = dict(kind=kind, activation=act, hw=8,
              channels=1 if kind == "sfc" else 3, widths=(32, 32),
              conv_channels=(4, 8))
    return jv.VisionConfig(**kw), tv.VisionConfig(**kw)


def _to_ref(params):
    return {k: {kk: jnp.asarray(v.detach().numpy()) for kk, v in d.items()}
            for k, d in params.items()}


def _images(seed, channels, n=4):
    return np.random.default_rng(seed).normal(
        size=(n, 8, 8, channels)).astype(np.float32)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

QCFGS = [dict(bits=8), dict(bits=4), dict(bits=8, signed=False),
         dict(bits=8, per_channel=True), dict(bits=4, pot_scale=True),
         dict(bits=8, per_channel=True, channel_axis=0, pot_scale=True),
         dict(bits=16, signed=False), dict(bits=32)]


@pytest.mark.parametrize("kw", QCFGS, ids=lambda k: "-".join(
    f"{a}{b}" for a, b in k.items()))
def test_quantizer_values_identical(kw):
    x = (np.random.default_rng(1).normal(size=(6, 5))
         * np.array([0.01, 1, 3, 100, 1e-3], np.float32)).astype(np.float32)
    jc, tc = jq.QConfig(**kw), tq.QConfig(**kw)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tq.fake_quant(xt, tc).numpy(),
                                  np.asarray(jq.fake_quant(jnp.asarray(x), jc)))
    if kw["bits"] >= 32:
        return
    js = jq.compute_scale(jnp.asarray(x), jc)
    ts = tq.compute_scale(xt, tc)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jqv = np.asarray(jq.quantize(jnp.asarray(x), js, jc))
    tqv = tq.quantize(xt, ts, tc)
    assert str(tqv.dtype).split(".")[-1] == jqv.dtype.name
    np.testing.assert_array_equal(tqv.numpy(), jqv)
    np.testing.assert_array_equal(tq.dequantize(tqv, ts).numpy(),
                                  np.asarray(jq.dequantize(jnp.asarray(jqv),
                                                           js)))


def test_pot_round_scale_and_exponent_identical():
    s = np.array([1.0, 0.5, 0.75, 3.0, 2 ** -20, 1.1e-30, 7.9e-11, 1e30,
                  0.2500001], np.float32)
    np.testing.assert_array_equal(
        tq.pot_round_scale(torch.from_numpy(s)).numpy(),
        np.asarray(jq.pot_round_scale(jnp.asarray(s))))
    np.testing.assert_array_equal(
        tq.scale_exponent(torch.from_numpy(s)).numpy(),
        np.asarray(jq.scale_exponent(jnp.asarray(s))))


@pytest.mark.parametrize("kw", [dict(bits=8), dict(bits=4, signed=False),
                                dict(bits=8, per_channel=True)])
def test_fake_quant_ste_gradient(kw):
    """Identity inside the clip, zero outside, half on a tie with the clip
    bound (the max-abs element), exactly as jax.grad of the reference."""
    x = np.random.default_rng(2).normal(size=(7, 3)).astype(np.float32)
    jc, tc = jq.QConfig(**kw), tq.QConfig(**kw)
    scale = None
    if not kw.get("signed", True):
        # a fixed scale so that some inputs land outside [qmin, qmax]
        scale = np.float32(0.01)
    jg = jax.grad(lambda v: jnp.sum(jq.fake_quant(
        v, jc, None if scale is None else jnp.float32(scale))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tq.fake_quant(xt, tc, None if scale is None else torch.tensor(scale)
                  ).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    q = np.round(x / (scale if scale is not None else
                      np.asarray(jq.compute_scale(jnp.asarray(x), jc))))
    inside = (q > tc.qmin) & (q < tc.qmax)
    assert np.all(xt.grad.numpy()[inside] == 1.0)
    assert np.all(xt.grad.numpy()[(q < tc.qmin) | (q > tc.qmax)] == 0.0)


def test_binarize_forward_and_backward():
    x = np.array([-2.0, -1.0, -0.3, 0.0, 0.4, 1.0, 1.5], np.float32)
    jy, jvjp = jax.vjp(jq.binarize, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = tq.binarize(xt)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    g = np.linspace(0.5, 2.0, x.size).astype(np.float32)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(jvjp(jnp.asarray(g))[0]))


def test_ste_round_identity_gradient():
    x = torch.tensor([0.5, 1.5, -2.5, 0.2], requires_grad=True)
    y = tq.ste_round(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jq.ste_round(jnp.asarray(
                                      x.detach().numpy()))))
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(4))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sfc", "cnv"])
@pytest.mark.parametrize("qat", [True, False])
def test_apply_vision_logits_match_reference(kind, qat):
    jc, tc = _cfgs(kind)
    tp = tv.init_vision(tc, 1, device="cpu")
    x = _images(0, jc.channels)
    want = np.asarray(jv.apply_vision(_to_ref(tp), jc, jnp.asarray(x),
                                      qat=qat))
    got = tv.apply_vision(tp, tc, torch.from_numpy(x), qat=qat).numpy()
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["sfc", "cnv"])
def test_reference_params_cross_over(kind):
    """vision_from_reference: the reference's init_vision tree, layouts
    kept, drives the port to the reference's logits; the ranges recorded
    on the way agree."""
    jc, tc = _cfgs(kind, "relu")
    jp = jv.init_vision(jc, jax.random.PRNGKey(3))
    tp = vision_from_reference(jax.tree.map(np.asarray, jp), tc,
                               device="cpu")
    assert {k: {kk: tuple(v.shape) for kk, v in d.items()}
            for k, d in tp.items()} == {
        k: {kk: tuple(v.shape) for kk, v in d.items()} for k, d in jp.items()}
    x = _images(4, jc.channels)
    jr, tr = {}, {}
    want = np.asarray(jv.apply_vision(jp, jc, jnp.asarray(x), ranges=jr))
    got = tv.apply_vision(tp, tc, torch.from_numpy(x), ranges=tr).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert list(tr) == list(jr)
    for name in jr:
        np.testing.assert_allclose(tr[name], jr[name], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="do not match"):
        vision_from_reference({"fc0": jp[next(iter(jp))]}, tc, device="cpu")


@pytest.mark.parametrize("kind", ["sfc", "cnv"])
def test_sgd_step_gradients_match_reference(kind):
    jc, tc = _cfgs(kind)
    tp = tv.init_vision(tc, 2, device="cpu")
    x = _images(5, jc.channels)
    labels = np.array([1, 7, 3, 0])

    def jloss(p):
        logp = jax.nn.log_softmax(jv.apply_vision(p, jc, jnp.asarray(x)))
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                             1))

    jg = jax.grad(jloss)(_to_ref(tp))
    leaves = [t.requires_grad_(True) for d in tp.values() for t in d.values()]
    loss = torch.nn.functional.cross_entropy(
        tv.apply_vision(tp, tc, torch.from_numpy(x)),
        torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, leaves)
    names = [(k, kk) for k, d in tp.items() for kk in d]
    for (k, kk), g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k][kk]), rtol=0,
                                   atol=1e-5, err_msg=f"{k}.{kk}")


def _ranges(kind, act):
    jc, tc = _cfgs(kind, act)
    tp = tv.init_vision(tc, 0, device="cpu")
    ranges = {}
    tv.apply_vision(tp, tc, torch.from_numpy(_images(6, jc.channels, 16)),
                    ranges=ranges)
    return jc, tc, tp, ranges


@pytest.mark.parametrize("mode", ["pwlf", "pot", "apot"])
@pytest.mark.parametrize("kind,act", [("sfc", "silu"), ("cnv", "relu")])
def test_make_grau_acts_register_files_identical(mode, kind, act):
    jc, tc, _, ranges = _ranges(kind, act)
    kw = dict(mode=mode, segments=6, num_exponents=8, bias_mode="anchor")
    ji = jv.make_grau_acts(jc, ranges, **kw)
    ti = tv.make_grau_acts(tc, ranges, **kw)
    assert list(ji) == list(ti) == list(ranges)
    for name in ranges:
        jfit, js_in, js_out = ji[name].__defaults__
        t = ti[name]
        assert (t.s_in, t.s_out) == (js_in, js_out)
        if mode == "pwlf":
            for f in ("breakpoints", "slopes", "intercepts"):
                np.testing.assert_array_equal(getattr(t.pwl, f),
                                              getattr(jfit, f))
            continue
        for f in ("num_segments", "num_exponents", "out_bits", "out_signed"):
            assert getattr(t.spec, f) == getattr(jfit, f)
        for f in ("breakpoints", "enc", "sign", "bias", "pre_shift"):
            np.testing.assert_array_equal(getattr(t.spec, f).numpy(),
                                          np.asarray(getattr(jfit, f)))


@pytest.mark.parametrize("mode", ["pot", "apot", "pwlf"])
def test_integer_path_activations_identical(mode):
    jc, tc, _, ranges = _ranges("sfc", "silu")
    kw = dict(mode=mode, segments=6, num_exponents=8, bias_mode="anchor")
    ji = jv.make_grau_acts(jc, ranges, **kw)
    ti = tv.make_grau_acts(tc, ranges, **kw)
    rng = np.random.default_rng(7)
    for name, (lo, hi) in ranges.items():
        z = rng.uniform(2 * lo, 2 * hi, size=(64, 32)).astype(np.float32)
        want = np.asarray(ji[name](jnp.asarray(z)))
        got = ti[name](torch.from_numpy(z)).numpy()
        a = z.astype(np.float64) / ti[name].s_in
        frac = np.abs(a - np.floor(a) - 0.5)
        far = frac > 1e-6 * np.maximum(1.0, np.abs(a))
        np.testing.assert_array_equal(got[far], want[far])
        assert np.mean(got == want) >= 0.99


def test_integer_path_runs_the_unit_it_is_given():
    """unit= routes every integer activation (the chip check passes the
    plain unit and the kernel through it); the float path never calls it."""
    _, tc, tp, ranges = _ranges("sfc", "relu")
    calls = []

    def unit(a, spec):
        calls.append(a.dtype)
        return ops.grau(a, spec)

    impls = tv.make_grau_acts(tc, ranges, mode="pot", segments=6,
                              num_exponents=8, unit=unit)
    x = torch.from_numpy(_images(8, 1))
    tv.apply_vision(tp, tc, x, act_impls=impls)
    assert calls == [torch.int32] * len(ranges)
    tv.apply_vision(tp, tc, x)
    assert len(calls) == len(ranges)


# ---------------------------------------------------------------------------
# pipeline and harness
# ---------------------------------------------------------------------------

def test_image_pipeline_shapes_labels_and_determinism():
    p = ImagePipeline(num_classes=10, hw=16, channels=3, global_batch=32,
                      seed=4, device="cpu")
    b = p.batch(5)
    assert b["image"].shape == (32, 16, 16, 3)
    assert b["image"].dtype == torch.float32 and b["image"].device.type == "cpu"
    assert b["label"].shape == (32,) and b["label"].dtype == torch.int64
    assert int(b["label"].min()) >= 0 and int(b["label"].max()) < 10
    again = ImagePipeline(num_classes=10, hw=16, channels=3, global_batch=32,
                          seed=4, device="cpu").batch(5)
    assert torch.equal(b["image"], again["image"])
    assert torch.equal(b["label"], again["label"])
    assert not torch.equal(b["image"], p.batch(6)["image"])
    other = ImagePipeline(num_classes=10, hw=16, channels=3, global_batch=32,
                          seed=5, device="cpu").batch(5)
    assert not torch.equal(b["image"], other["image"])
    # the blob sits where the label puts it: the class centre is brighter
    # than the opposite point of the circle
    img = b["image"].mean(-1)
    lab = b["label"].float()
    ang = 2 * np.pi * lab / 10
    cx, cy = (8 + 4 * torch.cos(ang)).round().long(), (
        8 + 4 * torch.sin(ang)).round().long()
    ox, oy = (8 - 4 * torch.cos(ang)).round().long(), (
        8 - 4 * torch.sin(ang)).round().long()
    idx = torch.arange(32)
    assert float((img[idx, cy, cx] - img[idx, oy, ox]).mean()) > 0.5


def test_train_and_eval_on_the_cpu():
    """A few SGD steps lower the loss; eval records one range a layer and
    the GRAU replacement keeps the model's predictions close."""
    tc = tv.VisionConfig(kind="sfc", activation="relu", hw=8, channels=1,
                         widths=(32, 32))
    params, pipe = tv.train_vision(tc, steps=30, batch=32, lr=0.1,
                                   device="cpu")
    assert all(not t.requires_grad for d in params.values()
               for t in d.values())
    ranges = {}
    acc = tv.eval_vision(params, tc, pipe, ranges=ranges, steps=2)
    assert list(ranges) == ["fc0", "fc1"] and acc > 0.3
    impls = tv.make_grau_acts(tc, ranges, mode="apot", segments=6,
                              num_exponents=8)
    assert abs(tv.eval_vision(params, tc, pipe, act_impls=impls, steps=2)
               - acc) <= 0.1
