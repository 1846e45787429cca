"""PyTorch port vs the JAX reference: the Mixture-of-Experts layer
(`repro_torch.nn.moe` against `repro.nn.moe`) at smoke size in f32.

Both packages get the same seeded numpy parameters and activations.
Expert choices must be equal exactly (ties go to the lower expert index,
as jax.lax.top_k's do); outputs within 1e-5, the router's load-balancing
loss within 1e-6, gradients (autograd against jax.grad, of sum(y * g) +
aux with respect to every parameter and to x) within 1e-4. Capacity drops
(capacity=1, and the capacity factor of "train" mode) must keep the same
(token, k) slots: a dropped token's routed output is exactly zero on both
sides.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.nn import moe as jmoe  # noqa: E402
from repro.nn.common import ParamBuilder  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402

D, F_, E, B, S = 32, 24, 4, 2, 10
TOL_Y, TOL_AUX, TOL_GRAD = 1e-5, 1e-6, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = dict(dict(num_experts=E, top_k=1, d_ff=F_), **kw)
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _params(cfg, seed, d=D):
    """Seeded numpy parameters with the reference's leaf shapes."""
    rng = np.random.default_rng(seed)
    shapes = {"router": (d, cfg.num_experts),
              "w_gate": (cfg.num_experts, d, cfg.d_ff),
              "w_up": (cfg.num_experts, d, cfg.d_ff),
              "w_down": (cfg.num_experts, cfg.d_ff, d)}
    if cfg.num_shared:
        sf = cfg.d_ff * cfg.num_shared
        shapes.update(ws_gate=(d, sf), ws_up=(d, sf), ws_down=(sf, d))
    return {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
            for k, s in shapes.items()}


def _x(seed, b=B, s=S, d=D):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _ref_choice(params, x, cfg):
    """The reference's routing decision: jax.lax.top_k on its scores."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = xt @ jnp.asarray(params["router"])
    scores = (jax.nn.sigmoid(logits) if cfg.gate == "sigmoid"
              else jax.nn.softmax(logits, axis=-1))
    return np.asarray(jax.lax.top_k(scores, cfg.top_k)[1])


def _run_both(params, x, jcfg, tcfg, capacity):
    jy, jaux = jmoe.apply_moe({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), jcfg, jax.nn.silu,
                              capacity=capacity)
    ty, taux = tmoe.apply_moe({k: torch.from_numpy(v)
                               for k, v in params.items()},
                              torch.from_numpy(x), tcfg, torch.nn.functional.silu,
                              capacity=capacity)
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("gate", ["softmax", "sigmoid"])
def test_apply_moe_matches_reference(gate, top_k, shared):
    """Expert choice, output, aux loss and gradients at full capacity and
    at the capacity factor (tokens may drop)."""
    jcfg, tcfg = _cfgs(top_k=top_k, num_shared=shared, gate=gate)
    params, x = _params(jcfg, 1), _x(2)
    _, topi, _ = tmoe.route({k: torch.from_numpy(v) for k, v in
                             params.items()},
                            torch.from_numpy(x).reshape(-1, D), tcfg)
    np.testing.assert_array_equal(topi.numpy(), _ref_choice(params, x, jcfg))
    for capacity in (B * S * top_k, None):
        (jy, jaux), (ty, taux) = _run_both(params, x, jcfg, tcfg, capacity)
        np.testing.assert_allclose(ty, jy, rtol=TOL_Y, atol=TOL_Y)
        assert abs(taux - jaux) <= TOL_AUX

    g = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.apply_moe(p, xx, jcfg, jax.nn.silu)
        return jnp.sum(y * g) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.apply_moe(tp, tx, tcfg, torch.nn.functional.silu)
    (torch.sum(y * torch.from_numpy(g)) + aux).backward()
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=TOL_GRAD, atol=TOL_GRAD, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=TOL_GRAD, atol=TOL_GRAD)


@pytest.mark.parametrize("capacity", [1, None])
def test_capacity_drops_keep_the_reference_slots(capacity):
    """capacity=1, and the capacity factor's c = int(1.25 t k / E) = 6 of
    20 routed slots: the same tokens drop (their routed output exactly
    zero, no shared expert) and the rest agree within 1e-5."""
    jcfg, tcfg = _cfgs(top_k=1)
    # a router biased toward expert 0, so that its queue overflows
    params = _params(jcfg, 4)
    params["router"][:, 0] += 0.5
    x = _x(5)
    (jy, jaux), (ty, taux) = _run_both(params, x, jcfg, tcfg, capacity)
    jdrop = np.all(jy.reshape(-1, D) == 0, axis=-1)
    tdrop = np.all(ty.reshape(-1, D) == 0, axis=-1)
    c = tmoe.capacity_for(tcfg, B * S, capacity)
    assert c == (capacity or int(1.25 * B * S / E))
    assert tdrop.any() and not tdrop.all()
    np.testing.assert_array_equal(tdrop, jdrop)
    _, topi, _ = tmoe.route({k: torch.from_numpy(v) for k, v in
                             params.items()},
                            torch.from_numpy(x).reshape(-1, D), tcfg)
    pos = tmoe.queue_positions(topi, E).numpy()
    np.testing.assert_array_equal(tdrop, pos >= c)
    np.testing.assert_allclose(ty, jy, rtol=TOL_Y, atol=TOL_Y)
    assert abs(taux - jaux) <= TOL_AUX


@pytest.mark.parametrize("gate", ["softmax", "sigmoid"])
def test_ties_go_to_the_lower_expert(gate):
    """Equal scores: experts 1 and 3 share a router column (softmax: equal
    scores bit for bit), or every logit is large enough that the sigmoid
    saturates to exactly 1.0 in f32; the port picks the lower index, as
    jax.lax.top_k does, and the outputs agree."""
    jcfg, tcfg = _cfgs(top_k=2, gate=gate)
    params, x = _params(jcfg, 6), _x(7)
    if gate == "softmax":
        params["router"][:, 3] = params["router"][:, 1]
        params["router"][:, 1] += 5.0 * np.sign(x.reshape(-1, D).mean(0))
        params["router"][:, 3] = params["router"][:, 1]
    else:
        params["router"][:] = 50.0 * np.sign(x.reshape(-1, D).mean(0))[:, None]
    _, topi, _ = tmoe.route({k: torch.from_numpy(v) for k, v in
                             params.items()},
                            torch.from_numpy(x).reshape(-1, D), tcfg)
    want = _ref_choice(params, x, jcfg)
    np.testing.assert_array_equal(topi.numpy(), want)
    if gate == "softmax":
        # where expert 1 wins, its tie with 3 takes the second place too
        assert (want[:, 0] == 1).any()
        assert np.all(want[want[:, 0] == 1][:, 1] == 3)
    else:
        assert np.all(want == [0, 1])
    (jy, jaux), (ty, taux) = _run_both(params, x, jcfg, tcfg, None)
    np.testing.assert_allclose(ty, jy, rtol=TOL_Y, atol=TOL_Y)
    assert abs(taux - jaux) <= TOL_AUX


def test_init_moe_layout_and_expert_fan_in():
    """init_moe has the reference's leaves and shapes; an expert leaf
    (E, a, b) takes the reference's fan-in rule, whose fan in is shape[0]
    = E (|w| <= 2 / sqrt(E), std near 1 / sqrt(E)), drawn expert by expert
    (every expert its own draw)."""
    cfg = tmoe.MoEConfig(num_experts=8, top_k=1, d_ff=64, num_shared=1)
    pb = ParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    jmoe.init_moe(pb, 96, jmoe.MoEConfig(**dataclasses.asdict(cfg)))
    gen = torch.Generator().manual_seed(0)
    mine = tmoe.init_moe(96, cfg, gen, device="cpu", dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in pb.params.items()}
    assert all(v.dtype == torch.bfloat16 for v in mine.values())
    w = mine["w_gate"].float()
    std = 1 / np.sqrt(cfg.num_experts)
    assert float(w.abs().max()) <= 2 * std * (1 + 2 ** -7)
    assert abs(float(w.std()) / std - 0.88) < 0.05   # truncated at 2 sigma
    assert not torch.equal(mine["w_up"][0], mine["w_up"][1])
    assert float(mine["router"].float().abs().max()) <= 2 / np.sqrt(96) * (
        1 + 2 ** -7)
