"""The port's MoE FFN (``models/moe.py``) against the JAX package's
auto-partitioned path, on the CPU: the init from the same key, the output
and the load-balance aux loss with their gradient, a capacity that drops
choices, a zero router (every choice ties, and the expert order must be
``lax.top_k``'s), padded experts, and the block under ``torch.func.vmap``
(the engine runs it per client so).

Tolerances: outputs and aux within rtol 1e-5 / atol 1e-6; gradients within
a relative L2 error of 1e-5; the init within rtol 1e-5 / atol 1e-7
(threefry is bitwise, ``normal``'s ``log1p`` a few ulps off XLA's); the
routing (chosen experts, slots, dropped choices) exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-6)
INIT = dict(rtol=1e-5, atol=1e-7)
GRAD_L2 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _cfgs(**kw):
    jcfg = dataclasses.replace(
        jconfigs.get_config("qwen2-moe-a2.7b").reduced(), **kw)
    cfg = dataclasses.replace(
        configs.get_config("qwen2-moe-a2.7b").reduced(), **kw)
    return jcfg, cfg


def _params(jcfg, seed=0):
    jp = jmoe.init_moe_block(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, {k: _t(v) for k, v in jp.items()}


def _x(cfg, b=2, s=12, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _check(jcfg, cfg, jp, tp, x):
    """Output, aux and the gradient of a weighted sum of both, to the
    params and the input."""
    wt = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.moe_forward(p, xx, jcfg)
        return jnp.sum(out * wt) + 3.0 * aux

    (jo, ja), jg = jax.jit(lambda p, xx: (
        jmoe.moe_forward(p, xx, jcfg),
        jax.grad(jloss, argnums=(0, 1))(p, xx)))(jp, jnp.asarray(x))
    to, ta = tmoe.moe_forward(tp, _t(x), cfg)
    torch.testing.assert_close(to, _t(jo), **FWD)
    torch.testing.assert_close(ta, _t(ja), **FWD)

    def tloss(p, xx):
        out, aux = tmoe.moe_forward(p, xx, cfg)
        return (out * _t(wt)).sum() + 3.0 * aux

    tg = torch.func.grad(tloss, argnums=(0, 1))(tp, _t(x))
    want = dict(jg[0], x=jg[1])
    got = dict(tg[0], x=tg[1])
    num = sum(float(((got[k] - _t(want[k])) ** 2).sum()) for k in want)
    den = sum(float((_t(want[k]) ** 2).sum()) for k in want)
    assert (num / den) ** 0.5 <= GRAD_L2
    return tmoe.route(tp, _t(x).reshape(-1, cfg.d_model), cfg)


def test_init_moe_block_matches_reference():
    jcfg, cfg = _cfgs()
    jp, want = _params(jcfg, seed=3)
    got = tmoe.init_moe_block(trandom.PRNGKey(3), cfg, torch.float32)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        torch.testing.assert_close(got[k], want[k], **INIT)
    e_pad = tmoe.padded_n_experts(cfg)
    assert e_pad == jmoe.padded_n_experts(jcfg) == 16
    assert got["w_gate"].shape[0] == e_pad
    assert got["router"].shape == (cfg.d_model, cfg.n_experts)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu"])
def test_moe_forward_and_gradient_match_reference(mlp_type):
    jcfg, cfg = _cfgs(mlp_type=mlp_type)
    jp, tp = _params(jcfg)
    r = _check(jcfg, cfg, jp, tp, _x(cfg))
    assert r.cap == tmoe.capacity(cfg, 24) == int(max(
        2, -(-2 * 24 // 4) * 1.25))


def test_moe_capacity_drops_choices_as_reference():
    """At capacity factor 0.3 most experts overflow: the dropped choices
    are those past each expert's capacity, counted token-major."""
    jcfg, cfg = _cfgs(capacity_factor=0.3)
    jp, tp = _params(jcfg, seed=2)
    x = _x(cfg, b=3, s=16, seed=4)
    r = _check(jcfg, cfg, jp, tp, x)
    n_drop = int(r.overflow.sum())
    assert 0 < n_drop < r.overflow.numel()
    # the reference's positions, from its own top-k, token-major
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, cfg.d_model))
                           @ jp["router"], axis=-1)
    top_e = np.asarray(jax.lax.top_k(probs, cfg.moe_top_k)[1]).reshape(-1)
    seen = np.zeros(tmoe.padded_n_experts(cfg), int)
    pos = []
    for e in top_e:
        pos.append(seen[e])
        seen[e] += 1
    pos = np.minimum(pos, r.cap)
    assert np.array_equal(r.flat_e.numpy(), top_e)
    assert np.array_equal(r.flat_pos.numpy(), pos)
    assert n_drop == int((np.asarray(pos) == r.cap).sum())


def test_moe_zero_router_ties_break_to_lower_experts():
    """A zero router gives every expert the same probability: ``lax.top_k``
    takes experts 0 .. k-1 for every token, and so must the port."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    r = _check(jcfg, cfg, jp, tp, _x(cfg, seed=5))
    k = cfg.moe_top_k
    assert np.array_equal(r.flat_e.numpy().reshape(-1, k),
                          np.tile(np.arange(k), (24, 1)))
    assert torch.equal(r.top_p, torch.full((24, k), 1.0 / k))


def test_padded_experts_never_chosen():
    """Six experts pad to sixteen stacked weights; the router keeps six
    columns, so the ten padded experts get no choice and no gradient."""
    jcfg, cfg = _cfgs(n_experts=6, moe_top_k=3)
    jp, tp = _params(jcfg, seed=6)
    assert tp["w_up"].shape[0] == 16 and tp["router"].shape[1] == 6
    x = _x(cfg, seed=7)
    r = _check(jcfg, cfg, jp, tp, x)
    assert int(r.flat_e.max()) < 6
    g = torch.func.grad(lambda p: tmoe.moe_forward(p, _t(x), cfg)[0].sum())(
        tp)
    assert not g["w_down"][6:].any() and g["w_down"][:6].any()


def test_moe_under_vmap_equals_loop():
    """The engine vmaps the client step: the dispatch (``index_add``) and
    the combine stay per client."""
    jcfg, cfg = _cfgs()
    _, tp = _params(jcfg)
    x = _t(np.stack([_x(cfg, seed=s) for s in range(3)]))
    out, aux = torch.func.vmap(lambda xx: tmoe.moe_forward(tp, xx, cfg))(x)
    for i in range(3):
        o, a = tmoe.moe_forward(tp, x[i], cfg)
        assert torch.equal(out[i], o) and torch.equal(aux[i], a)
