"""The port's recurrent layers against the JAX package, on the CPU:
``models/scan_utils.py`` (the chunked linear recurrence and the causal
depthwise conv), ``models/ssm.py`` (mamba) and ``models/rglru.py``
(RG-LRU), and ``models/xla_math.py``, whose float32 ``log``, ``expm1`` and
``linspace`` make the blocks' constant inits bitwise the reference's.

Tolerances: float32 outputs within rtol 1e-5 / atol 1e-6 (the port scans a
chunk in log steps, the reference with ``associative_scan``, whose
combination trees differ); gradients within a relative L2 error of 1e-5
over all leaves; the XLA-math mirror and the constant inits bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import scan_utils as jscan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import scan_utils as tscan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import xla_math  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD_L2 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch ops of this file on one thread (the test run spreads files
    over several processes on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=FWD):
    torch.testing.assert_close(got, _t(want), **tol)


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k] - _t(want[k])) ** 2).sum()) for k in want)
    den = sum(float((_t(want[k]) ** 2).sum()) for k in want)
    return (num / den) ** 0.5


# ---------------------------------------------------------------------------
# scan_utils
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [5, 8, 16, 24])  # <= chunk, = chunk, 2, 3
def test_chunked_linear_recurrence_matches_reference(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, size=(2, s, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, s, 3, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    jh, jl = jscan.chunked_linear_recurrence(jnp.asarray(a), jnp.asarray(b),
                                             jnp.asarray(h0), chunk=8)
    th, tl = tscan.chunked_linear_recurrence(_t(a), _t(b), _t(h0), chunk=8)
    _close(th, jh)
    _close(tl, jl)
    # against the sequential recurrence in float64
    h, want = h0.astype(np.float64), []
    for i in range(s):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    np.testing.assert_allclose(th.numpy(), np.stack(want, 1), rtol=1e-5,
                               atol=1e-5)


def test_chunked_linear_recurrence_rejects_ragged_chunks():
    a = torch.ones(1, 12, 2)
    with pytest.raises(AssertionError, match="not divisible"):
        tscan.chunked_linear_recurrence(a, a, torch.zeros(1, 2), chunk=8)


@pytest.mark.parametrize("bias", [False, True])
def test_causal_depthwise_conv_matches_reference(bias):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32) if bias else None
    want = jscan.causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    got = tscan.causal_depthwise_conv(_t(x), _t(w),
                                      None if b is None else _t(b))
    _close(got, want)
    # causal: the first output sees only the first input
    np.testing.assert_allclose(got[:, 0].numpy(), x[:, 0] * w[-1]
                               + (0 if b is None else b), rtol=1e-6)


# ---------------------------------------------------------------------------
# the XLA-math mirror and the constant inits
# ---------------------------------------------------------------------------
def test_xla_math_bitwise_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.arange(1, 2049, dtype=np.float32),
                        rng.uniform(0, 4, 20000).astype(np.float32),
                        np.exp(rng.uniform(-80, 80, 20000)).astype(
                            np.float32),
                        np.float32([0.0, 1e-40, np.inf, -1.0])])
    want = np.asarray(jnp.log(x))
    got = xla_math.log(_t(x)).numpy()
    assert np.array_equal(got, want, equal_nan=True)
    y = np.concatenate([rng.uniform(-1, 1, 20000),
                        rng.uniform(-1e-3, 1e-3, 2000),
                        rng.uniform(-20, 20, 2000), [0.0, 0.5, -0.5]]
                       ).astype(np.float32)
    assert np.array_equal(xla_math.expm1(_t(y)).numpy(),
                          np.asarray(jnp.expm1(y)))
    for n in (2, 3, 64, 128, 352, 353, 500, 2560):
        assert np.array_equal(xla_math.linspace(0.9, 0.999, n).numpy(),
                              np.asarray(jnp.linspace(0.9, 0.999, n))), n


@pytest.mark.parametrize("arch,width", [("falcon-mamba-7b", None),
                                        ("falcon-mamba-7b", "published"),
                                        ("recurrentgemma-2b", None),
                                        ("recurrentgemma-2b", "published")])
def test_block_constants_bitwise_reference(arch, width):
    """A_log, dt_bias, D (mamba) and Lambda (RG-LRU), at ``reduced()`` and
    at the published state widths (the constants take no random draw)."""
    jcfg = jconfigs.get_config(arch)
    cfg = configs.get_config(arch)
    if width is None:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    if cfg.family == "ssm":
        a = jnp.tile(jnp.arange(1, cfg.ssm_state + 1, dtype=jnp.float32)[
            None, :], (cfg.d_inner, 1))
        want = {"A_log": jnp.log(a), "dt_bias": jnp.full((cfg.d_inner,), -4.6),
                "D": jnp.ones((cfg.d_inner,))}
        if width is None:
            got = tssm.init_mamba_block(trandom.PRNGKey(1), cfg,
                                        torch.float32)
            jp = jssm.init_mamba_block(jax.random.PRNGKey(1), jcfg,
                                       jnp.float32)
            want = {k: jp[k] for k in want}
        else:
            got = {"A_log": xla_math.log(torch.arange(
                1, cfg.ssm_state + 1, dtype=torch.float32)).expand(
                    cfg.d_inner, -1)}
            want = {"A_log": want["A_log"]}
    else:
        w = cfg.lru_width
        want = {"Lambda": jnp.log(jnp.expm1(
            -jnp.log(jnp.linspace(0.9, 0.999, w)) / jrglru.RGLRU_C))}
        if width is None:
            got = trglru.init_rglru_block(trandom.PRNGKey(1), cfg,
                                          torch.float32)
        else:
            got = {"Lambda": xla_math.log(xla_math.expm1(
                -xla_math.log(xla_math.linspace(0.9, 0.999, w))
                / trglru.RGLRU_C))}
    for k, v in want.items():
        assert torch.equal(got[k], _t(v)), k


# ---------------------------------------------------------------------------
# mamba and RG-LRU blocks: forward and gradient
# ---------------------------------------------------------------------------
def _block(kind, seed=0):
    arch = "falcon-mamba-7b" if kind == "mamba" else "recurrentgemma-2b"
    jcfg, cfg = (jconfigs.get_config(arch).reduced(),
                 configs.get_config(arch).reduced())
    if kind == "mamba":
        jp = jssm.init_mamba_block(jax.random.PRNGKey(seed), jcfg,
                                   jnp.float32)
        jf, tf_ = jssm.mamba_forward, tssm.mamba_forward
    else:
        jp = jrglru.init_rglru_block(jax.random.PRNGKey(seed), jcfg,
                                     jnp.float32)
        jf, tf_ = jrglru.rglru_forward, trglru.rglru_forward
    # move the zero biases off zero, so that their gradients are exercised
    rng = np.random.default_rng(seed)
    jp = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1)
              if k in ("conv_b", "b_a", "b_i") else v) for k, v in jp.items()}
    tp = {k: _t(v) for k, v in jp.items()}
    return jcfg, cfg, jp, tp, jf, tf_


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
@pytest.mark.parametrize("s,chunk", [(12, 256), (16, 8)])
def test_block_forward_and_gradient_match_reference(kind, s, chunk):
    jcfg, cfg, jp, tp, jf, tf_ = _block(kind)
    x = np.random.default_rng(1).normal(size=(2, s, cfg.d_model)).astype(
        np.float32)
    # the gradient of a weighted sum of the output, to params and input
    wt = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    want, jg = jax.jit(lambda p, xx: (
        jf(p, xx, jcfg, chunk=chunk),
        jax.grad(lambda q, y: jnp.sum(jf(q, y, jcfg, chunk=chunk) * wt),
                 argnums=(0, 1))(p, xx)))(jp, jnp.asarray(x))
    got = tf_(tp, _t(x), cfg, chunk=chunk)
    assert got.shape == (2, s, cfg.d_model)
    _close(got, want)
    tg = torch.func.grad(lambda p, xx: (tf_(p, xx, cfg, chunk=chunk)
                                        * _t(wt)).sum(),
                         argnums=(0, 1))(tp, _t(x))
    err = _rel_l2(dict(tg[0], x=tg[1]), dict(jg[0], x=jg[1]))
    assert err <= GRAD_L2, err


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` past torch's softplus threshold of 20."""
    x = np.float32([-30.0, -1.0, 0.0, 3.0, 19.0, 21.0, 40.0])
    _close(tssm.softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)),
           dict(rtol=1e-6, atol=0))
