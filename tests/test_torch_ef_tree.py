"""Parity of the port's error-feedback tree API (``repro_torch.core.
compression.error_feedback``: ``init_error_state``, ``ef_compress``,
``tree_init_error``, ``tree_ef_compress``, ``is_k_contraction``) against
the JAX reference, and the port-side property tests of EF.

The tree is gemma-2b's ``reduced()`` parameter tree (11 leaves, 541 312
elements): nested on the reference's side, the port's flat ``/``-keyed dict
(``convert.lm_params_from_jax``) on the other, whose sorted keys are
``jax.tree.leaves`` order. Each of the nine per-leaf compressors runs with
k = max(1, ceil(1% of the leaf)), r = min(4k, d), 256 levels, blocks of
4096 and eps 1, one key for every leaf, from a nonzero float32 error.

Tolerances: sign, ternary, top-k, rand-k and R-top-K are bitwise (compressed
leaves and new errors). QSGD, random sparsification, scaled sign and
blockwise scaled sign sum over each leaf (XLA's order is not PyTorch's):
compressed values hold to ``RTOL`` (float32; one bfloat16 ulp for bf16
leaves), the new errors to the same tolerance scaled by the leaf's largest
compressed value, and the coordinates where a dither rounded or kept the
other way are counted, at most ``MAX_FLIPS`` over the tree.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.compression import error_feedback as jef  # noqa: E402
from repro.core.compression import quantize as jq  # noqa: E402
from repro.core.compression import sparsify as js  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.convert import key_from_jax, lm_params_from_jax  # noqa
from repro_torch.core.compression import error_feedback as tef  # noqa: E402
from repro_torch.core.compression import quantize as tq  # noqa: E402
from repro_torch.core.compression import sparsify as ts  # noqa: E402

RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}  # bf16: one ulp
MAX_FLIPS = 3
BITWISE = ("sign", "ternary", "topk", "randk", "rtopk")
# own strategy: finite float32 values (bounds exactly representable)
VALUES = st.floats(-1e3, 1e3, allow_nan=False, allow_infinity=False,
                   width=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch ops of this file on one thread: the test run spreads files over
    several processes on one host, where threefry's many int64 ops stall on
    oversubscribed intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _k(x) -> int:
    n = math.prod(x.shape)
    return max(1, math.ceil(n / 100))


def _compressors(mod_q, mod_s, key):
    """name -> comp(x) -> (compressed, meta) of one package, the phase's
    parameters."""
    return {
        "qsgd": lambda x: mod_q.qsgd(key, x, 256),
        "ternary": lambda x: mod_q.ternary(key, x),
        "sign": mod_q.sign_compress,
        "scaled_sign": mod_q.scaled_sign,
        "blockwise_scaled_sign": lambda x: mod_q.blockwise_scaled_sign(
            x, 4096),
        "random_sparsify": lambda x: mod_s.random_sparsify(key, x, 1.0),
        "topk": lambda x: mod_s.topk_sparsify(x, _k(x)),
        "randk": lambda x: mod_s.randk_sparsify(key, x, _k(x)),
        "rtopk": lambda x: mod_s.rtopk_sparsify(
            key, x, min(4 * _k(x), math.prod(x.shape)), _k(x)),
    }


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


@pytest.fixture(scope="module")
def trees():
    """The reduced gemma-2b tree as numpy (nested) and its float32
    error."""
    cfg = get_config("gemma-2b").reduced()
    shapes = jax.eval_shape(lambda k: jtf.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)
    e = jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape)).astype(
        np.float32), shapes)
    return x, e


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(dtype)),
                        tree)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("name", list(_compressors(tq, ts, None)))
def test_tree_ef_compress_reduced_gemma(trees, name, dtype):
    x_np, e_np = trees
    x_np = _cast(x_np, dtype)
    key = jax.random.PRNGKey(1)
    jc, je = jef.tree_ef_compress(_compressors(jq, js, key)[name],
                                  jax.tree.map(jnp.asarray, x_np),
                                  jax.tree.map(jnp.asarray, e_np))
    tx, te = lm_params_from_jax(x_np), lm_params_from_jax(e_np)
    tc, te2 = tef.tree_ef_compress(
        _compressors(tq, ts, key_from_jax(key))[name], tx, te)
    assert list(tc) == sorted(tx) and list(te2) == sorted(tx)
    flips = 0
    for k, c_want, e_want in zip(sorted(tx), jax.tree.leaves(jc),
                                 jax.tree.leaves(je)):
        c_got, e_got = tc[k], te2[k]
        assert c_got.dtype == tx[k].dtype and e_got.dtype == torch.float32
        assert str(c_want.dtype) == dtype and c_got.shape == tx[k].shape
        cg, cw, eg, ew = _np(c_got), _np(c_want), _np(e_got), _np(e_want)
        if name in BITWISE:
            np.testing.assert_array_equal(cg, cw)
            np.testing.assert_array_equal(eg, ew)
            continue
        off = ~np.isclose(cg, cw, rtol=RTOL[dtype], atol=0.0)
        flips += int(off.sum())
        tol = RTOL[dtype] * max(np.abs(cw).max(), 1e-30)
        np.testing.assert_allclose(eg[~off], ew[~off], rtol=0, atol=tol)
        # the identity c + e' = x + e, to float32 rounding
        corrected = _np(tx[k]) + _np(te[k])
        np.testing.assert_allclose(cg + eg, corrected, rtol=1e-6,
                                   atol=1e-6)
    assert flips <= MAX_FLIPS


def test_init_error_state_and_tree_structure(trees):
    x_np, _ = trees
    flat = lm_params_from_jax(_cast(x_np, "bfloat16"))
    nested = {"b": [flat["embed"], (flat["final_norm/scale"], None)],
              "a": {"z": flat["blocks/attn/wq"], "y": flat["blocks/mlp/w_up"]}}
    for tree in (flat, nested):
        e = tef.tree_init_error(tree)
        leaves = tef._leaves(e)
        assert len(leaves) == len(tef._leaves(tree))
        for got, x in zip(leaves, tef._leaves(tree)):
            assert got.dtype == torch.float32 and got.shape == x.shape
            assert not got.any()
    e = tef.tree_init_error(nested)
    assert list(e) == ["a", "b"] and list(e["a"]) == ["y", "z"]
    assert isinstance(e["b"][1], tuple) and e["b"][1][1] is None
    # leaves in jax.tree.leaves order: sorted keys, lists in order
    assert jax.tree.leaves({"b": [1, (2, None)], "a": {"z": 3, "y": 4}}
                           ) == [4, 3, 1, 2]
    order = [flat["blocks/mlp/w_up"], flat["blocks/attn/wq"], flat["embed"],
             flat["final_norm/scale"]]
    assert all(a is b for a, b in zip(tef._leaves(nested), order))
    want = jef.init_error_state(jnp.zeros((3, 4), jnp.bfloat16))
    got = tef.init_error_state(torch.zeros((3, 4), dtype=torch.bfloat16))
    assert str(want.dtype) == "float32" and got.dtype == torch.float32


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_is_k_contraction_per_leaf(trees, dtype):
    """Top-k is a k-contraction on every leaf; the verdicts of top-k and
    scaled sign equal the reference's."""
    x_np, _ = trees
    jcomp = _compressors(jq, js, None)
    tcomp = _compressors(tq, ts, None)
    for a in jax.tree.leaves(_cast(x_np, dtype)):
        jx = jnp.asarray(a)
        tx = lm_params_from_jax({"x": a})["x"]
        k = _k(a)
        for name in ("topk", "scaled_sign"):
            got = bool(tef.is_k_contraction(tcomp[name], tx, k))
            assert got == bool(jef.is_k_contraction(jcomp[name], jx, k))
            if name == "topk":
                assert got


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_ef_compress_flushes_denormals(dtype):
    """The reference's add and subtract treat float32 denormals as zeros of
    their sign and flush denormal results; infinities and NaN pass through.
    Compressed leaves and new errors equal the reference's, zeros' signs
    included (NaN payloads aside)."""
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, 1.1754942e-38,
                     -1.17549435e-38, 2e-38, 5e-39, 1.0, -3.0, np.inf,
                     -np.inf, np.nan], np.float32)
    rng = np.random.default_rng(12)
    for _ in range(20):
        x = rng.choice(vals, 16)
        e = rng.choice(vals, 16)
        jx = jnp.asarray(x).astype(dtype)
        tx = lm_params_from_jax({"x": np.asarray(jx)})["x"]
        if dtype == "bfloat16":  # bit for bit, NaN included
            tx = torch.from_numpy(np.asarray(jx).view(np.int16).copy()).view(
                torch.bfloat16)
        for k in (1, 4, 16):
            for jcomp, tcomp in ((lambda v: js.topk_sparsify(v, k),
                                  lambda v: ts.topk_sparsify(v, k)),
                                 (jq.sign_compress, tq.sign_compress)):
                jc, je, _ = jef.ef_compress(jcomp, jx, jnp.asarray(e))
                tc, te, _ = tef.ef_compress(tcomp, tx, torch.from_numpy(e))
                for got, want in ((tc.to(torch.float32).numpy(),
                                   np.asarray(jc.astype(jnp.float32))),
                                  (te.numpy(), np.asarray(je))):
                    np.testing.assert_array_equal(np.signbit(got)[
                        ~np.isnan(got)], np.signbit(want)[~np.isnan(want)])
                    np.testing.assert_array_equal(got, want)


@given(st.lists(VALUES, min_size=8, max_size=200), st.integers(1, 8))
@settings(max_examples=40, deadline=None)
def test_topk_k_contraction_property(vals, k):
    """Def. 1 (eq. 22) for top-k on the port, and the reference's mask."""
    x = np.asarray(vals, np.float32)
    k = min(k, x.size)
    tx = torch.from_numpy(x)
    assert bool(tef.is_k_contraction(lambda v: ts.topk_sparsify(v, k), tx, k))
    np.testing.assert_array_equal(ts.topk_mask(tx, k).numpy(),
                                  np.asarray(js.topk_mask(jnp.asarray(x), k)))


@given(st.lists(VALUES, min_size=8, max_size=64),
       st.lists(VALUES, min_size=8, max_size=64), st.integers(1, 4))
@settings(max_examples=40, deadline=None)
def test_ef_identity_property(xs, es, k):
    """c + e' = x + e for any input (eq. 21), and top-k's c and e' are the
    reference's bit for bit."""
    n = min(len(xs), len(es))
    x, e = np.asarray(xs[:n], np.float32), np.asarray(es[:n], np.float32)
    k = min(k, n)
    c, e2, mask = tef.ef_compress(lambda v: ts.topk_sparsify(v, k),
                                  torch.from_numpy(x), torch.from_numpy(e))
    np.testing.assert_allclose((c + e2).numpy(), x + e, rtol=1e-4, atol=1e-4)
    jc, je2, jm = jef.ef_compress(lambda v: js.topk_sparsify(v, k),
                                  jnp.asarray(x), jnp.asarray(e))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(e2.numpy(), np.asarray(je2))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
