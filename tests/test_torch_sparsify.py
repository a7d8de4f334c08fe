"""Parity of the port's per-tensor sparsifiers (``repro_torch.core.
compression.sparsify``) against the JAX reference, on the same numpy inputs
and keys.

Tolerances:
- top-k, rand-k and R-top-K masks and values are bitwise, NaN (ranked first,
  as ``lax.top_k`` does), infinities, signed zeros, denormals and bf16 leaves
  full of ties included; so is the synchronous mask cycle.
- random sparsification sums over the whole tensor inside its 40-step
  bisection (XLA's order is not PyTorch's), so its ``lam`` may differ by a
  few ulps: kept values hold to rtol 1e-5 (float32) or one bfloat16 ulp, and
  a keep decision may differ only where the draw lies within
  ``KEEP_MARGIN`` of its probability, counted and capped at ``MAX_FLIPS``.
  On integer-valued inputs (exact sums) it is bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core.compression import sparsify as js  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.convert import key_from_jax  # noqa: E402
from repro_torch.core.compression import sparsify as ts  # noqa: E402

DTYPES = ("float32", "bfloat16")
SHAPES = [(1000,), (37, 129), (2, 128, 32)]
RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}  # bf16: one ulp
KEEP_MARGIN, MAX_FLIPS = 2e-5, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch ops of this file on one thread: the test run spreads files over
    several processes on one host, where threefry's many int64 ops stall on
    oversubscribed intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(x: np.ndarray, dtype: str):
    """The same input on both sides, bit for bit (a bfloat16 one through
    its bits: the two casts of NaN differ)."""
    jx = jnp.asarray(x).astype(dtype)
    if dtype == "bfloat16":
        return jx, torch.from_numpy(np.asarray(jx).view(np.int16).copy()
                                    ).view(torch.bfloat16)
    return jx, torch.from_numpy(x)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _bits_equal(got: torch.Tensor, want) -> None:
    """Same dtype and the same bits (NaN payloads and -0.0 included)."""
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    w = np.asarray(want)
    np.testing.assert_array_equal(
        got.view(torch.int16 if got.element_size() == 2 else torch.int32
                 ).numpy(),
        w.view(np.int16 if w.itemsize == 2 else np.int32))


def _adversarial(dtype: str) -> np.ndarray:
    """NaN of both signs, infinities, signed zeros, denormals (float32) and
    ties, in a (3, 41) tensor."""
    rng = np.random.default_rng(9)
    x = rng.choice(np.array([-2, -1, 0, 1, 2, 0.5], np.float32), (3, 41))
    flat = x.reshape(-1)
    flat[[4, 50]] = np.nan
    flat[77] = -np.nan
    flat[[9, 100]] = [np.inf, -np.inf]
    flat[[11, 12]] = [-0.0, 0.0]
    if dtype == "float32":
        flat[[20, 21, 22]] = [1e-45, -1e-40, 3e-39]
    return x


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "bfloat16":  # a leaf full of ties: few distinct values
        x = rng.integers(-4, 5, shape).astype(np.float32) * 0.25
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    return _pair(x, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + ["adversarial"])
def test_topk_mask_and_sparsify_bitwise(shape, dtype):
    if shape == "adversarial":
        jx, tx = _pair(_adversarial(dtype), dtype)
    else:
        jx, tx = _inputs(shape, dtype, 1)
    d = tx.numel()
    for k in (1, 3, 17, d // 3, d):
        np.testing.assert_array_equal(ts.topk_mask(tx, k).numpy(),
                                      np.asarray(js.topk_mask(jx, k)))
        (got, gm), (want, wm) = ts.topk_sparsify(tx, k), js.topk_sparsify(
            jx, k)
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        _bits_equal(got, want)


def test_top_k_order_matches_lax():
    """``_top_k_indices`` is ``lax.top_k``'s index order: NaN first, then
    largest first, ties by the lower index."""
    for dtype in DTYPES:
        jx, tx = _pair(_adversarial(dtype), dtype)
        for k in (1, 5, 40, tx.numel()):
            _, want = jax.lax.top_k(jnp.abs(jx.reshape(-1)), k)
            np.testing.assert_array_equal(ts._top_k_indices(tx, k).numpy(),
                                          np.asarray(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_randk_bitwise(shape, dtype):
    jx, tx = _inputs(shape, dtype, 2)
    for seed, k, unbiased in ((0, 17, False), (1, 17, True), (2, 1, True),
                              (3, tx.numel() // 7, True)):
        key = jax.random.PRNGKey(seed)
        want, wm = js.randk_sparsify(key, jx, k, unbiased)
        got, gm = ts.randk_sparsify(key_from_jax(key), tx, k, unbiased)
        assert int(gm.sum()) == k
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        _bits_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + ["adversarial"])
def test_rtopk_bitwise(shape, dtype):
    if shape == "adversarial":
        jx, tx = _pair(_adversarial(dtype), dtype)
    else:
        jx, tx = _inputs(shape, dtype, 3)
    d = tx.numel()
    for seed, r, k in ((0, 60, 17), (1, 4, 4), (2, min(4 * (d // 100), d),
                                                 d // 100)):
        key = jax.random.PRNGKey(seed)
        want, wm = js.rtopk_sparsify(key, jx, r, k)
        got, gm = ts.rtopk_sparsify(key_from_jax(key), tx, r, k)
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        _bits_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + [(512, 128)])
def test_random_sparsify_within_margin(shape, dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(shape) * rng.exponential(1.0, shape)).astype(
        np.float32)
    x.reshape(-1)[:5] = 0.0  # zero coordinates are never kept
    jx, tx = _pair(x, dtype)
    flips = 0
    for seed, eps in ((0, 1.0), (1, 0.1)):
        key = jax.random.PRNGKey(seed)
        tk = key_from_jax(key)
        want, wm = js.random_sparsify(key, jx, eps)
        got, gm = ts.random_sparsify(tk, tx, eps)
        assert got.dtype == tx.dtype and gm.dtype == torch.bool
        wm, gm = np.asarray(wm).reshape(-1), gm.numpy().reshape(-1)
        assert not gm[:5].any()
        off = wm != gm
        if off.any():  # the draw must sit on the keep probability
            a = np.abs(_np(tx).reshape(-1))
            u = trandom.uniform(tk, shape).numpy().reshape(-1)
            kept = np.where(gm, _np(got).reshape(-1), _np(want).reshape(-1))
            p = np.abs(a / kept)  # out = g / p where kept
            assert np.all(np.abs(u[off] - p[off]) < KEEP_MARGIN)
        flips += int(off.sum())
        both = (wm & gm).reshape(shape)
        np.testing.assert_allclose(_np(got)[both], _np(want)[both],
                                   rtol=RTOL[dtype])
    assert flips <= MAX_FLIPS


@pytest.mark.parametrize("dtype", DTYPES)
def test_random_sparsify_integer_inputs_bitwise(dtype):
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng.integers(-9, 10, (37, 129)).astype(np.float32), dtype)
    key = jax.random.PRNGKey(6)
    want, wm = js.random_sparsify(key, jx)
    got, gm = ts.random_sparsify(key_from_jax(key), tx)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    _bits_equal(got, want)


def test_variance_budget_within_rtol():
    rng = np.random.default_rng(8)
    a = np.abs(rng.standard_normal(5000)).astype(np.float32)
    a[:10] = 0.0
    for lam in (0.01, 0.5, 3.0, 100.0):
        want = float(js._variance_budget(jnp.float32(lam), jnp.asarray(a)))
        got = ts._variance_budget(torch.tensor(lam, dtype=torch.float32),
                                  torch.from_numpy(a)).item()
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("d,k", [(10, 3), (64, 8), (7, 7), (100, 1)])
def test_synchronous_mask_cycle_bitwise(d, k):
    assert ts.sync_sparse_period(d, k) == js.sync_sparse_period(d, k)
    cover = np.zeros(d, bool)
    for t in range(2 * ts.sync_sparse_period(d, k) + 1):
        got = ts.synchronous_mask_cycle(d, k, t).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(js.synchronous_mask_cycle(d, k, t)))
        cover |= got
    assert cover.all()


@pytest.mark.parametrize("chunk", [1000, 4096])
def test_chunked_draws_bitwise(monkeypatch, chunk):
    """Draws made CHUNK elements at a time (a whole gemma-2b leaf is 6e8)
    are the unchunked draws: QSGD's dither and rand-k's permutation against
    the reference, across chunk boundaries."""
    monkeypatch.setattr(trandom, "CHUNK", chunk)
    key = jax.random.PRNGKey(21)
    tk = key_from_jax(key)
    p = np.random.default_rng(0).random((3, 3001)).astype(np.float32)
    want = np.asarray(jax.random.uniform(key, p.shape)) < p
    np.testing.assert_array_equal(
        trandom.uniform_below(tk, torch.from_numpy(p)).numpy(), want)
    np.testing.assert_array_equal(trandom.permutation(tk, 9001).numpy(),
                                  np.asarray(jax.random.permutation(key,
                                                                    9001)))
    jx, tx = _inputs((9001,), "float32", 5)
    want, wm = js.randk_sparsify(key, jx, 90)
    got, gm = ts.randk_sparsify(tk, tx, 90)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    _bits_equal(got, want)
