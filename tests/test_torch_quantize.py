"""Parity of the port's per-tensor quantizers (``repro_torch.core.compression.
quantize``) against the JAX reference, on the same numpy inputs and keys.

Tolerances:
- sign and ternary are bitwise (ternary's maximum is exact and both sides
  divide IEEE), and so are the bit costs (the reference's jitted float32
  against the port's Python float, rounded to float32).
- QSGD, scaled sign, blockwise scaled sign and delta sum over a whole
  tensor, and XLA's CPU order of summation (32-wide windows, reassociated)
  is not PyTorch's. On integer-valued inputs every partial sum is exact, so
  there they are bitwise, which holds the rest of each formula (the
  reference's constant divisions are multiplies by float32 reciprocals).
- On normal inputs a float32 output holds to ``RTOL["float32"]`` (a few
  ulps of the norm or scale) and a bfloat16 one to one bfloat16 ulp. A QSGD
  dither may round the other way only where its draw lies within
  ``_margin(levels)`` of its fraction (a few float32 ulps of ``|u| / ||u|| *
  levels``); such flips are counted and capped at ``MAX_FLIPS``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core.compression import quantize as jq  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.convert import key_from_jax  # noqa: E402
from repro_torch.core.compression import quantize as tq  # noqa: E402

DTYPES = ("float32", "bfloat16")
SHAPES = [(1000,), (37, 129), (3, 7, 11), (2, 128, 32)]
RTOL = {"float32": 4e-7, "bfloat16": 2 ** -7}  # bf16: one ulp
MAX_FLIPS = 3


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
    """A JAX array or a tensor (any float dtype) as float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _same_dtype(got: torch.Tensor, want) -> None:
    assert str(got.dtype).split(".")[-1] == str(want.dtype)


def _margin(levels: int) -> float:
    return 8 * max(levels, 1) * 2.0 ** -24


def _qsgd_flips(x64, u, levels, got, want, rtol) -> int:
    """Elements outside ``rtol`` must be dither flips near their threshold;
    returns their count."""
    frac = np.mod(np.abs(x64) / np.sqrt(np.sum(x64 * x64)) * levels, 1.0)
    off = ~np.isclose(got, want, rtol=rtol, atol=0.0)
    near = np.minimum(np.abs(u - frac), 1.0 - np.abs(u - frac))
    assert np.all(near[off] < _margin(levels)), (
        f"{off.sum()} QSGD roundings differ, nearest draw "
        f"{near[off].min() if off.any() else 0} from its fraction")
    return int(off.sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_integer_inputs_bitwise(shape, dtype):
    """Exact sums: QSGD (3 levels), scaled sign, blockwise (3 blocks) and
    delta are bitwise the reference's."""
    rng = np.random.default_rng(len(shape))
    jx, tx = _pair(rng.integers(-20, 21, shape).astype(np.float32), dtype)
    key = jax.random.PRNGKey(7)
    tk = key_from_jax(key)
    cases = [
        (lambda a: jq.qsgd(key, a, 256), lambda a: tq.qsgd(tk, a, 256)),
        (lambda a: jq.qsgd(key, a, 7), lambda a: tq.qsgd(tk, a, 7)),
        (lambda a: jq.qsgd(key, a, 1), lambda a: tq.qsgd(tk, a, 1)),
        (jq.scaled_sign, tq.scaled_sign),
        (jq.blockwise_scaled_sign, tq.blockwise_scaled_sign),
        (lambda a: jq.blockwise_scaled_sign(a, 256),
         lambda a: tq.blockwise_scaled_sign(a, 256)),
        (lambda a: jq.blockwise_scaled_sign(a, 37),
         lambda a: tq.blockwise_scaled_sign(a, 37)),
    ]
    for jf, tf in cases:
        (want, wbits), (got, gbits) = jf(jx), tf(tx)
        _same_dtype(got, want)
        assert isinstance(gbits, float)
        assert np.float32(gbits) == np.float32(wbits)
        np.testing.assert_array_equal(_np(got), _np(want))
    assert (tq.delta_of_scaled_sign(tx).item()
            == float(jq.delta_of_scaled_sign(jx)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_sign_and_ternary_bitwise(shape, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:3] = 0.0  # sign(0) = 0 on both
    jx, tx = _pair(x, dtype)
    key = jax.random.PRNGKey(11)
    for (want, wbits), (got, gbits) in (
            (jq.sign_compress(jx), tq.sign_compress(tx)),
            (jq.ternary(key, jx), tq.ternary(key_from_jax(key), tx))):
        _same_dtype(got, want)
        assert np.float32(gbits) == np.float32(wbits)
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("levels", [256, 7, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_qsgd_within_dither_margin(shape, levels, dtype):
    rng = np.random.default_rng(levels)
    jx, tx = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    key = jax.random.PRNGKey(levels + 1)
    tk = key_from_jax(key)
    want, wbits = jq.qsgd(key, jx, levels)
    got, gbits = tq.qsgd(tk, tx, levels)
    _same_dtype(got, want)
    assert np.float32(gbits) == np.float32(wbits)
    u = trandom.uniform(tk, shape).numpy().astype(np.float64)
    assert _qsgd_flips(_np(tx), u, levels, _np(got), _np(want),
                       RTOL[dtype]) <= MAX_FLIPS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_scaled_signs_and_delta_within_rtol(shape, dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(shape) * rng.exponential(1.0, shape)).astype(
        np.float32)
    jx, tx = _pair(x, dtype)
    for block in (4096, 256, 37):
        want, wbits = jq.blockwise_scaled_sign(jx, block)
        got, gbits = tq.blockwise_scaled_sign(tx, block)
        _same_dtype(got, want)
        assert np.float32(gbits) == np.float32(wbits)
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL[dtype])
    want, _ = jq.scaled_sign(jx)
    got, _ = tq.scaled_sign(tx)
    _same_dtype(got, want)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL[dtype])
    np.testing.assert_allclose(tq.delta_of_scaled_sign(tx).item(),
                               float(jq.delta_of_scaled_sign(jx)), rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sign_of_zeros_nan_and_denormals(dtype):
    """XLA's sign: -0.0 stays -0.0, NaN stays NaN, denormals count as zeros
    of their sign (``torch.sign`` gives +0 for the first two). Zeros' signs
    are compared, NaN's payloads not."""
    x = np.array([-0.0, 0.0, np.nan, -np.nan, 1e-40, -1e-40, 2.0, -np.inf],
                 np.float32)
    jx, tx = _pair(x, dtype)
    for jf, tf in ((jq.sign_compress, tq.sign_compress),
                   (jq.scaled_sign, tq.scaled_sign),
                   (jq.blockwise_scaled_sign, tq.blockwise_scaled_sign)):
        want, got = np.asarray(jf(jx)[0].astype(jnp.float32)), tf(tx)[0]
        got = got.to(torch.float32).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        num = ~np.isnan(want)  # a NaN's sign bit is its payload's
        np.testing.assert_array_equal(np.signbit(got)[num],
                                      np.signbit(want)[num])
        np.testing.assert_array_equal(got, want)


def test_zero_and_tiny_tensors():
    """All-zero input (the 1e-30 guards) and a single element."""
    key = jax.random.PRNGKey(0)
    tk = key_from_jax(key)
    for x in (np.zeros(5, np.float32), np.array([-2.5], np.float32)):
        jx, tx = _pair(x, "float32")
        for jf, tf in ((lambda a: jq.qsgd(key, a), lambda a: tq.qsgd(tk, a)),
                       (lambda a: jq.ternary(key, a),
                        lambda a: tq.ternary(tk, a)),
                       (jq.scaled_sign, tq.scaled_sign),
                       (jq.blockwise_scaled_sign, tq.blockwise_scaled_sign)):
            np.testing.assert_array_equal(_np(tf(tx)[0]), _np(jf(jx)[0]))
        assert (tq.delta_of_scaled_sign(tx).item()
                == float(jq.delta_of_scaled_sign(jx)))
