"""The whole-tensor compression path of the port against the JAX package.

(a) The tile kernels' plain PyTorch versions against the Pallas tile kernels
    in interpret mode (``block_topk_pallas``, ``qsgd_pallas``,
    ``sign_ef_pallas``) at the reference tests' tile shapes, in float32 and
    bf16.
(b) The APIs ``block_topk``, ``qsgd_quantize`` and ``sign_ef_compress``
    against the JAX wrappers (``interpret=True``) at ragged shapes, whose last
    1024-wide row is partly padding: scaled sign's mean there still divides
    by 1024.

Tolerances: top-k is exact (bitwise). Scaled sign + EF sums in another order
than XLA: rtol 1e-5, atol 1e-6. QSGD follows the flip rule of
``test_torch_kernels.py``: XLA's CPU division is reciprocal-based and its
norm reduction runs in another order, so an entry whose rounding fraction
lies within an ulp of its dither can round the other way; every entry agrees
to within rounding of its type (rtol 1e-5 in float32, one bf16 step in bf16)
or differs by one quantization step ``norm / levels``, and such flips are
rarer than 1 in 10^3 of the entries. The CPU wrappers launch nothing. The
kernels against the plain versions on a card: ``test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.qsgd import qsgd_pallas  # noqa: E402
from repro.kernels.sign_ef import sign_ef_pallas  # noqa: E402
from repro.kernels.topk_mask import block_topk_pallas  # noqa: E402
from repro_torch.convert import key_from_jax  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import qsgd, ref, sign_ef, topk_mask  # noqa: E402

SHAPES_2D = [(8, 128), (8, 1024), (16, 256), (64, 128)]
API_SHAPES = [(100,), (3, 777), (5, 7, 11), (9000,)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values in both packages, rounded to ``dtype`` alike."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _launches():
    return (topk_mask.block_topk_tiles.launches, qsgd.qsgd_tiles.launches,
            sign_ef.sign_ef_tiles.launches)


def _assert_qsgd_flip_rule(got, want, norm, levels, dtype):
    got, want = _np(got), _np(want)
    step = np.float32(norm) / np.float32(levels)
    if dtype == "float32":
        close = np.isclose(got, want, rtol=1e-5, atol=1e-6)
        tol = 1e-5 * step
    else:  # each side rounded to bf16: half a bf16 step of its value
        close = np.isclose(got, want, rtol=2.0 ** -7, atol=1e-6)
        tol = 2.0 ** -8 * (np.abs(got) + np.abs(want))
    flips = ~close
    assert np.all((np.abs(np.abs(got - want) - step) <= tol)[flips])
    assert flips.mean() < 1e-3


# ---------------------------------------------------------------------------
# (a) plain tile versions against the Pallas tile kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 8, 32])
def test_topk_tiles_plain_matches_pallas_bitwise(shape, dtype, k):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    xj, xt = _pair(x, dtype)
    want = block_topk_pallas(xj, k, interpret=True)
    got = topk_mask.block_topk_tiles_plain(xt, k, cols=shape[1])
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), _np(want))
    # the port's oracle is the same selection rule
    np.testing.assert_array_equal(
        _np(ref.block_topk_threshold_ref(xt.to(torch.float32), k)),
        _np(jref.block_topk_threshold_ref(xj.astype(jnp.float32), k)))


@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("levels", [4, 256])
def test_qsgd_tiles_plain_matches_pallas(shape, dtype, levels):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    u = rng.random(shape, dtype=np.float32)
    xj, xt = _pair(x, dtype)
    norm = np.float32(np.linalg.norm(_np(xt).astype(np.float64)))
    want = qsgd_pallas(xj, jnp.asarray(u), jnp.full((1, 1), norm), levels,
                       interpret=True)
    got = qsgd.qsgd_tiles_plain(xt, torch.from_numpy(u),
                                torch.tensor([norm]), levels)
    assert got.dtype == xt.dtype
    _assert_qsgd_flip_rule(got, want, norm, levels, dtype)
    np.testing.assert_array_equal(
        _np(ref.qsgd_ref(xt, torch.from_numpy(u), torch.tensor(norm),
                         levels)), _np(got))


@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sign_ef_tiles_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    e = rng.standard_normal(shape).astype(np.float32)
    xj, xt = _pair(x, dtype)
    cj, ej = sign_ef_pallas(xj, jnp.asarray(e), interpret=True)
    ct, et = sign_ef.sign_ef_tiles_plain(xt, torch.from_numpy(e),
                                         cols=shape[1])
    assert ct.dtype == et.dtype == torch.float32
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5,
                               atol=1e-6)
    for got, want in zip(ref.sign_ef_ref(xt, torch.from_numpy(e)), (ct, et)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("cols", [128, 1024])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [0, 10, 40, 1024, -1])
def test_topk_tiles_plain_matches_pallas_on_adversarial_rows(cols, dtype, k):
    """Rows with NaN, +inf, -inf, only (signed) zeros, denormals, ties and
    constants, bit for bit against ``block_topk_pallas`` in interpret mode."""
    x = ref.topk_adversarial(18 if cols == 128 else 9, cols, seed=4)
    x = np.concatenate([x, x[: (-len(x)) % 8]])  # whole 8-row tiles
    xj, xt = _pair(x, dtype)
    want = block_topk_pallas(xj, k, interpret=True)
    got = topk_mask.block_topk_tiles_plain(xt, k, cols=cols)
    bits = np.uint32 if dtype == "float32" else np.uint16
    np.testing.assert_array_equal(got.view(torch.int16 if bits is np.uint16
                                           else torch.int32).numpy()
                                  .view(bits),
                                  np.asarray(want).view(bits))


def test_block_topk_api_keeps_nan_rows():
    """A ragged gradient whose rows hold NaN and infinities through the API,
    against the JAX wrapper: every non-NaN value of a NaN row is kept."""
    x = ref.topk_adversarial(9, 1024, seed=5).reshape(-1)[:9 * 1024 - 300]
    got = tops.block_topk(torch.from_numpy(x), 0.01)
    want = np.asarray(jops.block_topk(jnp.asarray(x), 0.01, interpret=True))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    nan_row = x[3 * 1024:4 * 1024]
    assert np.array_equal(got.numpy()[3 * 1024:4 * 1024] != 0,
                          ~np.isnan(nan_row) & (nan_row != 0))


def test_block_topk_ref_is_exact_topk():
    """The sort-based oracle keeps exactly the k largest magnitudes per row
    (no ties in normal draws); the bisection's threshold stays at or below
    the k-th largest, so it keeps them all, and the reference's oracle
    agrees."""
    x = np.random.default_rng(1).standard_normal((16, 256)).astype(
        np.float32)
    exact = ref.block_topk_ref(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(exact.numpy(),
                                  np.asarray(jref.block_topk_ref(x, 8)))
    assert torch.equal((exact != 0).sum(dim=1), torch.full((16,), 8))
    kept = ref.block_topk_threshold_ref(torch.from_numpy(x), 8)
    assert torch.equal(torch.where(exact != 0, kept, 0.0), exact)


# ---------------------------------------------------------------------------
# (b) the whole-tensor APIs against the JAX wrappers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", API_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_topk_matches_reference_bitwise(shape, dtype):
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    xj, xt = _pair(x, dtype)
    before = _launches()
    got = tops.block_topk(xt, 0.05)
    want = jops.block_topk(xj, 0.05, interpret=True)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), _np(want))
    assert _launches() == before


@pytest.mark.parametrize("shape", API_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("levels", [8, 256])
def test_qsgd_quantize_matches_reference(shape, dtype, levels):
    x = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    xj, xt = _pair(x, dtype)
    key = jax.random.PRNGKey(9)
    before = _launches()
    got = tops.qsgd_quantize(key_from_jax(key), xt, levels=levels)
    want = jops.qsgd_quantize(key, xj, levels=levels, interpret=True)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    norm = np.linalg.norm(_np(xt).astype(np.float64))
    _assert_qsgd_flip_rule(got, want, norm, levels, dtype)
    assert _launches() == before


@pytest.mark.parametrize("shape", API_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sign_ef_compress_matches_reference(shape, dtype):
    rng = np.random.default_rng(10)
    x = rng.standard_normal(shape).astype(np.float32)
    e = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    before = _launches()
    ct, et = tops.sign_ef_compress(xt, torch.from_numpy(e))
    cj, ej = jops.sign_ef_compress(xj, jnp.asarray(e), interpret=True)
    assert ct.shape == et.shape == xt.shape
    assert ct.dtype == et.dtype == torch.float32
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5,
                               atol=1e-6)
    # the EF invariant c + e' = x + e survives the fusion
    np.testing.assert_allclose((ct + et).numpy(), _np(xt) + e, rtol=1e-5,
                               atol=1e-6)
    assert _launches() == before


def test_sign_ef_tail_row_divides_by_1024():
    """A 100-element tensor is one ragged row: its scale is sum|x| / 1024,
    not / 100 (the row kernel's rule)."""
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal(100).astype(np.float32))
    c, _ = tops.sign_ef_compress(x, torch.zeros(100))
    scale = float(x.abs().sum()) / 1024
    np.testing.assert_allclose(c.abs().numpy(), np.full(100, scale),
                               rtol=1e-6)


def test_tile_wrappers_reject_other_devices():
    x = torch.zeros(4, 8, device="meta")  # neither CPU nor CUDA
    with pytest.raises(ValueError):
        topk_mask.block_topk_tiles(x, 1)
    with pytest.raises(ValueError):
        qsgd.qsgd_tiles(x, x, torch.zeros(1, device="meta"), 4)
    with pytest.raises(ValueError):
        sign_ef.sign_ef_tiles(x, x)
