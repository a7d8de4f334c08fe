"""The three row kernels' plain PyTorch versions against the reference's row
APIs (``repro.kernels.ops``: the Pallas kernels in interpret mode, and their
compiled mirrors).

Tolerances: top-k is exact (bitwise). Scaled sign + EF sums in another order
than XLA: rtol 1e-5, atol 1e-6. QSGD: XLA's CPU division is reciprocal-based
and its norm reduction runs in another order, so an entry whose rounding
fraction lies within an ulp of its dither ``u`` can round the other way; every
entry agrees to rtol 1e-5 or differs by exactly one quantization step
``norm / L``, and such flips are rarer than 1 in 10^4. The kernels against
the plain versions on a card: ``test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import qsgd, ref, sign_ef, topk_mask  # noqa: E402

CASES = [("interpret", (12, 200)), ("jit", (4096, 32)), ("jit", (64, 1000))]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    e = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    u = rng.random(shape, dtype=np.float32)
    return x, e, u


@pytest.mark.parametrize("mode,shape", CASES)
@pytest.mark.parametrize("k", [1.0, 3.0, 17.5])
def test_topk_plain_matches_reference_bitwise(mode, shape, k):
    x, _, _ = _inputs(shape)
    want = np.asarray(jops.topk_rows(jnp.asarray(x), k, mode=mode))
    got = topk_mask.topk_rows_plain(torch.from_numpy(x), torch.tensor(k))
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU wrapper takes the plain version and launches nothing
    before = topk_mask.topk_rows.launches
    np.testing.assert_array_equal(
        tops.topk_rows(torch.from_numpy(x), torch.tensor(k)).numpy(), want)
    assert topk_mask.topk_rows.launches == before


@pytest.mark.parametrize("mode,shape", [("interpret", (18, 40)),
                                        ("interpret", (18, 128)),
                                        ("jit", (27, 1024))])
@pytest.mark.parametrize("k", [0.0, 0.5, 3.7, 39.0, 40.0, 45.0, -1.0])
def test_topk_plain_matches_reference_on_adversarial_rows(mode, shape, k):
    """Rows with NaN, +inf, -inf, only (signed) zeros, denormals, ties and
    constants: the plain version equals the reference bit for bit. A NaN
    row's maximum is NaN in both, so it keeps every non-NaN value (k >= 0)
    or none (k < 0)."""
    x = ref.topk_adversarial(*shape, seed=3)
    want = np.asarray(jops.topk_rows(jnp.asarray(x), k, mode=mode))
    got = topk_mask.topk_rows_plain(torch.from_numpy(x), torch.tensor(k))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    nan_row = np.isnan(x).any(axis=1)
    kept = (got.numpy() != 0) | (x == 0)
    n_kept = 0 if k < 0 else (~np.isnan(x[nan_row])).sum()
    assert kept[nan_row].sum() == n_kept


@pytest.mark.parametrize("mode,shape", CASES)
def test_sign_ef_plain_matches_reference(mode, shape):
    x, e, _ = _inputs(shape, 1)
    jc, je = jops.sign_ef_rows(jnp.asarray(x), jnp.asarray(e), mode=mode)
    tc, te = tops.sign_ef_rows(torch.from_numpy(x), torch.from_numpy(e))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mode,shape", CASES)
@pytest.mark.parametrize("levels", [1.0, 4.0, 256.0])
def test_qsgd_plain_matches_reference(mode, shape, levels):
    x, _, u = _inputs(shape, 2)
    want = np.asarray(jops.qsgd_rows(jnp.asarray(x), jnp.asarray(u), levels,
                                     mode=mode))
    got = tops.qsgd_rows(torch.from_numpy(x), torch.from_numpy(u),
                         torch.tensor(levels)).numpy()
    norms = np.linalg.norm(x.astype(np.float64), axis=1, keepdims=True)
    step = np.broadcast_to(norms / levels, x.shape)
    close = np.isclose(got, want, rtol=1e-5, atol=1e-6)
    flips = ~close
    np.testing.assert_allclose(np.abs(got - want)[flips], step[flips],
                               rtol=1e-5)
    assert flips.mean() < 1e-4


def test_qsgd_plain_is_the_kernel_formula():
    """Given the same norms, the plain version is the elementwise formula of
    the TPU kernel, evaluated in float32 with IEEE rounding."""
    x, _, u = _inputs((64, 96), 3)
    norms = np.linalg.norm(x, axis=1, keepdims=True).astype(np.float32)
    lv = np.float32(16.0)
    scaled = np.abs(x) / np.maximum(norms, np.float32(1e-30)) * lv
    lower = np.floor(scaled)
    q = (lower + (u < scaled - lower).astype(np.float32)) / lv
    want = np.sign(x) * q * norms
    got = qsgd.qsgd_rows_plain(torch.from_numpy(x), torch.from_numpy(u),
                               torch.from_numpy(norms), torch.tensor(16.0))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_reject_other_devices():
    x = torch.zeros(4, 8, device="meta")  # neither CPU nor CUDA
    with pytest.raises(ValueError):
        topk_mask.topk_rows(x, torch.tensor(1.0, device="meta"))
    with pytest.raises(ValueError):
        sign_ef.sign_ef_rows(x, x)
