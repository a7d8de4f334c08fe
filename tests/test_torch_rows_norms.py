"""QSGD's row kernel: the ``levels`` clamp and the in-kernel row norms, on
the CPU through the plain versions.

* ``qsgd.qsgd_rows`` given the norms equals ``qsgd_rows_pallas`` (interpret
  mode) bit for bit at every ``levels``, the ones below 1 included: the TPU
  kernel takes ``max(levels, 1)`` itself, and so does the port.
* ``ref.lane_order_norms`` sums each row's squares in the order of the
  kernel's layout for d (a group of threads a row up to 1024 columns, a
  block a row above). It equals a thread-by-thread simulation of the
  kernel's xor shuffles bit for bit, and ``jnp.linalg.norm`` to rtol 1e-6
  (another order of summation).
* ``qsgd_rows_plain(norms=None)`` against the reference's ``ops.qsgd_rows``
  in interpret mode: the norms differ by an ulp from XLA's, so an entry
  whose rounding fraction lies within an ulp of its dither can round the
  other way. Every entry agrees to rtol 1e-5, atol 1e-6 or differs by
  exactly one step ``norm / L``, in at most 1 entry of 2000.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.qsgd import qsgd_rows_pallas  # noqa: E402
from repro_torch.kernels import qsgd, ref  # noqa: E402

WIDTHS = [4, 32, 36, 128, 256, 1000, 1025]


def _rows(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    u = rng.random(shape, dtype=np.float32)
    return x, u


@pytest.mark.parametrize("shape", [(8, 128), (16, 256)])
@pytest.mark.parametrize("levels", [0.0, 0.5, 1.0, 3.0, 256.0])
def test_qsgd_rows_clamps_levels_as_pallas_bitwise(shape, levels):
    x, u = _rows(shape, 0)
    norms = np.linalg.norm(x, axis=1, keepdims=True).astype(np.float32)
    want = np.asarray(qsgd_rows_pallas(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(norms),
        jnp.float32(levels), interpret=True))
    got = qsgd.qsgd_rows(torch.from_numpy(x), torch.from_numpy(u),
                         torch.from_numpy(norms), torch.tensor(levels))
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def _butterfly(v: np.ndarray, width: int) -> np.ndarray:
    """xor shuffles over the last axis, offsets width/2 down to 1, as each
    lane of a warp computes them: v[i] + v[i ^ o]."""
    lane = np.arange(v.shape[-1])
    o = width // 2
    while o:
        v = (v + v[..., lane ^ o]).astype(np.float32)
        o //= 2
    return v


def _simulated_norms(x: np.ndarray) -> np.ndarray:
    """Each row's norm as csrc/rows.cu sums it, thread by thread in float32:
    a row group of pow2ceil(d / V) threads, V neighbouring columns each (V
    two up to d = 64, four above where d % 4 == 0, fewer for odd d), up to
    1024 threads; a 512-thread block a row above."""
    rows, d = x.shape
    sq = (x * x).astype(np.float32)
    v = 4 if d % 4 == 0 and d > 64 else 2 if d % 2 == 0 else 1
    g = 1 << max(0, -(-d // v) - 1).bit_length()
    if g <= 1024:
        s = np.zeros((rows, g), np.float32)
        for j in range(v):  # thread q adds columns vq, vq + 1, ... in order
            s[:, :d // v] = s[:, :d // v] + sq[:, j::v]
        if g <= 32:
            return np.sqrt(_butterfly(s, g)[:, 0])[:, None]
        warps = _butterfly(s.reshape(rows, g // 32, 32), 32)[..., 0]
        nw = g // 32
    else:
        s = np.zeros((rows, 512), np.float32)
        for c in range(d):  # thread c % 512 adds column c, in order
            s[:, c % 512] = s[:, c % 512] + sq[:, c]
        warps = _butterfly(s.reshape(rows, 16, 32), 32)[..., 0]
        warps = np.pad(warps, ((0, 0), (0, 16)))  # lanes 16-31 hold zeros
        nw = 32
    # lane l of every warp takes warp sum l % nw; the warp sums meet by
    # shuffles at offsets nw / 2 down to 1
    lanes = warps[:, np.arange(32) % nw]
    return np.sqrt(_butterfly(lanes, nw)[:, 0])[:, None]


@pytest.mark.parametrize("d", WIDTHS + [1, 7, 66, 1026, 3000, 4100])
def test_lane_order_norms_simulate_the_kernel_bitwise(d):
    x, _ = _rows((6, d), d)
    x[1] *= 1e-20  # squares near the bottom of float32
    x[2] *= 1e17   # squares near the top
    got = ref.lane_order_norms(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _simulated_norms(x).view(np.uint32))


@pytest.mark.parametrize("d", WIDTHS)
def test_lane_order_norms_match_jnp_norm(d):
    x, _ = _rows((12, d), 100 + d)
    want = np.asarray(jnp.linalg.norm(jnp.asarray(x), axis=1, keepdims=True))
    got = ref.lane_order_norms(torch.from_numpy(x)).numpy()
    assert got.shape == (12, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("shape", [(16, 32), (9, 36), (8, 200), (4, 1025)])
@pytest.mark.parametrize("levels", [0.5, 4.0, 256.0])
def test_qsgd_rows_plain_self_norms_match_reference(shape, levels):
    x, u = _rows(shape, 7)
    want = np.asarray(jops.qsgd_rows(jnp.asarray(x), jnp.asarray(u), levels,
                                     mode="interpret"))
    got = qsgd.qsgd_rows_plain(torch.from_numpy(x), torch.from_numpy(u),
                               None, torch.tensor(levels)).numpy()
    # the CPU wrapper given no norms takes the same plain version
    np.testing.assert_array_equal(
        qsgd.qsgd_rows(torch.from_numpy(x), torch.from_numpy(u), None,
                       torch.tensor(levels)).numpy(), got)
    norms = np.linalg.norm(x.astype(np.float64), axis=1, keepdims=True)
    step = np.broadcast_to(norms / max(levels, 1.0), x.shape)
    flips = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.abs(got - want)[flips], step[flips],
                               rtol=1e-5)
    assert flips.sum() <= max(1, x.size // 2000)
