"""Select-then-replay, the invariant the CUDA top-k kernels rely on, on the
CPU.

Each step of the reference's bisection asks whether ``count(|x| >= mid) > k``;
with ``K = floor(k) + 1`` and ``t`` the row's K-th largest ``|x|`` it holds
exactly when ``t >= mid``. ``topk_mask.select_replay`` computes ``t`` with
``torch.sort`` and replays the 24 halvings; these tests hold it bit for bit
equal to the kernels' plain version (``_bisect``, through ``topk_rows_plain``
and ``block_topk_tiles_plain``) and to the JAX kernel ``topk_rows_pallas`` in
interpret mode, on rows full of ties, constants, zeros, NaN, infinities and
denormals, for budgets below 0, fractional, and at and past the row's width.

The JAX kernel takes whole (8, 128) tiles, so a row narrower than 128 goes to
it zero-padded, as the reference's ``ops.topk_rows`` pads it: the padding
counts only where ``mid`` is 0, which leaves ``lo`` at 0 either way. The tile
form's int budget is passed to the float-budget kernel as a float; the two
count comparisons are the same below 2^24.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies

from repro.kernels.topk_mask import topk_rows_pallas  # noqa: E402
from repro_torch.kernels import topk_mask  # noqa: E402

SPECIAL = np.array([0.0, -0.0, 0.5, 1.0, -1.0, 2.5, 1e-40, 1.2e-38, np.nan,
                    np.inf, -np.inf], np.float32)
WIDTHS = st.one_of(st.integers(1, 33), st.just(1024))
# (w, off): the budget w * d + off, so 0, 0.5, 1, 3.7, -1, d - 1, d, d + 5
BUDGETS = st.sampled_from([(0, 0.0), (0, 0.5), (0, 1.0), (0, 3.7), (0, -1.0),
                           (1, -1.0), (1, 0.0), (1, 5.0)])
SETTINGS = hypothesis.settings(max_examples=150, deadline=None,
                               derandomize=True)


def _budget(budget, d: int) -> float:
    w, off = budget
    return w * d + off


def _rows(seed: int, rows: int, d: int, special: float, scale: float
          ) -> np.ndarray:
    """Normal draws times ``scale``, a share ``special`` of them replaced by
    ties, zeros, NaN, infinities or denormals, and some rows constant."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * scale).astype(np.float32)
    pick = rng.random((rows, d)) < special
    x[pick] = rng.choice(SPECIAL, size=int(pick.sum()))
    const = rng.random(rows) < 0.2
    x[const] = rng.choice(SPECIAL[:6], size=(int(const.sum()), 1))
    return x


@functools.lru_cache(maxsize=None)
def _jax_kernel():
    return jax.jit(lambda x, k: topk_rows_pallas(x, k, interpret=True))


def _jax_topk(x: np.ndarray, k: float, dtype) -> np.ndarray:
    """The JAX kernel on x zero-padded to whole (16, 128k) tiles, in the
    given type, cut back to x's shape and returned as float32."""
    rows, d = x.shape
    xp = np.zeros((16, 128 if d <= 128 else 1024), np.float32)
    xp[:rows, :d] = x
    out = _jax_kernel()(jnp.asarray(xp).astype(dtype), np.float32(k))
    return np.asarray(out.astype(jnp.float32))[:rows, :d]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy().view(np.uint32)


@SETTINGS
@hypothesis.given(seed=st.integers(0, 2 ** 32 - 1), rows=st.integers(1, 9),
                  d=WIDTHS, special=st.sampled_from([0.0, 0.1, 0.5, 1.0]),
                  scale=st.sampled_from([1.0, 2e-38, 1e-40]), budget=BUDGETS)
def test_select_replay_equals_bisection_and_jax_rows(seed, rows, d, special,
                                                     scale, budget):
    x = _rows(seed, rows, d, special, scale)
    k = _budget(budget, d)
    xt = torch.from_numpy(x)
    got = topk_mask.select_replay(xt, k)
    np.testing.assert_array_equal(
        _bits(got), _bits(topk_mask.topk_rows_plain(xt, torch.tensor(k))))
    np.testing.assert_array_equal(
        _bits(got), _jax_topk(x, k, jnp.float32).view(np.uint32))


@SETTINGS
@hypothesis.given(seed=st.integers(0, 2 ** 32 - 1), rows=st.integers(1, 9),
                  cols=WIDTHS, tail=st.integers(0, 40),
                  special=st.sampled_from([0.0, 0.1, 0.5]),
                  budget=BUDGETS, bf16=st.booleans())
def test_select_replay_equals_bisection_and_jax_tiles(seed, rows, cols, tail,
                                                      special, budget, bf16):
    """The tile form: a flat tensor of float32 or bf16 walked as rows of
    ``cols``, its last row ragged (its missing tail counted as zeros), with
    an int budget."""
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32,
                                                            jnp.float32)
    x = _rows(seed, rows, cols, special, 1.0)
    n = max(1, rows * cols - min(tail, cols - 1))
    x.reshape(-1)[n:] = 0.0  # the reference's zero padding
    xt = torch.from_numpy(x).to(tdt)
    k = int(_budget(budget, cols))
    flat = topk_mask.block_topk_tiles_plain(xt.reshape(-1)[:n], k, cols)
    assert flat.dtype == tdt
    got = topk_mask.select_replay(xt, k)
    np.testing.assert_array_equal(_bits(got).reshape(-1)[:n], _bits(flat))
    want = _jax_topk(xt.to(torch.float32).numpy(), float(k), jdt)
    np.testing.assert_array_equal(_bits(got), want.view(np.uint32))
