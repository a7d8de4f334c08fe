"""The port's threefry generator against ``jax.random``: key derivation,
bits, uniforms, permutations, integers and Bernoulli draws bitwise; normals
and exponentials within a stated ulp bound (their ``log1p`` is PyTorch's,
not XLA's). Also the on-device token generator, bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro_torch import random as trandom  # noqa: E402
from repro_torch.convert import key_from_jax  # noqa: E402

SHAPES = [(1,), (7,), (3, 5), (2, 3, 4), (1000,)]
ULP_BOUND = 4  # normal: XLA's erfinv polynomial ported, log1p may differ


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a - b) / np.spacing(np.abs(a).astype(np.float32))


def _keys():
    """A chain of split/fold_in keys on both sides."""
    jk, tk = jax.random.PRNGKey(11), trandom.PRNGKey(11)
    out = [(jk, tk)]
    for i in range(3):
        jk, _ = jax.random.split(jk)
        tk, _ = trandom.split(tk)
        jk = jax.random.fold_in(jk, 1000 + i)
        tk = trandom.fold_in(tk, 1000 + i)
        out.append((jk, tk))
    return out


@pytest.mark.parametrize("seed", [0, 7, 42, 2 ** 31 - 1, -1])
def test_prngkey_matches(seed):
    np.testing.assert_array_equal(trandom.PRNGKey(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


def test_split_and_fold_in_chain_bitwise():
    for jk, tk in _keys():
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(trandom.split(tk, 5).numpy(),
                                      np.asarray(jax.random.split(jk, 5)))
    jk, tk = _keys()[-1]
    ids = np.arange(0, 4096, 37, dtype=np.int32)
    want = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.asarray(ids))
    np.testing.assert_array_equal(
        trandom.fold_in(tk, torch.as_tensor(ids)).numpy(), np.asarray(want))
    np.testing.assert_array_equal(key_from_jax(jk).numpy(), tk.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bitwise(shape):
    for jk, tk in _keys():
        np.testing.assert_array_equal(
            trandom.bits(tk, shape).numpy(),
            np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
        np.testing.assert_array_equal(trandom.uniform(tk, shape).numpy(),
                                      np.asarray(jax.random.uniform(jk, shape)))


def test_batched_keys_match_vmap():
    jk, tk = _keys()[1]
    jkeys = jax.random.split(jk, 6)
    tkeys = trandom.split(tk, 6)
    want = jax.vmap(lambda k: jax.random.uniform(k, (3, 4)))(jkeys)
    np.testing.assert_array_equal(trandom.uniform(tkeys, (3, 4)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES + [(16384,)])
def test_normal_and_exponential_within_ulps(shape):
    for jk, tk in _keys():
        jn = np.asarray(jax.random.normal(jk, shape))
        assert _ulps(jn, trandom.normal(tk, shape).numpy()).max() <= ULP_BOUND
        je = np.asarray(jax.random.exponential(jk, shape))
        assert _ulps(je, trandom.exponential(tk, shape).numpy()).max() <= 2


@pytest.mark.parametrize("shape", [(3, 3001), (9001,)])
def test_normal_in_chunks_is_the_whole_draw(monkeypatch, shape):
    """A normal drawn CHUNK elements at a time (one key, a leaf past CHUNK)
    is the draw made whole, bit for bit, across chunk boundaries."""
    whole = [trandom.normal(tk, shape) for _, tk in _keys()]
    monkeypatch.setattr(trandom, "CHUNK", 1000)
    for (_, tk), want in zip(_keys(), whole):
        assert torch.equal(trandom.normal(tk, shape), want)


def test_erfinv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999])
    got = trandom.erfinv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[1]) and got[1] > 0
    np.testing.assert_allclose(got, want, rtol=4e-7)


@pytest.mark.parametrize("n", [1, 40, 4096, 100_000])
def test_permutation_bitwise(n):
    jk, tk = _keys()[2]
    np.testing.assert_array_equal(trandom.permutation(tk, n).numpy(),
                                  np.asarray(jax.random.permutation(jk, n)))


# spans: 1 (an empty or unit range), powers of two, spans past 2^16 (where
# JAX's multiplier wraps to 0), a vocabulary that is no power of two, the
# whole int32 range, and negative bounds
RANDINT_RANGES = [(0, 1), (3, 3), (5, 2), (0, 64), (0, 1 << 16),
                  (0, (1 << 16) + 1), (0, 1000), (0, 50257), (-5, 7),
                  (7, 1 << 20), (-(1 << 31), (1 << 31) - 1)]


@pytest.mark.parametrize("lo,hi", RANDINT_RANGES)
def test_randint_bitwise(lo, hi):
    for jk, tk in _keys():
        want = np.asarray(jax.random.randint(jk, (3, 5, 4), lo, hi))
        got = trandom.randint(tk, (3, 5, 4), lo, hi).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    keys = jax.random.split(jax.random.PRNGKey(1), 6)
    np.testing.assert_array_equal(
        trandom.randint(key_from_jax(keys), (2, 3), lo, hi).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (2, 3), lo,
                                                         hi))(keys)))


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 1.0])
def test_bernoulli_bitwise(p):
    for jk, tk in _keys():
        np.testing.assert_array_equal(
            trandom.bernoulli(tk, p, (4, 33)).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, (4, 33))))


@pytest.mark.parametrize("vocab,n_classes,seed", [(64, 4, None),
                                                  (1000, 3, 7),
                                                  (50257, 5, None),
                                                  (6, 4, 2)])
def test_token_datagen_bitwise(vocab, n_classes, seed):
    from repro.data.ondevice import make_token_datagen as jgen
    from repro_torch.data import make_token_datagen as tgen

    kw = dict(local_steps=2, batch=3, seq=5, n_classes=n_classes, seed=seed)
    key = jax.random.PRNGKey(11)
    want = jgen(vocab, **kw)(key, jnp.arange(10, 17))
    got = tgen(vocab, **kw)(key_from_jax(key), torch.arange(10, 17))
    assert want.keys() == got.keys()
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].numpy().dtype == w.dtype
        np.testing.assert_array_equal(got[k].numpy(), w)
