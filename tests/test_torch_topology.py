"""The port's topology layer and D2D geometry against the JAX package, on
the CPU.

(a) ``core/topology.py``'s numpy builders and diagnostics, copied from the
    reference: the same adjacency, mixing matrix, spectral gap and
    consensus-round estimate bit for bit, on the reference's own graphs.
(b) The torch twins against the jnp twins: ``laplacian_mixing_jax`` and
    ``gate_mixing_jax`` bitwise; ``metropolis_hastings_mixing_jax`` with its
    off-diagonal weights bitwise and its diagonal within atol 2.4e-7, two
    ulps of 1.0 (the diagonal is 1 minus a float32 sum of a row of unequal
    weights, summed in another order than XLA's); an offline node's row
    and column exactly one-hot.
(c) ``wireless.sample_positions_xy_jax`` and ``pairwise_dist_jax`` bitwise
    against the reference's, called alone and inside a compiled program
    (the gossip engine's), at N in {9, 64, 1000} over seeds 0-4: the fog
    engine's radius cut decides its edge set from these distances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import topology as jt  # noqa: E402
from repro.core import wireless as jwl  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import topology as tt  # noqa: E402
from repro_torch.core import wireless as twl  # noqa: E402
# restores both packages' engine caches after each test (autouse)
from test_torch_hfl import _keep_engine_caches  # noqa: E402,F401


# the reference's test graphs (tests/test_topology.py) and the bench's
GRAPHS = {
    "ring8": lambda m: m.ring(8), "ring2": lambda m: m.ring(2),
    "torus3x4": lambda m: m.torus_2d(3, 4),
    "torus4x4": lambda m: m.torus_2d(4, 4),
    "torus8x8": lambda m: m.torus_2d(8, 8),
    "complete6": lambda m: m.complete(6), "star7": lambda m: m.star(7),
    "er0_10_0.3": lambda m: m.erdos_renyi(0, 10, 0.3),
    "er7_9_0.15": lambda m: m.erdos_renyi(7, 9, 0.15),
    "er3_11_0.9": lambda m: m.erdos_renyi(3, 11, 0.9),
    "er0_8_0": lambda m: m.erdos_renyi(0, 8, 0.0),
    "er0_64_0.3": lambda m: m.erdos_renyi(0, 64, 0.3),
}
MIXINGS = ("laplacian_mixing", "metropolis_hastings_mixing")


# ---------------------------------------------------------------------------
# (a) numpy builders and diagnostics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_builders_bitwise(graph):
    a = GRAPHS[graph](tt)
    np.testing.assert_array_equal(a, GRAPHS[graph](jt))
    assert a.dtype == GRAPHS[graph](jt).dtype
    assert tt.is_connected(a) == jt.is_connected(a)


@pytest.mark.parametrize("mixing", MIXINGS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_mixing_and_diagnostics_bitwise(graph, mixing):
    a = GRAPHS[graph](jt)
    w = getattr(tt, mixing)(a)
    np.testing.assert_array_equal(w, getattr(jt, mixing)(a))
    assert tt.is_doubly_stochastic(w) == jt.is_doubly_stochastic(w)
    assert tt.spectral_gap(w) == jt.spectral_gap(w)
    assert tt.consensus_rounds(w) == jt.consensus_rounds(w)
    assert tt.consensus_rounds(w, eps=1e-6) == jt.consensus_rounds(
        w, eps=1e-6)


@pytest.mark.parametrize("n", [4, 9, 16, 64, 10])
@pytest.mark.parametrize("seed", [0, 2])
def test_standard_adjacencies_bitwise(n, seed):
    ta, ja = tt.standard_adjacencies(n, seed=seed), jt.standard_adjacencies(
        n, seed=seed)
    assert list(ta) == list(ja)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k])


def test_is_connected_and_stochastic_edges():
    two = np.zeros((4, 4))
    two[0, 1] = two[1, 0] = two[2, 3] = two[3, 2] = 1
    assert tt.is_connected(two) is jt.is_connected(two) is False
    w = np.eye(3) * 1.5 - 0.25
    assert tt.is_doubly_stochastic(w) == jt.is_doubly_stochastic(w)
    neg = tt.laplacian_mixing(tt.ring(5))
    neg[0, 1] -= 1e-3
    neg[0, 0] += 1e-3
    for tol in (1e-8, 1e-2):
        assert (tt.is_doubly_stochastic(neg, tol=tol)
                == jt.is_doubly_stochastic(neg, tol=tol))


# ---------------------------------------------------------------------------
# (b) torch twins against the jnp twins
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_laplacian_twin_bitwise(graph):
    a = GRAPHS[graph](jt)
    want = np.asarray(jt.laplacian_mixing_jax(jnp.asarray(a)))
    got = tt.laplacian_mixing_jax(torch.tensor(a))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # a boolean adjacency, as the fog engine builds it
    np.testing.assert_array_equal(
        tt.laplacian_mixing_jax(torch.tensor(a > 0)).numpy(), want)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_metropolis_hastings_twin(graph):
    a = GRAPHS[graph](jt)
    want = np.asarray(jt.metropolis_hastings_mixing_jax(jnp.asarray(a)))
    got = tt.metropolis_hastings_mixing_jax(torch.tensor(a)).numpy()
    np.testing.assert_array_equal(got - np.diag(np.diag(got)),
                                  want - np.diag(np.diag(want)))
    np.testing.assert_allclose(np.diag(got), np.diag(want), rtol=0,
                               atol=2.4e-7)
    np.testing.assert_allclose(got, tt.metropolis_hastings_mixing(a),
                               rtol=0, atol=2.4e-7)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mixing", MIXINGS)
def test_gate_twin_bitwise_and_offline_one_hot(seed, mixing):
    n = 9
    w = getattr(jt, mixing)(jt.erdos_renyi(5 + seed, n, 0.4)).astype(
        np.float32)
    avail = np.random.default_rng(seed).random(n) < 0.6
    avail[0] = False
    want = np.asarray(jt.gate_mixing_jax(jnp.asarray(w), jnp.asarray(avail)))
    got = tt.gate_mixing_jax(torch.tensor(w), torch.tensor(avail)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tt.is_doubly_stochastic(got, tol=1e-6)
    for i in np.where(~avail)[0]:
        hot = np.zeros(n, np.float32)
        hot[i] = 1.0
        np.testing.assert_array_equal(got[i], hot)
        np.testing.assert_array_equal(got[:, i], hot)
    on = tt.gate_mixing_jax(torch.tensor(w), torch.ones(n, dtype=torch.bool))
    np.testing.assert_allclose(on.numpy(), w, atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the D2D deployment and pairwise distances
# ---------------------------------------------------------------------------
def _ref_geometry(seed, n, jit):
    chan = jwl.channel_params(jwl.WirelessConfig(n_devices=n))

    def geo(key, c):
        pos = jwl.sample_positions_xy_jax(key, c, n)
        return pos, jwl.pairwise_dist_jax(pos)

    fn = jax.jit(geo) if jit else geo
    return tuple(np.asarray(a) for a in fn(jax.random.PRNGKey(seed), chan))


@pytest.mark.parametrize("jit", [False, True], ids=["alone", "compiled"])
@pytest.mark.parametrize("n", [9, 64, 1000])
@pytest.mark.parametrize("seed", range(5))
def test_xy_deployment_and_distances_bitwise(seed, n, jit):
    jpos, jdist = _ref_geometry(seed, n, jit)
    chan = twl.channel_params(twl.WirelessConfig(n_devices=n))
    tpos = twl.sample_positions_xy_jax(trandom.PRNGKey(seed), chan, n)
    tdist = twl.pairwise_dist_jax(tpos)
    assert tpos.shape == (n, 2) and tdist.shape == (n, n)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    np.testing.assert_array_equal(tdist.numpy(), jdist)
    assert (tdist.numpy() >= 1.0).all()


@pytest.mark.parametrize("radius", [100.0, 300.0])
def test_distances_bitwise_from_reference_positions(radius):
    """The norm alone, on the reference's positions of a wider cell."""
    n = 64
    chan = jwl.channel_params(jwl.WirelessConfig(n_devices=n,
                                                 cell_radius_m=radius))
    pos = jwl.sample_positions_xy_jax(jax.random.PRNGKey(7), chan, n)
    want = np.asarray(jax.jit(jwl.pairwise_dist_jax)(pos))
    got = twl.pairwise_dist_jax(torch.tensor(np.asarray(pos)))
    np.testing.assert_array_equal(got.numpy(), want)
