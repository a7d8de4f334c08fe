"""The port's compressed collectives on an axis of one member
(``repro_torch.core.collectives``) against the JAX package, on the CPU.

The reference runs under ``shard_map`` over the ``data`` axis of a (1, 1)
mesh whose axes are Auto: ``make_local_mesh`` builds its mesh with
``jax.make_mesh``, whose axes are Explicit under JAX 0.9, and there the
reference's ``jnp.repeat`` (``collectives.py:116, 142``) asks for an
``out_sharding``.

For each method (none, bf16, int8, sign) x error state given / absent x
leaves below ``min_size`` (the plain path, whose error is zeros, not None)
and above it, 1-D and ragged 2-D and 3-D, with exact zeros in them:
- none, bf16 and int8: output and error bitwise. The int8 error is the
  reference's fused multiply-subtract ``corrected - q * scale``. Its codes
  could sit one step off the reference's where a value lies on a ``.5``
  boundary of its scale; the test counts them, allows none, and saw none.
- sign: the signs bitwise (the wire packs ``x >= 0``, so an exact zero goes
  out as +scale while the local error keeps it, ``torch.sign(0) = 0``); the
  scales ``mean|x|`` within rtol 1e-4, because XLA sums the float32 mean in
  another order than PyTorch (it differed by up to 1.2e-5 here); the error
  within atol 1e-6 for the same reason.
Then ``pack_bits`` / ``unpack_bits``, ``_pad_dim0``, the tree and
hierarchical forms over ``("data",)``, and meshes of more than one member
raising outside a process group (``tests/test_torch_cluster_collectives.py``
runs them inside one).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from jax.sharding import AxisType, Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import collectives as jc  # noqa: E402
from repro.core.compat import shard_map  # noqa: E402
from repro_torch.core import collectives as tc  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_mesh  # noqa: E402

SCALE_RTOL, SIGN_ERR_ATOL = 1e-4, 1e-6
SHAPES = [(40, 17), (70_000,), (301, 233), (18, 64, 128)]


def auto_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto, AxisType.Auto))


def _ref_leaf(g, method, e, min_size=65_536):
    def body(g, *e):
        return jc.compressed_allreduce_leaf(g, "data", method,
                                            e[0] if e else None, min_size)
    args = (g,) if e is None else (g, e)
    out_specs = (P(), P()) if e is not None else (P(), None)
    f = shard_map(body, mesh=auto_mesh(), in_specs=(P(),) * len(args),
                  out_specs=out_specs, axis_names={"data"}, check_vma=False)
    o, en = jax.jit(f)(*args)
    return np.asarray(o), (None if en is None else np.asarray(en))


def _leaf(shape, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    e = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    g.reshape(-1)[::7] = 0.0    # exact zeros, in g and in g + e
    e.reshape(-1)[::7] = 0.0
    return g, e


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", ["none", "bf16", "int8", "sign"])
@pytest.mark.parametrize("with_e", [True, False])
def test_compressed_allreduce_leaf_matches_reference(shape, method, with_e):
    g, e = _leaf(shape, seed=len(shape) + shape[0])
    e = e if with_e else None
    want, want_e = _ref_leaf(g, method, e)
    got, got_e = tc.compressed_allreduce_leaf(
        torch.as_tensor(g), "data", method,
        None if e is None else torch.as_tensor(e))
    got = got.numpy()
    assert got.shape == g.shape and got.dtype == np.float32
    assert (got_e is None) == (want_e is None)
    plain = g.size < 65_536
    if method != "sign" or plain:
        if method == "int8" and not plain:
            # codes one int8 step off the reference's (a .5 boundary)
            step = np.abs(want).max() / 127.0
            off = np.abs(got - want) > step / 2
            assert off.sum() == 0, f"{off.sum()} codes off by one step"
        np.testing.assert_array_equal(got, want)
        if got_e is not None:
            np.testing.assert_array_equal(got_e.numpy(), want_e)
            if plain:
                assert not got_e.any()
        return
    corrected = g + e if e is not None else g
    np.testing.assert_array_equal(np.sign(got), np.where(corrected >= 0,
                                                         1.0, -1.0))
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=SCALE_RTOL)
    assert np.unique(np.abs(got)).size == 1
    if got_e is not None:
        zeros = corrected == 0
        assert zeros.any()
        got_e = got_e.numpy()
        # the local copy keeps an exact zero; the wire sends it as +scale
        np.testing.assert_array_equal(got_e[zeros], 0.0)
        assert (got[zeros] > 0).all()
        np.testing.assert_allclose(got_e, want_e, rtol=0,
                                   atol=SIGN_ERR_ATOL)


@pytest.mark.parametrize("d0", [8, 16, 40])
def test_pack_unpack_bits_match_reference(d0):
    bits = np.random.default_rng(d0).random((d0, 3, 5)) < 0.5
    packed = tc.pack_bits(torch.as_tensor(bits))
    want = np.asarray(jc.pack_bits(jnp.asarray(bits)))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(tc.unpack_bits(packed).numpy(), bits)
    np.testing.assert_array_equal(
        np.asarray(jc.unpack_bits(jnp.asarray(want))), bits)


@pytest.mark.parametrize("d0,multiple", [(13, 8), (16, 8), (5, 1), (3, 16)])
def test_pad_dim0_matches_reference(d0, multiple):
    x = np.arange(d0 * 4, dtype=np.float32).reshape(d0, 4) + 1
    got, n0 = tc._pad_dim0(torch.as_tensor(x), multiple)
    want, m0 = jc._pad_dim0(jnp.asarray(x), multiple)
    assert n0 == m0 == d0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["none", "int8", "sign"])
def test_tree_and_hierarchical_allreduce_match_reference(method):
    shapes = {"a": (300, 240), "b": (50,), "c": (2, 40000)}
    rng = np.random.default_rng(5)
    g = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    e = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}

    def body(g, e):
        return jc.hierarchical_allreduce(g, ("data",), method, e)
    want, want_e = jax.jit(shard_map(
        body, mesh=auto_mesh(), in_specs=(P(), P()), out_specs=(P(), P()),
        axis_names={"data"}, check_vma=False))(g, e)
    tg = {k: torch.as_tensor(v) for k, v in g.items()}
    te = {k: torch.as_tensor(v) for k, v in e.items()}
    got, got_e = tc.hierarchical_allreduce(tg, ("data",), method, te)
    tree, tree_e = tc.tree_compressed_allreduce(tg, "data", method, te)
    assert sorted(got) == sorted(got_e) == sorted(shapes)
    for k in shapes:
        assert torch.equal(got[k], tree[k]) and torch.equal(got_e[k],
                                                            tree_e[k])
        tol = dict(rtol=SCALE_RTOL, atol=SIGN_ERR_ATOL) \
            if method == "sign" else dict(rtol=0, atol=0)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **tol)
        np.testing.assert_allclose(got_e[k].numpy(), np.asarray(want_e[k]),
                                   **tol)
    out, none_e = tc.tree_compressed_allreduce(tg, "data", method)
    assert none_e is None and sorted(out) == sorted(shapes)


def test_more_than_one_member_raises():
    """An axis of more than one member runs only inside a process group of
    as many members (``tests/test_torch_cluster_collectives.py``): outside
    one its mesh raises, so no call reduces over fewer members than asked
    for; a mesh without the axis raises too."""
    g = torch.ones(100_000)
    with pytest.raises(RuntimeError, match="process group of 2 members"):
        make_mesh((2,), ("data",))
    with pytest.raises(RuntimeError, match="process group of 4 members"):
        make_local_mesh(2, 2)
    one = make_local_mesh()
    for method in ("none", "int8", "sign"):
        got, _ = tc.compressed_allreduce_leaf(g, "data", method, mesh=one)
        want, _ = tc.compressed_allreduce_leaf(g, "data", method)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="no axis 'pod'"):
        tc.hierarchical_allreduce({"w": g}, ("pod", "data"), "int8",
                                  mesh=one)
    with pytest.raises(ValueError, match="unknown method"):
        tc.compressed_allreduce_leaf(g, "data", "topk")
