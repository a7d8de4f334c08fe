"""The port's collectives, meshes and ring gossip on several members (one
process each, ``gloo``, from ``repro_torch.launch.members.spawn``) against
the JAX package on a mesh of Auto axes over forced CPU devices
(``torch_cluster_jax.run_reference``), on the CPU.

(a) ``hierarchical_allreduce`` of one leaf a member, on (pod 2, data 2)
    (data with EF, then pod) and (data 4), for none, bf16, int8 and sign,
    with and without EF, over ``torch_cluster_workers.COLL_SHAPES`` (a
    leaf under ``min_size`` among them): every member's output bitwise the
    others'; none, bf16 and int8 (output and error) bitwise the
    reference's (its CPU ``psum`` adds the members one by one in rank
    order, and a bf16 one in float32 with one rounding; its fused int8
    mean multiply-adds each member's codes; its ``/ 127`` is a multiply by
    the float32 reciprocal: the port does the same); sign's signs
    bitwise, its error within ``SIGN_ERR_ATOL`` and its scales within
    ``SCALE_RTOL``, the tolerances of ``tests/test_torch_collectives.py``
    (XLA sums the float32 means in another order). On (pod 2, data 2)
    the second stage takes the mean of a leaf of two magnitudes, where the
    reference's float32 order drifts: its scales sit 1.6e-4 from a float64
    replay of its own algorithm (``_sign_exact``) on the (18, 64, 128)
    leaf, the port's 8e-8 (1.25e-4 and 1.5e-7 without EF). There the
    scales are held to the replay within ``SCALE_RTOL`` and to the
    reference within ``POD_SIGN_REF_RTOL``, 2e-4, the largest measured
    reference-to-replay gap with room for its last digits; both distances
    are printed.
    The bytes a member sends for int8 on (data 4).
(b) ``ring_gossip_shard_map`` on 4 members, float32 and bf16: bitwise.
(c) The mesh: rank r at the row-major coordinates of r, one group per
    set of axes in rank order, a mesh whose size differs from the group's
    raising inside one and a mesh of more than one member raising outside
    one; ``make_production_mesh`` as a description.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch import members  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     make_production_mesh)
from test_torch_collectives import SCALE_RTOL, SIGN_ERR_ATOL  # noqa: E402
from torch_cluster_jax import run_reference  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402

# scaled sign on (pod 2, data 2), the port against the reference: the
# reference's own float32 drift from the float64 replay, 1.6e-4 at most
POD_SIGN_REF_RTOL = 2e-4

CASES = [(m, meth, e, i) for m in workers.COLL_MESHES
         for meth in workers.COLL_METHODS for e in (1, 0)
         for i in range(len(workers.COLL_SHAPES))]


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    d = tmp_path_factory.mktemp("coll")
    ref = run_reference("collectives", 4, str(d / "ref.npz"))
    port = members.spawn(workers.collectives, 4, rendezvous_dir=str(d))
    return ref, port


def _sign_stage(xs):
    """One scaled-sign all-reduce over members ``xs`` (float64 means):
    what every member of the group receives."""
    n = len(xs)
    last = xs[0].shape[-1] if xs[0].ndim > 1 else 1
    rows = [x.reshape(-1, last) for x in xs]
    d0 = rows[0].shape[0]
    pad = (-d0) % (8 * n)
    scales = [np.abs(x).astype(np.float64).mean() for x in xs]
    signs = [np.where(np.pad(r, ((0, pad), (0, 0))) >= 0, 1.0, -1.0)
             for r in rows]
    c = (d0 + pad) // n
    out = []
    for j in range(n):
        mc = sum(sg[j * c:(j + 1) * c] * sc
                 for sg, sc in zip(signs, scales)) / n
        out.append(np.where(mc >= 0, 1.0, -1.0) * np.abs(mc).mean())
    return np.concatenate(out)[:d0].reshape(xs[0].shape)


def _sign_exact(mesh, leaf, with_e):
    """The reference's scaled-sign ``hierarchical_allreduce`` on ``mesh``,
    its means in float64: each member's output."""
    shape = workers.COLL_SHAPES[leaf]
    corr = [g + e if with_e else g for g, e in
            (workers.member_leaf(shape, leaf, r) for r in range(4))]
    if mesh == "data4":
        return [_sign_stage(corr)] * 4
    data = [_sign_stage(corr[2 * p:2 * p + 2]) for p in range(2)]
    pod = _sign_stage(data)   # every pod group receives the same
    return [pod] * 4


@pytest.mark.parametrize("mesh,method,with_e,leaf", CASES)
def test_hierarchical_allreduce_matches_reference(coll, mesh, method,
                                                  with_e, leaf):
    ref, port = coll
    key = f"{mesh}/{method}/{with_e}/{leaf}"
    outs = [p[key + "/out"] for p in port]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])   # every member alike
    for r, got in enumerate(outs):
        want = ref[key + "/out"][r]
        assert got.shape == want.shape and got.dtype == np.float32
        plain = got.size < 65_536
        if method != "sign" or plain:
            np.testing.assert_array_equal(got, want)
        elif mesh == "data4":
            np.testing.assert_array_equal(np.sign(got), np.sign(want))
            np.testing.assert_allclose(got, want, rtol=SCALE_RTOL)
        else:
            np.testing.assert_array_equal(np.sign(got), np.sign(want))
            exact = _sign_exact(mesh, leaf, with_e)[r]
            print(f"{key}: reference vs float64 replay, max rel "
                  f"{np.abs(want / exact - 1).max():.3g}; port "
                  f"{np.abs(got / exact - 1).max():.3g}; port vs "
                  f"reference {np.abs(got / want - 1).max():.3g}")
            np.testing.assert_allclose(got, exact, rtol=SCALE_RTOL)
            np.testing.assert_allclose(got, want, rtol=POD_SIGN_REF_RTOL)
        if with_e:
            ge, we = port[r][key + "/err"], ref[key + "/err"][r]
            if method == "sign" and not plain:
                np.testing.assert_allclose(ge, we, rtol=0,
                                           atol=SIGN_ERR_ATOL)
            else:
                np.testing.assert_array_equal(ge, we)
        else:
            assert key + "/err" not in port[r]


def test_int8_wire_bytes(coll):
    """int8 on (data 4), a (70000,) leaf: each member sends 3 of its 4
    int8 chunks, its scale to 3 members, its requantized chunk to 3 and
    its second scale to 3. The plain float32 mean of a (40, 17) leaf is
    all-reduce-sized: 3 of its 4 float32 chunks out, its summed chunk to
    3 members."""
    _, port = coll
    c = 70_000 // 4
    want = 3 * c + 3 * 4 + 3 * c + 3 * 4
    for p in port:
        assert int(p["data4/int8/1/1/wire"]) == want
        assert int(p["data4/none/0/0/wire"]) == 2 * 3 * (40 * 17 // 4) * 4


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    ref = run_reference("ring", 4, str(d / "ref.npz"))
    port = members.spawn(workers.ring, 4, rendezvous_dir=str(d))
    return ref, port


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weight", range(len(workers.RING_WEIGHTS)))
def test_ring_gossip_matches_reference_bitwise(ring, weight, dtype):
    ref, port = ring
    key = f"{weight}/{dtype}"
    for r, p in enumerate(port):
        np.testing.assert_array_equal(p[key], ref[key][r:r + 1])


def test_mesh_layout_groups_and_errors(tmp_path):
    got = members.spawn(workers.mesh_rules, 4,
                        rendezvous_dir=str(tmp_path))
    for r, g in enumerate(got):
        assert tuple(g["coords"]) == divmod(r, 2)
        assert list(g["pod_ranks"]) == [r % 2, r % 2 + 2]
        assert list(g["data_ranks"]) == [r - r % 2, r - r % 2 + 1]
        assert list(g["both_ranks"]) == [0, 1, 2, 3]
        assert (bool(g["raised_1"]) and bool(g["raised_2"])
                and bool(g["raised_8"]))
        assert int(g["world"]) == 4
    with pytest.raises(RuntimeError, match="process group of 2 members"):
        make_local_mesh(2, 1)
    assert make_local_mesh().size == 1
    prod = make_production_mesh(multi_pod=True)
    assert prod.axis_names == ("pod", "data", "model")
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert not prod.bound and prod.size == 512
    with pytest.raises(RuntimeError, match="description"):
        prod.group("data")
    assert make_production_mesh().shape == {"data": 16, "model": 16}
