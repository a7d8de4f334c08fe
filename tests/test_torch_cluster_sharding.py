"""The port's sharding rules (``repro_torch.launch.sharding``) and
``launch/steps.py::state_shardings`` against the JAX package's, on the CPU,
for all ten configs at their full published sizes.

The reference runs on ``jax.sharding.AbstractMesh`` meshes, (16, 16) over
("data", "model"), (2, 16, 16) over ("pod", "data", "model") and (2, 4),
over ``jax.eval_shape`` of its init, so no device and no allocation is
needed; the port runs on descriptions of the same meshes
(``launch.mesh.Mesh(..., bind=False)``) over the same leaf shapes, keyed
by its ``/``-joined paths. A reference spec is compared as a tuple padded
with ``None`` to the leaf's rank. Every spec equal, leaf for leaf:
``param_spec`` through ``param_shardings`` (with and without fsdp),
``stacked_client_shardings``, ``batch_shardings`` of the train and decode
batches, ``cache_shardings`` of the ``decode_32k`` and ``long_500k`` caches,
and ``state_shardings`` for the seven policies of the reference's dry run
(``repro.launch.dryrun.policy_from_name``).
"""
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import sharding as jshard  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding as tshard  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.transformer import flatten_params  # noqa: E402
from repro_torch.optim.optimizers import OptState  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
POLICIES = ("baseline", "bf16", "int8_ef", "sign_ef", "localsgd_h4",
            "localsgd_int8", "fsdp")


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), Mesh(shape, axes, bind=False)


def _spec(sharding, ndim):
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


def _flat(tree):
    """A reference subtree of ShapeDtypeStructs / shardings, keyed as the
    port keys its params."""
    return flatten_params(tree)


def _params_sds(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda k: jtf.init_params(cfg, k),
                          jax.random.PRNGKey(0))


def _assert_specs(got, want_sh, shapes, what):
    assert sorted(got) == sorted(want_sh), what
    for k in shapes:
        assert got[k] == _spec(want_sh[k], len(shapes[k].shape)), (what, k)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_client_shardings_match_reference(arch, mesh):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmesh, tmesh = _meshes(mesh)
    sds = _params_sds(arch)
    shapes = _flat(sds)
    for fsdp in (False, True):
        want = _flat(jshard.param_shardings(jcfg, sds, jmesh, fsdp=fsdp))
        got = tshard.param_shardings(cfg, shapes, tmesh, fsdp=fsdp)
        _assert_specs(got, want, shapes, f"fsdp={fsdp}")
    n_dp = tmesh.n(("pod", "data") if "pod" in tmesh.shape else "data")
    stacked = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((n_dp,) + x.shape, x.dtype), sds)
    want = _flat(jshard.stacked_client_shardings(jcfg, stacked, jmesh))
    sshapes = _flat(stacked)
    got = tshard.stacked_client_shardings(cfg, sshapes, tmesh)
    _assert_specs(got, want, sshapes, "stacked")
    assert tshard.replicated() == () and tshard.replicated(2) == (None,
                                                                  None)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_match_reference(arch, mesh):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmesh, tmesh = _meshes(mesh)
    for shape in SHAPES.values():
        batch = jspecs.batch_specs(jcfg, shape)
        want = jshard.batch_shardings(batch, jmesh)
        got = tshard.batch_shardings(batch, tmesh)
        _assert_specs(got, want, batch, shape.name)
        if shape.kind != "decode":
            continue
        cache = jspecs.decode_specs(jcfg, shape)["cache"]
        want = jax.tree.leaves(jshard.cache_shardings(
            jcfg, cache, jmesh, shape.global_batch))
        got = tshard.cache_shardings(cfg, cache, tmesh, shape.global_batch)
        leaves = jax.tree.leaves(cache)
        got_leaves = _along(cache, got)
        assert len(got_leaves) == len(want) == len(leaves)
        for g, w, x in zip(got_leaves, want, leaves):
            assert g == _spec(w, len(x.shape)), (shape.name, x.shape)


def _along(tree, specs):
    """The specs of ``tree``'s leaves, in ``jax.tree.leaves`` order."""
    if hasattr(tree, "shape"):
        return [specs]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _along(tree[k], specs[k])]
    return [x for t, s in zip(tree, specs) for x in _along(t, s)]


def _port_state(sds):
    """The reference's state of ShapeDtypeStructs, in the port's layout."""
    opt = sds["opt"]
    out = {"params": _flat(sds["params"]),
           "opt": OptState(opt.step, *(None if t is None else _flat(t)
                                       for t in (opt.m, opt.v))),
           "step": sds["step"]}
    if "ef" in sds:
        out["ef"] = _flat(sds["ef"])
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_shardings_match_reference(arch, mesh, policy):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmesh, tmesh = _meshes(mesh)
    jp = jdryrun.policy_from_name(policy)
    sds = jax.eval_shape(jsteps.make_init_fn(jcfg, jp, jmesh),
                         jax.random.PRNGKey(0))
    want = jsteps.state_shardings(jcfg, jp, jmesh, sds)
    state = _port_state(sds)
    got = tsteps.state_shardings(cfg, convert.train_policy_from_jax(jp),
                                 tmesh, state)
    assert sorted(got) == sorted(want)
    _assert_specs(got["params"], _flat(want["params"]), state["params"],
                  "params")
    for name in ("m", "v"):
        t = getattr(state["opt"], name)
        w = getattr(want["opt"], name)
        assert (t is None) == (w is None) == (getattr(got["opt"], name)
                                              is None)
        if t is not None:
            _assert_specs(getattr(got["opt"], name), _flat(w), t, name)
    assert got["opt"].step == _spec(want["opt"].step, 0) == ()
    assert got["step"] == _spec(want["step"], 0) == ()
    if "ef" in want:
        _assert_specs(got["ef"], _flat(want["ef"]), state["ef"], "ef")
