"""The dry-run's inputs (``repro_torch.launch.specs``) against the JAX
package's ``repro.launch.specs.build_case``, on the CPU, for all ten
configs and four shapes at their full published sizes.

The reference runs on ``jax.sharding.AbstractMesh`` meshes, so no device
and no allocation is needed. On the production meshes (16, 16) and
(2, 16, 16) every input leaf's global shape, dtype and spec equal the
reference's, leaf for leaf (``case_specs`` on a described mesh), for the
dry-run's policy of each case (baseline; llama3-405b's train step as fsdp,
the reference's rule). A member's inputs (``member_inputs``, fake tensors)
have ``shard_shape`` of the global leaf under the spec the member holds it
by (the reference's; every decode-cache leaf's equal to it, its positions
split where the rule puts ``model`` there); the ssm and hybrid configs
build their cases there, their recurrent leaves and states split over
``model``. On
(256, 1) the
step itself runs under fake tensors on a fake process group of 256 for a
few cheap cases (the full-size traces of every case belong to the CLI),
and its outputs' shapes and dtypes equal the reference's ``jax.eval_shape``
of its step. The fake group is this module's and is destroyed at its end.
"""
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.launch.sharding import shard_shape  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.transformer import flatten_params  # noqa: E402
from repro_torch.optim.optimizers import OptState  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# (arch, shape) whose one-member step is cheap to trace at full size
OUTPUT_CASES = [("gemma-2b", "train_4k"), ("whisper-base", "prefill_32k"),
                ("whisper-base", "decode_32k"), ("whisper-base", "long_500k"),
                ("gemma-2b", "decode_32k"), ("gemma-2b", "long_500k"),
                ("falcon-mamba-7b", "long_500k"),
                ("recurrentgemma-2b", "long_500k"),
                ("qwen2-moe-a2.7b", "long_500k")]


def _policy_name(arch, shape):
    return ("fsdp" if arch == "llama3-405b" and shape.kind == "train"
            else "baseline")


def _port_layout(args, kind):
    """The reference's args (or outputs) in the port's layout: params
    flat, keyed by ``/``-joined paths; the rest as it is."""
    if kind == "train":
        state, batch = args
        opt = state["opt"]
        out = {"params": flatten_params(state["params"]),
               "opt": OptState(opt.step, *(None if t is None else
                                           flatten_params(t)
                                           for t in (opt.m, opt.v))),
               "step": state["step"]}
        if "ef" in state:
            out["ef"] = flatten_params(state["ef"])
        return (out, batch)
    return (flatten_params(args[0]),) + tuple(args[1:])


def _leaves(tree):
    """The leaves in ``jax.tree.leaves`` order: dicts by sorted key, then
    sequences in order; None has no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _sig(x):
    """(shape, dtype name) of a tensor or ShapeDtypeStruct; an int for a
    Python ``pos`` (the reference's is an int32 scalar)."""
    if isinstance(x, int):
        return ((), "int32")
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _ref_spec(sharding, ndim):
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


def _ref_case(arch, shape, jmesh):
    jcfg = jget_config(arch)
    jpol = jdryrun.policy_from_name(_policy_name(arch, shape))
    return jspecs.build_case(jcfg, shape, jmesh, jpol)


def _along(tree, other):
    """The nodes of ``other`` (a tree of ``tree``'s structure with specs at
    its leaves) at ``tree``'s leaves, in the order of ``_leaves``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _along(tree[k], other[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, o in zip(tree, other) for x in _along(t, o)]
    return [other]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_and_specs_match_reference(arch, mesh):
    shape_, axes = MESHES[mesh]
    jmesh, tmesh = AbstractMesh(shape_, axes), Mesh(shape_, axes, bind=False)
    cfg = get_config(arch)
    for shape in SHAPES.values():
        _, jargs, jsh = _ref_case(arch, shape, jmesh)
        want = _leaves(_port_layout(jargs, shape.kind))
        want_sh = _leaves(_port_layout(jsh, shape.kind))
        pol = dryrun.policy_from_name(_policy_name(arch, shape))
        glob, sp, held = specs.case_specs(cfg, shape, tmesh, pol)
        got = _leaves(glob)
        assert [_sig(x) for x in got] == [_sig(x) for x in want], shape.name
        got_sp, got_held = _along(glob, sp), _along(glob, held)
        assert len(got_sp) == len(got_held) == len(got)
        for g, s, w in zip(got, got_sp, want_sh):
            ndim = len(_sig(g)[0])
            assert s == _ref_spec(w, ndim), (shape.name, _sig(g))
        # a member's block of each input
        members = _leaves(specs.member_inputs(glob, held, tmesh,
                                              FakeTensorMode(), "cpu"))
        for m, g, h, s in zip(members, got, got_held, got_sp):
            assert _sig(m) == (shard_shape(_sig(g)[0], h, tmesh),
                               _sig(g)[1])
            # the held spec is the reference's, but for the train step's
            # global batch
            assert all(a == b or a is None for a, b in zip(h, s))
        if shape.kind == "decode":
            # every cache leaf as the reference holds it, its positions
            # split where the rule puts model there (ROADMAP queue A item
            # 10)
            cache_held, cache_sp = _along(glob[1], held[1]), _along(
                glob[1], sp[1])
            assert cache_held and cache_held == cache_sp, shape.name
            # and a member's zeroed cache on the mesh is those blocks
            block = tf.init_decode_cache(
                cfg, shape.global_batch, shape.seq_len,
                sliding=shape.sliding_window_decode, device="meta",
                mesh=tmesh)
            assert [_sig(x) for x in _leaves(block)] == [
                _sig(m) for m in _leaves(specs.member_inputs(
                    glob[1], held[1], tmesh, FakeTensorMode(), "cpu"))]
        n_model = sum("model" in h for h in got_held)
        assert n_model > 0
        if cfg.family in ("ssm", "hybrid"):
            # the recurrent blocks split too (ROADMAP queue A item 8b)
            fn, args, _ = specs.build_case(cfg, shape, tmesh, pol,
                                           device="cpu")
            dryrun.reset_globals()
            assert callable(fn) and len(_leaves(args)) == len(got)
            if shape.kind == "decode":   # every recurrent state splits
                c = held[1]
                states = ([c["conv"], c["ssm"]] if cfg.family == "ssm" else
                          [sp for k, sp in c["super"].items()
                           if k.endswith(("_conv", "_h"))]
                          + [sp for j, t in enumerate(c["rest"])
                             if cfg.block_pattern[j] == "rglru"
                             for sp in t])
                assert states and all("model" in h for h in states)


@pytest.fixture(scope="module")
def mesh256():
    dryrun.bind(256)
    try:
        yield make_mesh((256, 1), ("data", "model"))
    finally:
        dryrun.reset_globals()
        dryrun.release()


@pytest.mark.parametrize("arch,shape_name", OUTPUT_CASES)
def test_outputs_match_reference_on_256x1(mesh256, arch, shape_name):
    shape = SHAPES[shape_name]
    fn, jargs, _ = _ref_case(arch, shape, AbstractMesh((256, 1),
                                                       ("data", "model")))
    want = jax.eval_shape(fn, *jargs)
    cfg = get_config(arch)
    fake = FakeTensorMode()
    try:
        step, args, _ = specs.build_case(
            cfg, shape, mesh256,
            dryrun.policy_from_name(_policy_name(arch, shape)), fake, "cpu")
        with fake:
            got = step(*args)
    finally:
        dryrun.reset_globals()
    got_l, want_l = _leaves(got), _leaves(want)
    assert [_sig(x) for x in got_l] == [_sig(x) for x in want_l]
