"""The layout a member holds its state by over a mesh with a ``model``
axis (``launch/steps.py::held_specs``) against the JAX package's
``state_shardings``, on the CPU, for every config at its published size
(the reference's state from ``jax.eval_shape`` on an ``AbstractMesh``, so
nothing is allocated); and the trainer's command line on a model axis of
2.

(f) For every leaf of the state (pssgd int8 + EF: params, moments and the
client-stacked EF; fsdp: split over the data axis too) on (data 1, model
2), (data 2, model 2) and a (16, 16) description, the held spec equals the
reference's, leaf for leaf, the mamba and RG-LRU leaves too (mamba's
``in_proj`` by halves, ``sharding.HALVES``, which equals ``"model"``).
(g) The recurrent leaves of falcon-mamba-7b and recurrentgemma-2b
``reduced()`` on (1, 2) and (1, 4): each member's block cut by
``sharding.shard`` and joined by ``gather`` against the reference's whole
leaves (its unjitted init), ``in_proj``'s block its columns of each half;
with ``d_inner`` 130 on (1, 4) ``in_proj`` is held whole.
"""
import re

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import dryrun, members, sharding  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.transformer import flatten_params  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401
import torch_cluster_workers as workers  # noqa: E402

# ---------------------------------------------------------------------------
LAYOUT_MESHES = {"1x2": (1, 2), "2x2": (2, 2), "16x16": (16, 16)}


def _flat_state(state):
    """The reference's state specs in the port's flat layout."""
    def tree(t):
        return None if t is None else flatten_params(t)
    opt = state["opt"]
    out = {"params": tree(state["params"]), "m": tree(opt.m),
           "v": tree(opt.v)}
    if "ef" in state:
        out["ef"] = tree(state["ef"])
    return out


def _spec(sharding_, ndim):
    spec = tuple(sharding_.spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("policy", ["int8_ef", "fsdp"])
@pytest.mark.parametrize("mesh", list(LAYOUT_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_held_specs_match_reference(arch, mesh, policy):
    shape = LAYOUT_MESHES[mesh]
    jmesh = AbstractMesh(shape, ("data", "model"))
    jpol = jdryrun.policy_from_name(policy)
    jcfg = jget_config(arch)
    sds = jax.eval_shape(jsteps.make_init_fn(jcfg, jpol, jmesh),
                         jax.random.PRNGKey(0))
    want = _flat_state(jsteps.state_shardings(jcfg, jpol, jmesh, sds))
    shapes = _flat_state(sds)
    cfg = get_config(arch)
    got = tsteps.held_specs(cfg, dryrun.policy_from_name(policy),
                            Mesh(shape, ("data", "model"), bind=False))
    got = {"params": got["params"], "m": got["opt"].m, "v": got["opt"].v,
           **({"ef": got["ef"]} if "ef" in got else {})}
    assert sorted(got) == sorted(k for k, v in want.items() if v is not None)
    n_split = 0
    for part, specs in got.items():
        assert sorted(specs) == sorted(want[part]), part
        for k, sp in specs.items():
            ref = _spec(want[part][k], len(shapes[part][k].shape))
            assert sp == ref, (part, k)
            assert any(a is sharding.HALVES for a in sp) == (
                k.endswith("/in_proj") and "model" in ref), (part, k)
            n_split += "model" in sp
    assert n_split > 0


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_recurrent_blocks_shard_and_gather_against_reference(tmp_path,
                                                              shape):
    got = members.spawn(workers.recurrent_layout, shape[1], (shape,),
                        rendezvous_dir=str(tmp_path))
    m = shape[1]
    for name in workers.LAYOUT_CONFIGS:
        cfg = workers.tp_cfg(name)
        jparams = jtf.init_params(cfg, jax.random.PRNGKey(0))
        want = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams))
        held = tsteps.held_specs(cfg, tsteps.TrainPolicy(), Mesh(
            shape, ("data", "model"), bind=False))["params"]
        ref = flatten_params(jsharding.param_shardings(
            cfg, jparams, AbstractMesh(shape, ("data", "model"))))
        rec = [k for k in want if "/mamba/" in k or "/rec/" in k]
        assert rec
        if name == "mamba_part":   # the partial case on 4, not on 2
            assert (cfg.d_inner % m == 0) == (m == 2)
        whole = cfg.family == "ssm" and cfg.d_inner % m != 0
        for k in rec:
            spec = _spec(ref[k], want[k].ndim)
            if whole and k.endswith("/in_proj"):
                assert "model" in spec and held[k] == (None,) * want[k].ndim
            else:
                assert held[k] == spec, k
            assert ("model" in held[k]) == (not whole), k
            for r, res in enumerate(got):
                np.testing.assert_array_equal(res[f"{name}/gather/{k}"],
                                              want[k], err_msg=k)
                block = res[f"{name}/local/{k}"]
                if "model" not in held[k]:
                    np.testing.assert_array_equal(block, want[k])
                elif k.endswith("/in_proj"):
                    c = cfg.d_inner // m
                    np.testing.assert_array_equal(block, np.concatenate(
                        [want[k][..., r * c:(r + 1) * c],
                         want[k][..., cfg.d_inner + r * c:
                                 cfg.d_inner + (r + 1) * c]], axis=-1))
                else:
                    dim = held[k].index("model")
                    np.testing.assert_array_equal(block, np.split(
                        want[k], m, axis=dim)[r], err_msg=k)


CLI_ARCHS = ("gemma-2b", "stablelm-12b", "llama-3.2-vision-11b",
             "whisper-base")


def _losses(out: str):
    return [float(x) for x in re.findall(r"^step +\d+ +loss ([0-9.]+)", out,
                                         re.M)]


def test_cluster_cli_splits_dense_families_over_model(tmp_path, capsys):
    """``--cluster --mesh-model 2`` on two members (``gloo``) trains the
    dense, vlm and audio families; the printed losses agree with one
    member's to their 4 printed decimals (within one unit of the last,
    the sums over ``model`` adding in another order)."""
    argv = ["--reduced", "--cluster", "--steps", "4", "--seq-len", "16",
            "--batch", "8", "--lr", "3e-3"]
    got = members.spawn(workers.cli_runs, 2, ([
        ["--arch", a, "--mesh-model", "2"] + argv for a in CLI_ARCHS],),
        rendezvous_dir=str(tmp_path))
    for arch, out, quiet in zip(CLI_ARCHS, got[0], got[1]):
        assert quiet == ""   # rank 0 alone prints
        assert out.splitlines()[0].startswith("members: 2 members")
        ttrain.main(["--arch", arch] + argv, device="cpu")
        want = _losses(capsys.readouterr().out)
        assert len(_losses(out)) == len(want) == 4
        np.testing.assert_allclose(_losses(out), want, rtol=0, atol=1e-4,
                                   err_msg=arch)
