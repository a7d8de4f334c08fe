"""The layout a member holds its state by over a mesh with a ``model``
axis (``launch/steps.py::held_specs``) against the JAX package's
``state_shardings``, on the CPU, for every config at its published size
(the reference's state from ``jax.eval_shape`` on an ``AbstractMesh``, so
nothing is allocated); and the trainer's command line on a model axis of
2.

(f) For every leaf of the state (pssgd int8 + EF: params, moments and the
client-stacked EF; fsdp: split over the data axis too) on (data 1, model
2), (data 2, model 2) and a (16, 16) description, the held spec equals the
reference's, leaf for leaf, but for ``model`` on the mamba and RG-LRU
leaves, which the port holds whole (``sharding.model_split``; ROADMAP
queue A item 8b).
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
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
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
            if sharding.model_split(k):
                assert sp == ref, (part, k)
            else:   # held whole over model: item 8b
                assert sp == tuple(None if a == "model" else a
                                   for a in ref), (part, k)
            n_split += "model" in sp
    assert n_split > 0


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
