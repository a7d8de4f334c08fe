"""The port's trainer steps on several members (one process each,
``gloo``, from ``repro_torch.launch.members.spawn``) against the JAX
package's on a mesh of Auto axes over forced CPU devices, on the CPU.

Each case of ``torch_cluster_workers.STEP_CASES`` starts from the
reference's jitted state on its mesh, cut to each member
(``steps.shard_state``), and takes three steps of (8, 32) batches, every
member drawing the same global batch and keeping its rows:
- here, pssgd int8 + EF on (data 2) and pssgd sign + EF on (pod 2, data
  2), the data stage with EF then the pod stage;
- in ``test_torch_cluster_localsgd_fsdp.py``, localsgd with the pod sync
  and fsdp; in ``test_torch_cluster_moe.py``, the expert-parallel step.
Held to ``tests/test_torch_steps.py``'s tolerances: the loss within
``LOSS_RTOL`` a step and the gathered params within ``PARAMS_REL_L2``
(relative L2) over the three chained steps, the step counters equal; and
the EF after the first step off by more than 1e-6 at no more than
``EF_OFF_SHARE`` of its coordinates. Over the chained steps the EF drifts
past that share as in
``test_torch_steps.py::test_moe_steps_match_reference`` (1558 of 1 082 624
on (data 2) after three steps: a flipped int8 code moves its coordinate by
a whole Adam step, and the next gradient with it; ROADMAP queue C item
10). The members' params agree bit for
bit after every step where the state replicates them (every data member of
pssgd; the pod sync's bf16 mean within each data column of localsgd), and
fsdp's members hold half the params' bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch import members, steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from test_torch_steps import (EF_OFF_SHARE, LOSS_RTOL,  # noqa: E402
                              PARAMS_REL_L2)
from torch_cluster_jax import run_reference  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402

CASES = ("pssgd_int8_d2", "pssgd_sign_p2d2")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("steps")
    path = str(d / "ref.npz")
    return path, run_reference("steps", 4, path, CASES)


def _replicas(mode, shape, axes):
    """Groups of members holding the same params: every member in pssgd
    (the leaves split over model apart), the members of a pod in localsgd
    without the pod sync, none in fsdp."""
    n = int(np.prod(shape))
    if mode == "pssgd":
        return [list(range(n))]
    if mode == "localsgd":
        per_pod = n // shape[0]
        return [list(range(p * per_pod, (p + 1) * per_pod))
                for p in range(shape[0])]
    return []


def _model_split(case):
    """The params a member of ``case`` holds a block of over ``model``."""
    cfg, pol, shape, axes = workers._step_case(case)
    specs = steps.held_specs(cfg, pol, Mesh(shape, axes, bind=False))
    return {k for k, sp in specs["params"].items() if "model" in sp}


def _rel_l2(got, want, keys):
    num = sum(float(((got[k].astype(np.float64) - want[k]) ** 2).sum())
              for k in keys)
    den = sum(float((want[k].astype(np.float64) ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def check_case(case, path, want, rdv):
    """Run ``case`` on its members and hold it to the reference."""
    _, arch, mode, comp, shape, axes, _ = next(c for c in workers.STEP_CASES
                                               if c[0] == case)
    n = int(np.prod(shape))
    got = members.spawn(workers.steps, n, (case, path), rendezvous_dir=rdv)
    for i in range(workers.STEPS):
        for g in got:
            np.testing.assert_allclose(g[f"loss/{i}"],
                                       want[f"{case}/loss/{i}"],
                                       rtol=LOSS_RTOL, err_msg=f"step {i}")
    # every member gathers the same state
    fin = {k[len("final/"):]: v for k, v in got[0].items()
           if k.startswith("final/")}
    for g in got[1:]:
        for k, v in fin.items():
            np.testing.assert_array_equal(g["final/" + k], v)
    w = {k[len(case) + 7:]: v for k, v in want.items()
         if k.startswith(f"{case}/final/")}
    assert sorted(fin) == sorted(w)
    assert int(fin["step"]) == int(w["step"]) == workers.STEPS
    assert int(fin["opt/step"]) == int(w["opt/step"])
    pkeys = [k for k in w if k.startswith("params/")]
    assert _rel_l2(fin, w, pkeys) < PARAMS_REL_L2
    for k in pkeys:
        assert fin[k].shape == w[k].shape and fin[k].dtype == w[k].dtype
    ekeys = [k for k in w if k.startswith("ef/")]
    assert bool(ekeys) == (comp != "none")
    if ekeys:   # the first step's EF, from the reference's state
        off = sum(int((np.abs(got[0][f"ef0/{k}"] - want[f"{case}/ef0/{k}"])
                       > 1e-6).sum()) for k in ekeys)
        total = sum(w[k].size for k in ekeys)
        assert off <= EF_OFF_SHARE * total, (off, total)
    # members holding the same replica agree bit for bit after every step
    # (the leaves split over model apart)
    split = _model_split(case)
    for grp in _replicas(mode, shape, axes):
        for k in got[0]:
            if k.startswith("local/") and k.split("/", 2)[2] not in split:
                for r in grp[1:]:
                    np.testing.assert_array_equal(got[r][k], got[grp[0]][k],
                                                  err_msg=k)
    if mode == "fsdp":
        whole = sum(w[k].nbytes for k in pkeys)
        for g in got:
            assert int(g["held_bytes"]) < 0.6 * whole


@pytest.mark.parametrize("case", CASES)
def test_steps_on_members_match_reference(ref, case, tmp_path):
    check_case(case, *ref, str(tmp_path))
