"""Tensor parallelism of the mamba and RG-LRU blocks over the ``model`` axis
(``models/ssm.py``, ``models/rglru.py``): the port's train and serving steps
on several members (one process each, ``gloo``) against the JAX package's
jitted steps on a mesh of Auto axes over forced CPU devices, on the CPU.

falcon-mamba-7b ``reduced()`` (``d_inner`` 256, ``ssm_state`` 8) and
recurrentgemma-2b ``reduced()`` (3 layers, ``lru_width`` 128, 4 q heads
over 1 kv head), each member its block of the channels and of every
recurrent state. Train (``torch_cluster_workers.TPR_STEP_CASES``,
``TP_STEPS`` steps of (8, 16)): pssgd none and int8 + EF on (data 2,
model 2) against the reference's (2, 2) (int8 + EF gathers mamba's
``in_proj``, held by halves, whole for the all-reduce: a layout error
would show there); pssgd none on (1, 2) against the reference's (1, 1)
(its pssgd and localsgd steps do not compile on (1, 2) for these families
either: "Cross-partition allreduce must be in (partial) manual
partitioning mode", JAX 0.9); fsdp on (1, 2) against its (1, 2);
falcon-mamba-7b on (1, 4), and with ``d_inner`` 130 on (1, 4), where
``2 d_inner`` divides over model and ``d_inner`` does not: the block is
held whole, ``in_proj`` too. Each member's loss a step within
``LOSS_RTOL``, the gathered params within ``PARAMS_REL_L2`` (relative
L2), the members' losses and gathered params bitwise alike, and the
leaves a member holds whole bitwise alike over the members holding the
same replica.

Serving (``TPR_SERVE_CASES``, (1, 2)): a (4, 16) prompt, 3 teacher-forced
decode steps, the logits and every cache leaf gathered whole within
``test_torch_serve.TOL`` of the reference's; every recurrent state a
member holds after the prefill and each decode step within
``STATE_ATOL`` of its block of one process's on the same params; then 6
greedy decode steps from the prefill's token, their tokens equal on the
members, one process and the reference, their logits within ``TOL``.

Measured here (JAX 0.9, torch 2.13, CPU), the sums over ``model`` adding
in other orders than XLA's: the loss off by at most 1.44e-7 relative
(falcon-mamba-7b on (1, 2) and (1, 4)), the params by at most 2.2e-7
relative L2 but for recurrentgemma-2b's int8 + EF on (2, 2), 7.8e-6 (a few
int8 codes flip with the order of the gradient's sums), all within
``tests/test_torch_cluster_tp.py``'s ``LOSS_RTOL`` and ``PARAMS_REL_L2``;
a member's recurrent state off its block of one process's by at most
1.7e-6 (``STATE_ATOL`` about 4x that), a gathered logit or cache entry
off the reference's by at most 2.9e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch import members  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from test_torch_cluster_tp import (LOSS_RTOL, PARAMS_REL_L2,  # noqa: E402
                                   _rel_l2)
from test_torch_serve import TOL  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401
from torch_tp_jax import finish_reference, start_reference  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402

STATE_ATOL = 7e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The members' results by mesh (one spawn a mesh, train and serving
    cases together) and the reference's."""
    d = tmp_path_factory.mktemp("tp_recurrent")
    outs = {k: str(d / f"{k}.npz") for k in ("rtrain", "rserve")}
    procs = {k: start_reference(k, out) for k, out in outs.items()}
    kinds = {}
    for c in workers.TPR_STEP_CASES:
        kinds.setdefault(c[4], {"rtrain"})
    for _, m in workers.TPR_SERVE_CASES:
        kinds.setdefault(m, set()).add("rserve")
    got = {}
    try:
        for shape in sorted(kinds):
            got[shape] = members.spawn(
                workers.tp_members, shape[0] * shape[1],
                (shape, tuple(sorted(kinds[shape]))), rendezvous_dir=str(d))
    finally:
        want = {}
        for k, proc in procs.items():
            want.update(finish_reference(proc, outs[k]))
    return got, want


@pytest.mark.parametrize("case", [c[0] for c in workers.TPR_STEP_CASES])
def test_tp_recurrent_steps_match_reference(runs, case):
    name, cname, mode, comp, shape, _ = next(
        c for c in workers.TPR_STEP_CASES if c[0] == case)
    got, want = runs
    res = got[shape]
    key = f"step/{case}/"
    for i in range(workers.TP_STEPS):
        for r in res:
            assert r[f"{key}loss/{i}"] == res[0][f"{key}loss/{i}"]
        np.testing.assert_allclose(res[0][f"{key}loss/{i}"],
                                   want[f"{key}loss/{i}"], rtol=LOSS_RTOL,
                                   err_msg=f"step {i}")
    fin = {k[len(key) + 6:]: v for k, v in res[0].items()
           if k.startswith(key + "final/")}
    w = {k[len(key) + 6:]: v for k, v in want.items()
         if k.startswith(key + "final/")}
    assert sorted(fin) == sorted(w)
    for r in res[1:]:
        for k, v in fin.items():
            np.testing.assert_array_equal(r[f"{key}final/{k}"], v)
    assert _rel_l2(fin, w) < PARAMS_REL_L2
    cfg = workers.tp_cfg(cname)
    pol = tsteps.TrainPolicy(mode=mode, compression=comp,
                             error_feedback=comp in ("int8", "sign"))
    held = tsteps.held_specs(cfg, pol, Mesh(shape, ("data", "model"),
                                            bind=False))["params"]
    m = shape[1]
    groups = ([list(range(len(res)))] if mode == "pssgd" else
              [list(range(i * m, (i + 1) * m)) for i in range(shape[0])])
    split = {k for k, sp in held.items() if "model" in sp}
    recurrent = {k for k in held if "/mamba/" in k or "/rec/" in k}
    if cname == "mamba_part":   # the block whole, in_proj too
        assert not split & recurrent
        assert cfg.d_inner % m and not 2 * cfg.d_inner % m
    else:   # every recurrent leaf but the norms splits
        assert recurrent and recurrent <= split
    for grp in groups:
        for k in held:
            if k not in split:
                for r in grp[1:]:
                    np.testing.assert_array_equal(
                        res[r][f"{key}local/{k}"],
                        res[grp[0]][f"{key}local/{k}"], err_msg=k)


@pytest.mark.parametrize("name,mesh", workers.TPR_SERVE_CASES,
                         ids=[workers.tp_key(*c)
                              for c in workers.TPR_SERVE_CASES])
def test_tp_recurrent_serve_matches_reference(runs, name, mesh):
    got, want = runs
    res = got[mesh]
    key = f"serve/{workers.tp_key(name, mesh)}/"
    keys = sorted(k for k in want if k.startswith(key)
                  and "/greedy/" not in k)
    assert keys == sorted(k for k in res[0] if k.startswith(key)
                          and "/greedy/" not in k and "/state_err/" not in k)
    cfg = workers.tp_cfg(name)
    for k in keys:
        for r in res[1:]:   # every member gathers the same
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
        assert res[0][k].shape == want[k].shape, k
        torch.testing.assert_close(torch.as_tensor(res[0][k]),
                                   torch.as_tensor(want[k]), **TOL, msg=k)
    # each member's recurrent states: its block of one process's
    states = ({"conv", "ssm"} if cfg.family == "ssm" else
              {"super/p0_conv", "super/p0_h", "super/p1_conv", "super/p1_h"})
    for r in res:
        errs = {k[len(key) + 10:]: v for k, v in r.items()
                if k.startswith(key + "state_err/")}
        for tag in ["prefill"] + [f"decode/{i}"
                                  for i in range(workers.TP_DECODE)]:
            assert states <= {k[len(tag) + 1:] for k in errs
                              if k.startswith(tag + "/")}, tag
        for k, v in errs.items():
            assert v <= STATE_ATOL, (k, v)
    # greedy decoding: the same tokens on the members, one process and the
    # reference; the logits the reference's
    for r in res:
        np.testing.assert_array_equal(r[key + "greedy/mesh"],
                                      want[key + "greedy/ref"])
        np.testing.assert_array_equal(r[key + "greedy/one"],
                                      want[key + "greedy/ref"])
    torch.testing.assert_close(torch.as_tensor(res[0][key + "greedy/logits"]),
                               torch.as_tensor(want[key + "greedy/logits"]),
                               **TOL)
