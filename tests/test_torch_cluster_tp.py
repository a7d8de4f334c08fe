"""Tensor parallelism of the transformer block over the ``model`` axis
(``models/tp.py``): the port's train steps on several members (one process
each, ``gloo``) against the JAX package's jitted steps on a mesh of Auto
axes over forced CPU devices, on the CPU. Serving is in
``tests/test_torch_cluster_tp_serve.py``.

Every case of ``torch_cluster_workers.TP_STEP_CASES`` takes ``TP_STEPS``
steps of (8, 16) batches from the same initial state on both sides (the
port's init is the reference's unjitted init, bit for bit), the vlm's
cross gates at 0.5 and random vision / audio embeddings:
(b) gemma-2b ``reduced()`` (4 q heads over 1 kv head: ``wq`` splits,
    ``wk`` / ``wv`` do not and their gradient is summed over ``model``;
    tied embeddings split over the vocabulary) on (data 2, model 2), pssgd
    none, int8 + EF, sign + EF, localsgd H 2 and fsdp, against the
    reference's (2, 2);
(c) on (data 1, model 2), where the reference's pssgd and localsgd steps
    do not compile on JAX 0.9 ("Cross-partition allreduce must be in
    (partial) manual partitioning mode"): gemma-2b and llama-3.2-vision-11b
    pssgd none against the reference's (1, 1), the same global step; fsdp
    against the reference's (1, 2);
(d) the kv-head trap: stablelm-12b ``reduced()`` (4 heads, 2 kv heads) on
    (1, 4), one q head a member, and its 6-head, 3-kv-head variant on
    (1, 2), where member 0's q heads 0-2 use kv heads 0, 0 and 1;
(e) whisper-base with an odd vocabulary (511) on (1, 2): its embedding
    and ``lm_head`` stay whole.
Each member's loss a step within ``LOSS_RTOL`` of the reference's and the
gathered params within ``PARAMS_REL_L2`` (relative L2); the members'
losses and gathered params bitwise alike, and the leaves a member holds
whole bitwise alike over the members that hold the same replica. Measured
here (JAX 0.9, torch 2.13, CPU), the sums over ``model`` and XLA's
partitioned sums adding in other orders: the loss off by at most 2.2e-7
relative (the vlm), the params by at most 6.9e-7 relative L2 but for int8
+ EF on (2, 2), 5.6e-6 (a few int8 codes flip with the order of the
gradient's sums). The tolerances keep a margin of 4.5x and 3.5x over
those. ``tests/test_torch_cluster_tp_specs.py`` holds the layout a member
keeps its state by.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch import members  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_local_mesh  # noqa: E402
from repro_torch.models import tp  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401
from torch_tp_jax import finish_reference, start_reference  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402

CASES = [c[0] for c in workers.TP_STEP_CASES]
LOSS_RTOL, PARAMS_REL_L2 = 1e-6, 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    out = str(d / "ref.npz")
    proc = start_reference("train", out)
    got = {}
    try:
        for shape in sorted({c[4] for c in workers.TP_STEP_CASES}):
            got[shape] = members.spawn(workers.tp_members,
                                       shape[0] * shape[1], (shape, "train"),
                                       rendezvous_dir=str(d))
    finally:
        want = finish_reference(proc, out)
    return got, want


def _rel_l2(got, want):
    num = sum(float(((got[k].astype(np.float64) - want[k]) ** 2).sum())
              for k in want)
    den = sum(float((want[k].astype(np.float64) ** 2).sum()) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("case", CASES)
def test_tp_steps_match_reference(runs, case):
    name, cname, mode, comp, shape, _ = next(
        c for c in workers.TP_STEP_CASES if c[0] == case)
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
    # the leaves a member holds whole: alike over the members holding the
    # same replica (all of them in pssgd, a data row's in localsgd / fsdp)
    cfg = workers.tp_cfg(cname)
    pol = tsteps.TrainPolicy(mode=mode, compression=comp,
                             error_feedback=comp in ("int8", "sign"))
    held = tsteps.held_specs(cfg, pol, Mesh(shape, ("data", "model"),
                                            bind=False))["params"]
    m = shape[1]
    groups = ([list(range(len(res)))] if mode == "pssgd" else
              [list(range(i * m, (i + 1) * m)) for i in range(shape[0])])
    split = {k for k, sp in held.items() if "model" in sp}
    assert split   # every case splits something over model
    for grp in groups:
        for k in held:
            if k not in split:
                for r in grp[1:]:
                    np.testing.assert_array_equal(
                        res[r][f"{key}local/{k}"],
                        res[grp[0]][f"{key}local/{k}"], err_msg=k)


def test_tp_kv_trap_cases_split_q_but_not_kv():
    """(d)'s configs hold a block of the q heads and the whole kv heads."""
    for cname, m in (("stablelm", 4), ("stablelm_6_3", 2)):
        cfg = workers.tp_cfg(cname)
        held = tsteps.held_specs(cfg, tsteps.TrainPolicy(), Mesh(
            (1, m), ("data", "model"), bind=False))["params"]
        assert held["blocks/attn/wq"] == (None, None, "model")
        assert held["blocks/attn/wk"] == (None, None, None)
        assert cfg.n_heads % m == 0 and cfg.n_kv_heads % m != 0


def test_model_axis_of_one_adds_no_op():
    """On a model axis of one member every helper returns its input."""
    x = torch.ones(3, 4)
    tp.set_model_mesh(make_local_mesh())
    try:
        assert tp.n() == 1 and tp.index() == 0
        assert tp.copy_to(x) is x and tp.sum_over(x) is x
        assert tp.gather_last(x, 4) is x
        assert torch.equal(tp.max_over(x), x)
    finally:
        tp.set_model_mesh(None)
    assert tp.model_mesh() is None
