"""The fsdp step that gathers one layer at a time, and MoE routed over the
whole batch, on several members (one process each, ``gloo``), on the CPU.

(a) ``steps._make_fsdp_step`` keeps the member's blocks of every layer's
    leaves and gathers them inside the layer (again in the backward);
    ``torch_cluster_workers.whole_gather_step`` gathers every leaf whole
    for the step. The gathered values and each element's mean over the
    members are the same, so the two steps must agree bit for bit: the
    loss, params and moments after a step, for the dense, ssm, hybrid (with
    a ``rest`` layer), vlm and audio families' ``reduced()`` configs, remat
    on and off (the whole-gather step's remat off: remat changes no
    number), on (data 2) and (data 2, model 2). The layered step
    all-gathers more (each layer's leaves again in the backward) and,
    remat off, sends the same all-to-all bytes.
(b) qwen2-moe-a2.7b ``reduced()`` at its own capacity factor, where the
    reference jits its step over the mesh and leaves the data split to XLA,
    so that routing sees the global batch: the fsdp train step on (data 2)
    against the reference's (1, 1) step on the whole batch (the same global
    computation), loss (with the aux loss) and params within
    ``tests/test_torch_cluster_tp.py``'s tolerances; the serving steps on
    (data 2, model 1) and (data 2, model 2) against the reference's jitted
    on the same mesh, the logits and caches of ``TP_DECODE`` teacher-forced
    steps within ``tests/test_torch_serve.py``'s ``TOL`` and ``TPR_GREEDY``
    greedy tokens equal. Each case drops at least one choice; routed a
    member's rows alone, the members would drop others (and the decode,
    two tokens a member, none).
The reference runs concurrently in one subprocess (``tests/
torch_tp_jax.py``), both sides drawing the same init, and the two meshes'
members run side by side.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch import members  # noqa: E402
from test_torch_cluster_tp import LOSS_RTOL, PARAMS_REL_L2, _rel_l2  # noqa: E402,E501
from test_torch_serve import TOL  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401
from torch_tp_jax import finish_reference, start_reference  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402

LAYER_CASES = [(name, remat, mesh) for mesh in workers.FSDP_MESHES
               for name in workers.FSDP_CONFIGS for remat in (True, False)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    out = str(d / "ref.npz")
    proc = start_reference(("mserve", "mtrain"), out)
    try:
        with ThreadPoolExecutor(len(workers.FSDP_MESHES)) as pool:
            runs = {shape: pool.submit(members.spawn, workers.fsdp_members,
                                       shape[0] * shape[1], (shape,),
                                       rendezvous_dir=str(d))
                    for shape in workers.FSDP_MESHES}
            got = {shape: run.result() for shape, run in runs.items()}
    finally:
        want = finish_reference(proc, out)
    return got, want


@pytest.mark.parametrize("name,remat,mesh", LAYER_CASES,
                         ids=[f"{n}-remat{int(r)}-{m[0]}x{m[1]}"
                              for n, r, m in LAYER_CASES])
def test_layered_step_is_the_whole_gather_step(runs, name, remat, mesh):
    got, _ = runs
    key = f"{name}/{int(remat)}/"
    for r in got[mesh]:
        res = r["layers"]
        keys = [k for k in res if k.startswith(key) and "/wire/" not in k]
        assert any("/params/" in k for k in keys)
        for k in keys:
            np.testing.assert_array_equal(
                res[k], res[f"{name}/whole/{k[len(key):]}"], err_msg=k)
        layers, whole = ({op: int(res[f"{pre}wire/{op}"])
                          for op in ("all_gather", "all_to_all")}
                         for pre in (key, f"{name}/whole/"))
        # the same reduce-scatters; a recomputed layer sums its split
        # activations over model again (all-to-alls of its psums)
        if not remat:
            assert layers["all_to_all"] == whole["all_to_all"]
        assert layers["all_gather"] > whole["all_gather"]


def test_moe_fsdp_step_routes_the_whole_batch(runs):
    got, want = runs
    case = workers.MOE_STEP_CASES[0][0]
    res = got[(2, 1)]
    key = f"step/{case}/"
    assert sum(int(r[key + "drops"]) for r in res) > 0
    for i in range(workers.TP_STEPS):
        assert res[1][f"{key}loss/{i}"] == res[0][f"{key}loss/{i}"]
        np.testing.assert_allclose(res[0][f"{key}loss/{i}"],
                                   want[f"{key}loss/{i}"], rtol=LOSS_RTOL,
                                   err_msg=f"step {i}")
    fin = {k[len(key) + 6:]: v for k, v in res[0].items()
           if k.startswith(key + "final/")}
    w = {k[len(key) + 6:]: v for k, v in want.items()
         if k.startswith(key + "final/")}
    assert sorted(fin) == sorted(w)
    for k, v in fin.items():
        np.testing.assert_array_equal(res[1][key + "final/" + k], v)
    assert _rel_l2(fin, w) < PARAMS_REL_L2


@pytest.mark.parametrize("name,mesh", workers.MOE_SERVE_CASES,
                         ids=[workers.tp_key(*c)
                              for c in workers.MOE_SERVE_CASES])
def test_moe_serve_routes_the_whole_batch(runs, name, mesh):
    got, want = runs
    res = got[mesh]
    key = f"serve/{workers.tp_key(name, mesh)}/"
    assert sum(int(r[key + "drops"]) for r in res) > 0
    keys = sorted(k for k in want if k.startswith(key)
                  and k != key + "greedy/ref")
    assert keys == sorted(k for k in res[0] if k.startswith(key)
                          and k not in (key + "drops", key + "greedy/mesh"))
    for k in keys + [key + "greedy/mesh"]:
        for r in res[1:]:   # every member gathers the same
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
    for k in keys:
        assert res[0][k].shape == want[k].shape, k
        torch.testing.assert_close(torch.as_tensor(res[0][k]),
                                   torch.as_tensor(want[k]), **TOL, msg=k)
    np.testing.assert_array_equal(res[0][key + "greedy/mesh"],
                                  want[key + "greedy/ref"])


@pytest.mark.parametrize("make", ["prefill", "decode"])
def test_serving_step_on_data_members_needs_global_batch(make):
    # a member's rows do not say whether the batch split over its data
    # members, which decides how MoE layers route them
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    mesh = Mesh((2, 1), ("data", "model"), bind=False)
    build = {"prefill": steps.make_prefill_step,
             "decode": lambda c, **kw: steps.make_decode_step(
                 c, circular=False, **kw)}[make]
    with pytest.raises(ValueError, match="global_batch"):
        build(cfg, mesh=mesh)
    build(cfg, mesh=mesh, global_batch=4)
    steps.set_model_mesh(None)
