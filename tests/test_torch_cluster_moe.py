"""The port's expert parallelism (``models/moe.py::moe_forward_ep``) and
the trainer's fsdp and expert-parallel steps on several members (one
process each, ``gloo``), against the JAX package on a mesh of Auto axes
over forced CPU devices, on the CPU.

(a) ``moe_forward_ep`` of qwen2-moe-a2.7b ``reduced()`` (16 padded experts)
    on (data 1, model 2) and (data 1, model 4), with every choice kept and
    with a capacity that drops some: the output and aux within
    ``tests/test_torch_moe.py``'s ``FWD`` on every member (bitwise alike);
    the gradient of ``sum(out * wt) + 3 aux`` to the params and x within a
    relative L2 error of ``GRAD_L2`` (1e-5), the expert stacks' summed over
    the members, each of which holds the gradient of its own experts only.
    The reference's ``jax.grad`` through its ``shard_map`` passes the
    ``psum``'s cotangent on unchanged and sums the replicated inputs'
    cotangents over ``model``: its gradient is ``moe_forward``'s (measured
    bitwise on model 2 and 4), and the port's backward gives the same.
    On one member ``moe_forward_ep`` is bitwise ``moe_forward``.
(b) Trainer steps (``tests/test_torch_cluster_steps.py::check_case``):
    qwen2-moe-a2.7b pssgd int8 + EF on (data 1, model 2), its expert stacks
    split over model at rest.
(c) The plain float32 all-reduce of an expert stack's block over ``data``
    on (data 2, model 2), which reduces the block as it is, and the bf16
    one, which gathers it: bitwise the mean of the gathered leaf cut
    again, output and error.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch import members  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import tp  # noqa: E402
from test_torch_cluster_steps import check_case  # noqa: E402
from test_torch_moe import FWD, GRAD_L2  # noqa: E402
from torch_cluster_jax import run_reference  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402


@pytest.fixture(scope="module")
def ep_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    path = str(d / "ref.npz")
    return path, run_reference("moe_ep", 4, path)


@pytest.mark.parametrize("m,cap", workers.EP_CASES)
def test_moe_forward_ep_matches_reference(ep_ref, m, cap, tmp_path):
    path, ref = ep_ref
    key = f"{m}/{cap}/"
    got = members.spawn(workers.moe_ep, m, (path, m, cap),
                        rendezvous_dir=str(tmp_path))
    for g in got[1:]:
        np.testing.assert_array_equal(g["out"], got[0]["out"])
        np.testing.assert_array_equal(g["aux"], got[0]["aux"])
    torch.testing.assert_close(torch.as_tensor(got[0]["out"]),
                               torch.as_tensor(ref[key + "out"]), **FWD)
    torch.testing.assert_close(torch.as_tensor(got[0]["aux"]),
                               torch.as_tensor(ref[key + "aux"]), **FWD)
    names = [k[len(key) + 2:] for k in ref if k.startswith(key + "g/")]
    e_local = 16 // m
    summed = {}
    for k in names:
        parts = [g["g/" + k] for g in got]
        if k.startswith("w_"):   # the expert stacks: each member's block
            for r, part in enumerate(parts):
                off = np.ones(part.shape[0], bool)
                off[r * e_local:(r + 1) * e_local] = False
                assert not part[off].any(), (k, r)
            summed[k] = np.sum(parts, axis=0)
        else:
            for part in parts[1:]:
                np.testing.assert_array_equal(part, parts[0], err_msg=k)
            summed[k] = parts[0]
    num = sum(float(((summed[k] - ref[key + "g/" + k]) ** 2).sum())
              for k in names)
    den = sum(float((ref[key + "g/" + k] ** 2).sum()) for k in names)
    assert (num / den) ** 0.5 <= GRAD_L2


def test_moe_forward_ep_on_one_member_is_moe_forward():
    cfg = workers.ep_cfg(0.5)
    p = tmoe.init_moe_block(torch.tensor([0, 7]), cfg, torch.float32)
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32))
    want = tmoe.moe_forward(p, x, cfg)
    got = tmoe.moe_forward_ep(p, x, cfg, make_local_mesh())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tp.set_model_mesh(make_local_mesh())
    try:
        through = tmoe.moe_forward(p, x, cfg)
    finally:
        tp.set_model_mesh(None)
    for g, w in zip(through, want):
        assert torch.equal(g, w)


STEP_CASES = ("pssgd_int8_moe_m2",)


@pytest.fixture(scope="module")
def steps_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("steps")
    path = str(d / "ref.npz")
    return path, run_reference("steps", 4, path, STEP_CASES)


@pytest.mark.parametrize("case", STEP_CASES)
def test_moe_steps_on_members_match_reference(steps_ref, case, tmp_path):
    check_case(case, *steps_ref, str(tmp_path))


def test_elementwise_allreduce_of_expert_block_is_the_gathered_one(
        tmp_path):
    got = members.spawn(workers.expert_mean, 4,
                        rendezvous_dir=str(tmp_path))
    for res in got:
        for method, (out, err, want, want_err) in res.items():
            np.testing.assert_array_equal(out, want, err_msg=method)
            np.testing.assert_array_equal(err, want_err, err_msg=method)
            assert out.shape == (2,) + workers.EXPERT_LEAF[1:]
