"""The port's local-SGD and FSDP steps on several members (one process
each, ``gloo``) against the JAX package on a mesh of Auto axes over forced
CPU devices, on the CPU, held as ``tests/test_torch_cluster_steps.py``
holds pssgd (``check_case``):

- localsgd int8 + EF at H = 2 on (pod 2, data 2), delta-consensus over
  data. The reference's step stops XLA on the CPU when it also syncs the
  pods (its bf16 ``pmean`` over "pod", ``src/repro/launch/steps.py:227``:
  "Invalid binary instruction opcode copy"), so this case runs with
  ``sync_pods=False``, and ``test_pod_sync`` holds the dense bf16 pod sync
  of Alg. 9 apart: the port's bf16 mean bitwise the reference's
  ``lax.pmean`` on a pod axis alone, and a localsgd step with the sync
  bitwise the step without it followed by that mean;
- fsdp on (data 2): params and moments at rest split over data (each
  member holds half the params' bytes), the gradient reduce-scattered.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch import members  # noqa: E402
from test_torch_cluster_steps import check_case  # noqa: E402
from torch_cluster_jax import run_reference  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402

CASES = ("localsgd_int8_p2d2", "fsdp_d2")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("steps")
    path = str(d / "ref.npz")
    return path, run_reference("steps", 4, path, CASES)


@pytest.mark.parametrize("case", CASES)
def test_steps_on_members_match_reference(ref, case, tmp_path):
    check_case(case, *ref, str(tmp_path))


def test_pod_sync(ref, tmp_path):
    path, want = ref
    got = members.spawn(workers.pod_sync, 4, (path,),
                        rendezvous_dir=str(tmp_path))
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["x"], want["pod_sync/out"][r // 2])
        assert int(g["off"]) == 0
        assert int(g["changed"]) > 0   # the sync moved the params
