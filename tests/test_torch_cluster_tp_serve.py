"""Tensor parallelism of the serving steps over the ``model`` axis: the
port's ``make_prefill_step`` / ``make_decode_step`` on several members
(one process each, ``gloo``) against the JAX package's, jitted with the
reference's param, batch and cache shardings on a mesh of Auto axes over
forced CPU devices, on the CPU.

Each case of ``torch_cluster_workers.TP_SERVE_CASES`` prefills a (4, 16)
prompt (random vision / audio embeddings, the vlm's cross gates at 0.5),
loads the prefill cache into a decode cache of 24 (each member its block:
its rows over ``data``, its kv heads over ``model`` where they split) and
takes 3 teacher-forced decode steps. The logits of every step and every
leaf of the prefill and the final decode cache, gathered whole, hold to
the reference's within ``TOL``:
(a) gemma-2b, stablelm-12b, llama-3.2-vision-11b, whisper-base and
    qwen2-moe-a2.7b ``reduced()`` on (data 1, model 2) and (data 2,
    model 2);
(d) stablelm-12b ``reduced()`` (4 heads, 2 kv heads) on (1, 4) and its
    6-head, 3-kv-head variant on (1, 2), where the q heads split and the
    kv heads (and the caches) stay whole;
(e) whisper-base with an odd vocabulary (511) on (1, 2), the logits whole.
``TOL`` is ``tests/test_torch_serve.py``'s: measured here (JAX 0.9, torch
2.13, CPU), the largest difference is 1.9e-6 absolute in a logit (the
sums over ``model`` and XLA's partitioned sums add in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch import members  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401
from test_torch_serve import TOL  # noqa: E402
from torch_tp_jax import finish_reference, start_reference  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_serve")
    out = str(d / "ref.npz")
    proc = start_reference("serve", out)
    got = {}
    try:
        for shape in sorted({m for _, m in workers.TP_SERVE_CASES}):
            got[shape] = members.spawn(workers.tp_members,
                                       shape[0] * shape[1], (shape, "serve"),
                                       rendezvous_dir=str(d))
    finally:
        want = finish_reference(proc, out)
    return got, want


@pytest.mark.parametrize("name,mesh", workers.TP_SERVE_CASES,
                         ids=[workers.tp_key(*c)
                              for c in workers.TP_SERVE_CASES])
def test_tp_serve_matches_reference(runs, name, mesh):
    got, want = runs
    res = got[mesh]
    key = f"serve/{workers.tp_key(name, mesh)}/"
    keys = sorted(k for k in want if k.startswith(key))
    assert keys == sorted(k for k in res[0] if k.startswith(key))
    assert any("/cache/" in k for k in keys)
    cfg = workers.tp_cfg(name)
    for k in keys:
        for r in res[1:]:   # every member gathers the same
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
        assert res[0][k].shape == want[k].shape, k
        torch.testing.assert_close(torch.as_tensor(res[0][k]),
                                   torch.as_tensor(want[k]), **TOL, msg=k)
        if k.endswith("logits"):
            assert res[0][k].shape[-1] == cfg.vocab_size
