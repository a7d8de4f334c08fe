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
(e) whisper-base with an odd vocabulary (511) on (1, 2), the logits whole;
(f) ``SEQ_SERVE_CASES``: a decode cache of ``cfg.d_inner`` positions,
    which the cache rule splits over ``model`` where the kv heads do not
    divide: gemma-2b on (1, 2) and (2, 2), llama3-405b on (1, 4) (members
    1-3 start with no valid position), the vlm's ring on (1, 4) decoding
    at T, T + 1, T + 2; then greedy steps from the prefill, the tokens
    equal to the reference's.
``TOL`` is ``tests/test_torch_serve.py``'s: measured here (JAX 0.9, torch
2.13, CPU), the largest difference is 1.9e-6 absolute in a logit (the
sums over ``model`` and XLA's partitioned sums add in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch import members, specs  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401
from test_torch_serve import TOL  # noqa: E402
from torch_tp_jax import finish_reference, start_reference  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_serve")
    out = str(d / "ref.npz")
    kinds = ("serve", "sserve")
    proc = start_reference(kinds, out)
    got = {}
    try:
        for shape in sorted({m for _, m in workers.TP_SERVE_CASES
                             + workers.SEQ_SERVE_CASES}):
            got[shape] = members.spawn(workers.tp_members,
                                       shape[0] * shape[1], (shape, kinds),
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


@pytest.mark.parametrize("name,mesh", workers.SEQ_SERVE_CASES,
                         ids=[workers.tp_key(*c)
                              for c in workers.SEQ_SERVE_CASES])
def test_seq_split_serve_matches_reference(runs, name, mesh):
    got, want = runs
    res = got[mesh]
    key = f"serve/{workers.tp_key(name, mesh)}/"
    keys = sorted(k for k in want if k.startswith(key)
                  and k != key + "greedy/ref")
    assert keys == sorted(k for k in res[0] if k.startswith(key)
                          and k != key + "greedy/mesh")
    cfg = workers.tp_cfg(name)
    t = workers.serve_layout(name)[0]
    # the rule puts model on the decode cache's positions
    glob = tf.init_decode_cache(cfg, workers.TP_B, t, device="meta")
    sp = specs.held_cache_specs(cfg, glob, Mesh(mesh, ("data", "model"),
                                                bind=False), workers.TP_B)
    assert sp["k"][-3] == "model" and "model" not in sp["k"][:-3]
    for k in keys + [key + "greedy/mesh"]:
        for r in res[1:]:   # every member gathers the same
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
    for k in keys:
        assert res[0][k].shape == want[k].shape, k
        torch.testing.assert_close(torch.as_tensor(res[0][k]),
                                   torch.as_tensor(want[k]), **TOL, msg=k)
    np.testing.assert_array_equal(res[0][key + "greedy/mesh"],
                                  want[key + "greedy/ref"])


def test_decode_step_on_model_members_needs_cache_len():
    # a member's block of a cache does not say whether it holds all of its
    # positions: an unsplit cache of d_inner / 2 looks like a split one
    from repro_torch.launch import steps
    cfg = workers.tp_cfg("gemma_seq")
    mesh = Mesh((1, 2), ("data", "model"), bind=False)
    try:
        with pytest.raises(ValueError, match="cache_len"):
            steps.make_decode_step(cfg, circular=False, mesh=mesh)
        steps.make_decode_step(cfg, circular=False, mesh=mesh,
                               cache_len=cfg.d_inner)
    finally:
        steps.set_model_mesh(None)
