"""The port's ``run_sweep(devices=...)`` over several members (one process
each, ``gloo``) on the CPU: a ragged grid of 18 variants (6 seeds x 3
top-k budgets) for random and pf scheduling in mixture mode, on 4 members
(padded with copies of variant 0 to 20, five a member, the logs gathered
and cut back). Every member returns the whole result, bitwise the port's
one-process sweep, and that matches the reference's single-device
``run_sweep`` within ``tests/test_torch_sweep.py``'s tolerances (the
reference's own sharded sweep stops under JAX 0.9:
``tests/test_sweep_sharded.py``, a scan carry of unequal types). Also the
padding and the blocks, and ``mesh=`` a 1-D mesh.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.compression import compression_params  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from repro_torch.launch import members  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from test_torch_sweep import (AP01, _assert_bitwise,  # noqa: E402
                              _assert_sweep_match, _problem, _tcfg)
import torch_cluster_workers as workers  # noqa: E402

SEEDS = [2, 5, 8, 9, 10, 11]   # clear of pf's round-0 ties at N = 8
KS = (1, 3, 8)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep")
    rounds, n = 4, 8
    prob = _problem(rounds, n)
    jcfg = jrt.SimConfig(n_devices=n, n_scheduled=3, rounds=rounds,
                         algo_params=AP01, model_bits=32.0 * 16,
                         compression="topk")
    grid = [compression_params(k=k, levels=16) for k in KS]
    kw = dict(seeds=SEEDS, policies=["random", "pf"])
    params, loss_fn, batches, tparams, tbatches = prob
    ref = jrt.run_sweep(jcfg, loss_fn, params, batches, cparams_grid=grid,
                        **kw)
    cfg = _tcfg(jcfg)
    tkw = dict(kw, cparams_grid=[convert.compression_params_from_jax(c)
                                 for c in grid])
    one = trt.run_sweep(cfg, workers.linear_loss, tparams, tbatches,
                        device="cpu", **tkw)
    path = str(d / "args.pt")
    torch.save((cfg, tparams, tbatches, tkw), path)
    got = members.spawn(workers.sweep, 4, (path,), rendezvous_dir=str(d))
    return ref, one, got


def _logs(flat, key):
    return trt.SimLogs(**{f: flat[f"{key}/{f}"] for f in trt._LOG_FIELDS})


@pytest.mark.parametrize("rank", range(4))
def test_sharded_sweep_bitwise_one_process(sweeps, rank):
    _, one, got = sweeps
    mine = {key: _logs(got[rank], key) for key in one}
    assert all(v.loss.shape[0] == len(SEEDS) * len(KS)
               for v in mine.values())
    _assert_bitwise(one, mine)


def test_one_process_sweep_matches_reference(sweeps):
    ref, one, _ = sweeps
    _assert_sweep_match(ref, one)


def test_variant_blocks_pad_with_variant_zero():
    grid = list(range(18))
    mesh = Mesh((4,), ("variants",), bind=False)
    blocks = []
    for r in range(4):
        mesh.rank, mesh.coords = r, mesh.coords_of(r)
        blocks.append(trt._block_of(grid, mesh))
    assert blocks == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11, 12, 13, 14],
                      [15, 16, 17, 0, 0]]
    assert trt._resolve_sweep_mesh(None, Mesh((1,), ("v",))) is None
    assert trt._resolve_sweep_mesh(1, None) is None
    assert trt._resolve_sweep_mesh("auto", None) is None
    with pytest.raises(ValueError, match="1-D mesh"):
        trt._resolve_sweep_mesh(None, Mesh((2, 2), ("a", "b"), bind=False))
