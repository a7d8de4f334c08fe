"""The port's flat engine on the kernel row path, against the JAX engine.

N = 4096 clients, d = 256 (N * D = 2^20, the kernel-dispatch threshold),
1024-client blocks, on-device data (2 local steps of batch 2), 2 rounds, top-k / QSGD / scaled sign
with dense EF. On the CPU the port runs its kernels' plain versions and the
reference its compiled kernel mirror. Tolerances as in
``test_torch_engine.py``: participation and uplink bits equal, latency
within rtol 1e-5, loss within rtol 1e-4, at the same seed (see there).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from benchmarks.common import make_linear_problem  # noqa: E402
from repro.data import make_linear_datagen as jdatagen  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro_torch.core.algorithms import registry as talg  # noqa: E402
from repro_torch.data import make_linear_datagen as tdatagen  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from repro_torch.kernels import qsgd, sign_ef, topk_mask  # noqa: E402
from test_torch_engine import SEED, _assert_logs_match, _loss_t  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401

FLEET = dict(n_devices=4096, n_scheduled=64, rounds=2, local_steps=2,
             policy="random", seed=SEED)
D_FLEET = 256
BATCH = 2  # H = 2 local steps of 2 samples: a light CPU data stream


@functools.lru_cache(maxsize=None)
def _fleet_port(comp, chunk):
    """The port's run of a case, made once for the tests that read it."""
    _, _, _, w_star = make_linear_problem(d=D_FLEET)
    cfg = trt.SimConfig(
        algo_params=talg.algo_params(lr=0.1), compression=comp,
        chunk_size=chunk, datagen=tdatagen(np.asarray(w_star), batch=BATCH),
        **FLEET)
    return trt.run_simulation_scan(
        cfg, _loss_t, {"w": np.zeros(D_FLEET, np.float32)}, device="cpu")


@pytest.mark.parametrize("comp", ["topk", "qsgd", "scaled_sign"])
def test_kernel_path_matches_reference(comp):
    params, loss_fn, _, w_star = make_linear_problem(d=D_FLEET)
    jcfg = jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1),
                         compression=comp, chunk_size=1024,
                         datagen=jdatagen(w_star, batch=BATCH), **FLEET)
    jp, jl = jrt.run_simulation_scan(jcfg, loss_fn, params)
    launches = (topk_mask.topk_rows.launches, qsgd.qsgd_rows.launches,
                sign_ef.sign_ef_rows.launches)
    tp, tl = _fleet_port(comp, 1024)
    _assert_logs_match(jl, tl)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-4, atol=1e-6)
    # on the CPU the wrappers take the plain versions: nothing launched
    assert launches == (topk_mask.topk_rows.launches,
                        qsgd.qsgd_rows.launches,
                        sign_ef.sign_ef_rows.launches)


def test_chunked_equals_unchunked_bitwise_on_kernel_path():
    cp, cl = _fleet_port("qsgd", 1024)
    up, ul = _fleet_port("qsgd", None)
    assert torch.equal(cp["w"], up["w"])
    for f in ("loss", "latency_s", "participation", "uplink_bits"):
        np.testing.assert_array_equal(getattr(cl, f), getattr(ul, f))
