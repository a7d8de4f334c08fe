"""The port's host loop, ``run_simulation(engine="host")``, against the
JAX engine's host loop on the CPU, and against the port's own scan.

The host loop samples each round's batches as it starts and logs an opaque
``eval_fn(params)`` as the loss; it runs the scan's own step, so on the port
it equals the scan bit for bit. Against the reference's host loop:
participation, schedule sizes, survivors, drops, retransmissions and mask
and uplink bits equal (also to the reference's scan), latency within rtol
1e-5, loss within rtol 1e-4, epsilon within rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from benchmarks.common import make_linear_problem  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro.core.compression import compression_params  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from test_torch_engine import _loss_t  # noqa: E402
from test_torch_sweep import _snr_margin, _tcfg  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401

D = 16
AP01 = jrt.algo_params(lr=0.1)
FAULTS = jfaults.fault_params(drop_prob=0.3, churn_p_off=0.2,
                              churn_p_on=0.6, straggler_prob=0.3,
                              straggler_alpha=1.5, snr_min=2.0,
                              fading_rho=0.7)


def _cfg(**kw):
    kw.setdefault("n_devices", 8)
    kw.setdefault("n_scheduled", 3)
    kw.setdefault("rounds", 8)
    kw.setdefault("algo_params", AP01)
    kw.setdefault("policy", "random")
    kw.setdefault("seed", 7)
    return jrt.SimConfig(**kw)


def _runs(jcfg, eval_fns=(None, None)):
    """(reference host, port host, port scan, reference scan) round logs;
    no scans with an opaque ``eval_fn``."""
    params, loss_fn, make_batches, _ = make_linear_problem(d=D)
    tparams = {"w": np.asarray(params["w"])}
    tcfg = _tcfg(jcfg)
    jev, tev = eval_fns
    jh = jrt.run_simulation(jcfg, loss_fn, params, make_batches,
                            eval_fn=jev, engine="host")
    th = trt.run_simulation(tcfg, _loss_t, tparams, make_batches,
                            eval_fn=tev, engine="host", device="cpu")
    if tev is not None:
        return jh, th, None, None
    ts = trt.run_simulation(tcfg, _loss_t, tparams, make_batches,
                            engine="scan", device="cpu")
    js = jrt.run_simulation(jcfg, loss_fn, params, make_batches,
                            engine="scan")
    return jh, th, ts, js


def _assert_host_match(jh, th, ts=None, js=None):
    assert len(th) == len(jh) == jh[-1].round + 1
    for j, t in zip(jh, th):
        np.testing.assert_array_equal(t.participation, j.participation)
        for f in ("round", "n_scheduled", "n_survived", "n_dropped",
                  "retransmissions", "mask_bits", "downlink_bits"):
            assert getattr(t, f) == getattr(j, f), f
            assert type(getattr(t, f)) is type(getattr(j, f)), f
        assert t.uplink_bits == j.uplink_bits
        np.testing.assert_allclose(t.latency_s, j.latency_s, rtol=1e-5)
        np.testing.assert_allclose(t.loss, j.loss, rtol=1e-4)
        np.testing.assert_allclose(t.staleness_mean, j.staleness_mean,
                                   rtol=1e-5)
        np.testing.assert_allclose(t.epsilon, j.epsilon, rtol=1e-5)
        assert t.delta == j.delta
    if ts is not None:  # the port's host loop is its scan, bit for bit
        for t, s in zip(th, ts):
            for f, v in vars(t).items():
                np.testing.assert_array_equal(v, getattr(s, f), err_msg=f)
    if js is not None:
        assert [t.uplink_bits for t in th] == [j.uplink_bits for j in js]


@pytest.mark.parametrize("policy", ["random", "round_robin"])
def test_scan_host_parity(policy):
    _assert_host_match(*_runs(_cfg(rounds=12, policy=policy, seed=5)))


@pytest.mark.parametrize("compression", ["topk", "qsgd", "scaled_sign"])
def test_scan_host_parity_with_compression(compression):
    _assert_host_match(*_runs(_cfg(
        compression=compression, model_bits=32.0 * D,
        compression_params=compression_params(k=3, levels=8))))


def test_eval_batch_inside_scan_matches_host_eval_fn():
    """An opaque ``eval_fn`` sends the run to the host loop, whose logged
    loss is ``eval_fn(params)``: the in-program ``eval_batch`` loss of the
    scan, and the reference's."""
    params, loss_fn, make_batches, _ = make_linear_problem(d=D)
    eval_batch = jax.tree.map(lambda x: x[0], make_batches(999, 2))
    tev_batch = {k: torch.tensor(np.asarray(v))
                 for k, v in eval_batch.items()}

    def jeval(p):
        return float(loss_fn(p, eval_batch)[0])

    def teval(p):
        return float(_loss_t(p, tev_batch)[0])

    jcfg = _cfg(rounds=6, policy="round_robin", seed=2)
    _assert_host_match(*_runs(jcfg, (jeval, teval)))
    teval.eval_batch = {k: np.asarray(v) for k, v in eval_batch.items()}
    compiled = trt.run_simulation(_tcfg(jcfg), _loss_t,
                                  {"w": np.asarray(params["w"])},
                                  make_batches, eval_fn=teval, device="cpu")
    del teval.eval_batch
    opaque = trt.run_simulation(_tcfg(jcfg), _loss_t,
                                {"w": np.asarray(params["w"])},
                                make_batches, eval_fn=teval, device="cpu")
    for c, h in zip(compiled, opaque):
        assert c.loss == h.loss
        np.testing.assert_array_equal(c.participation, h.participation)


@pytest.mark.parametrize("algorithm,compression",
                         [("fedavg", "none"), ("scaffold", "topk"),
                          ("fedbuff", "none")])
def test_scan_host_parity_with_faults(algorithm, compression):
    jcfg = _cfg(algorithm=algorithm, compression=compression,
                faults=FAULTS, max_retries=2)
    assert _snr_margin(jcfg, [jcfg.seed]) > 1e-5
    _assert_host_match(*_runs(jcfg))


@pytest.mark.parametrize("privacy", ["dp", "secagg_dp"])
def test_scan_host_parity_with_privacy(privacy):
    _assert_host_match(*_runs(_cfg(
        rounds=6, privacy=privacy,
        privacy_params=jpriv.privacy_params(clip=1.0, sigma=0.8))))


def test_host_loop_on_datagen_and_zero_rounds():
    """With ``SimConfig.datagen`` the host loop makes batches on the device
    as the scan does; zero rounds log nothing."""
    from repro.data import make_linear_datagen as jdatagen
    from repro_torch.data import make_linear_datagen as tdatagen

    params, loss_fn, _, w_star = make_linear_problem(d=D)
    jcfg = _cfg(rounds=4, datagen=jdatagen(w_star))
    tcfg = _tcfg(jcfg)
    tcfg.datagen = tdatagen(np.asarray(w_star))
    jh = jrt.run_simulation(jcfg, loss_fn, params, None, engine="host")
    js = jrt.run_simulation(jcfg, loss_fn, params, None)
    tparams = {"w": np.asarray(params["w"])}
    th = trt.run_simulation(tcfg, _loss_t, tparams, None, engine="host",
                            device="cpu")
    ts = trt.run_simulation(tcfg, _loss_t, tparams, None, device="cpu")
    _assert_host_match(jh, th, ts, js)
    tcfg.rounds = 0
    assert trt.run_simulation(tcfg, _loss_t, tparams, None,
                              engine="host", device="cpu") == []
