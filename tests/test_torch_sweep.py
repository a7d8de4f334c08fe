"""The port's ``run_sweep`` against the JAX engine's, on the CPU.

Each reference sweep test of ``tests/test_engine.py``, ``test_faults.py``
and ``test_privacy.py`` runs here as a comparison: the same grid (built on
the JAX side and carried over by ``repro_torch.convert``) through both
packages. Tolerances: the same result keys in the same order, the same log
shapes and types, participation, schedule sizes and uplink bits equal,
latency within rtol 1e-5, loss within rtol 1e-4, epsilon within rtol 1e-5.
The reference runs its variants vmapped; the port runs them one after
another, and its mixture mode is bitwise its loop mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from benchmarks.common import make_linear_problem  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro.core import scheduling as jsched  # noqa: E402
from repro.core import wireless as jwl  # noqa: E402
from repro.core.compression import compression_params  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import wireless as twl  # noqa: E402
from repro_torch.core.hierarchy import HFLConfig  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from test_torch_engine import _loss_t  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401

D = 16
AP01 = jrt.algo_params(lr=0.1)
LOSS_RTOL, LAT_RTOL, EPS_RTOL = 1e-4, 1e-5, 1e-5


def _problem(rounds, n, d=D):
    params, loss_fn, make_batches, _ = make_linear_problem(d=d)
    batches = jrt.stack_batches(make_batches, rounds, n)
    return (params, loss_fn, batches, {"w": np.asarray(params["w"])},
            {k: np.asarray(v) for k, v in batches.items()})


def _tcfg(jcfg):
    """The reference's SimConfig as the port's (its params carried over)."""
    kw = {f: getattr(jcfg, f) for f in (
        "n_devices", "n_scheduled", "rounds", "local_steps", "algorithm",
        "policy", "seed", "model_bits", "comp_latency_s", "deadline_s",
        "age_alpha", "compression", "double_ef", "chunk_size", "ef_mode",
        "ef_slots", "state_dtype", "max_retries", "privacy")}
    for name, conv in (("algo_params", convert.algo_params_from_jax),
                       ("compression_params",
                        convert.compression_params_from_jax),
                       ("faults", convert.fault_params_from_jax),
                       ("privacy_params", convert.privacy_params_from_jax)):
        v = getattr(jcfg, name)
        kw[name] = conv(v) if v is not None else None
    return trt.SimConfig(**kw)


def _twcfg(w):
    return twl.WirelessConfig(**vars(w))


def _port_kw(kw):
    """A reference run_sweep's keyword arguments for the port."""
    out = dict(kw)
    for name, conv in (("cparams_grid", convert.compression_params_from_jax),
                       ("aparams_grid", convert.algo_params_from_jax),
                       ("fparams_grid", convert.fault_params_from_jax),
                       ("pparams_grid", convert.privacy_params_from_jax)):
        if out.get(name) is not None:
            out[name] = [conv(p) for p in out[name]]
    if out.get("wcfgs") is not None:
        out["wcfgs"] = [_twcfg(w) for w in out["wcfgs"]]
    return out


def _sweeps(jcfg, prob, **kw):
    """The same sweep through both packages: (reference, port) results."""
    params, loss_fn, batches, tparams, tbatches = prob
    jout = jrt.run_sweep(jcfg, loss_fn, params, batches, **kw)
    tout = trt.run_sweep(_tcfg(jcfg), _loss_t, tparams, tbatches,
                         device="cpu", **_port_kw(kw))
    return jout, tout


def _assert_sweep_match(jout, tout):
    assert list(tout) == list(jout)
    for key in jout:
        jl, tl = jax.device_get(jout[key]), tout[key]
        for f in trt._LOG_FIELDS:
            j, t = np.asarray(getattr(jl, f)), getattr(tl, f)
            assert (t.shape, t.dtype) == (j.shape, j.dtype), (key, f)
        for f in ("participation", "n_scheduled", "uplink_bits",
                  "downlink_bits", "n_survived", "n_dropped", "mask_bits"):
            np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f),
                                          err_msg=f"{key} {f}")
        np.testing.assert_allclose(tl.latency_s, jl.latency_s,
                                   rtol=LAT_RTOL, err_msg=str(key))
        np.testing.assert_allclose(tl.loss, jl.loss, rtol=LOSS_RTOL,
                                   err_msg=str(key))
        np.testing.assert_allclose(tl.epsilon, jl.epsilon, rtol=EPS_RTOL,
                                   err_msg=str(key))


def _assert_bitwise(a, b):
    assert list(a) == list(b)
    for key in a:
        for f in trt._LOG_FIELDS:
            np.testing.assert_array_equal(getattr(a[key], f),
                                          getattr(b[key], f),
                                          err_msg=f"{key} {f}")


def test_run_sweep_shapes_and_determinism():
    rounds, n = 5, 8
    prob = _problem(rounds, n)
    cfg = jrt.SimConfig(n_devices=n, n_scheduled=3, rounds=rounds,
                        algo_params=AP01, policy="random")
    wcfgs = [jwl.WirelessConfig(n_devices=n),
             jwl.WirelessConfig(n_devices=n, tx_power_dbm=20.0)]
    kw = dict(seeds=[0, 1, 2, 3], wcfgs=wcfgs,
              policies=["random", "best_channel"])
    jout, tout = _sweeps(cfg, prob, **kw)
    _assert_sweep_match(jout, tout)
    v = 4 * len(wcfgs)
    assert tout["random"].participation.shape == (v, rounds, n)
    # deterministic, and variant 0 is the single run of seed 0
    again = trt.run_sweep(_tcfg(cfg), _loss_t, prob[3], prob[4],
                          device="cpu", **_port_kw(kw))
    _assert_bitwise(tout, again)
    assert (tout["random"].participation[0]
            != tout["random"].participation[2]).any()
    _, single = trt.run_simulation_scan(_tcfg(cfg), _loss_t, prob[3],
                                        prob[4], wcfg=_twcfg(wcfgs[0]),
                                        device="cpu")
    for f in trt._LOG_FIELDS:
        np.testing.assert_array_equal(getattr(tout["random"], f)[0],
                                      getattr(single, f))


def test_sweep_rejects_mixed_static_fields():
    prob = _problem(2, 8)
    cfg = jrt.SimConfig(n_devices=8, n_scheduled=3, rounds=2,
                        algo_params=AP01)
    mixed = [jwl.WirelessConfig(n_devices=8),
             jwl.WirelessConfig(n_devices=8, n_subchannels=4)]
    bw = [jwl.WirelessConfig(n_devices=8),
          jwl.WirelessConfig(n_devices=8, bandwidth_hz=1e7)]
    for wcfgs, pols, match in ((mixed, None, "static fields"),
                               (bw, ["age"], "bandwidth_hz")):
        for rt_, cfg_, loss, p, b, kw in (
                (jrt, cfg, prob[1], prob[0], prob[2], {}),
                (trt, _tcfg(cfg), _loss_t, prob[3], prob[4],
                 dict(device="cpu"))):
            w = wcfgs if rt_ is jrt else [_twcfg(x) for x in wcfgs]
            with pytest.raises(ValueError, match=match):
                rt_.run_sweep(cfg_, loss, p, b, seeds=[0], wcfgs=w,
                              policies=pols, **kw)
    # bandwidth varies per variant under the other policies: the static
    # sub-band comes from wcfgs[0], each variant's rate from its channel
    _assert_sweep_match(*_sweeps(cfg, prob, seeds=[0], wcfgs=bw,
                                 policies=["random", "latency"]))


def test_sweep_wcfg_grid_varies_power_and_radius():
    n = 8
    prob = _problem(4, n)
    cfg = jrt.SimConfig(n_devices=n, n_scheduled=3, rounds=4,
                        algo_params=AP01, model_bits=32.0 * D,
                        compression="topk",
                        compression_params=compression_params(k=4))
    wcfgs = [jwl.WirelessConfig(n_devices=n, tx_power_dbm=p,
                                cell_radius_m=r)
             for p, r in ((10.0, 500.0), (-5.0, 500.0), (20.0, 250.0))]
    jout, tout = _sweeps(cfg, prob, seeds=[1, 2], wcfgs=wcfgs,
                         policies=["best_channel", "latency", "deadline"])
    _assert_sweep_match(jout, tout)
    lat = tout["latency"].latency_s
    assert not np.allclose(lat[0], lat[1])  # power moves the clock


def test_sweep_compression_axis_one_trace_per_pair():
    rounds, n = 4, 8
    prob = _problem(rounds, n)
    cfg = jrt.SimConfig(n_devices=n, n_scheduled=3, rounds=rounds,
                        algo_params=AP01, model_bits=32.0 * D)
    kw = dict(seeds=[0, 1],
              wcfgs=[jwl.WirelessConfig(n_devices=n),
                     jwl.WirelessConfig(n_devices=n, tx_power_dbm=20.0)],
              policies=["random", "best_channel"],
              compressions=["none", "topk", "qsgd"],
              cparams_grid=[compression_params(k=2, levels=4),
                            compression_params(k=8, levels=64)])
    before = trt.ENGINE_STATS["traces"]
    jout, tout = _sweeps(cfg, prob, **kw)
    assert trt.ENGINE_STATS["traces"] - before == 3  # one per name
    _assert_sweep_match(jout, tout)
    ub = tout[("random", "topk")].uplink_bits
    assert (ub[0::2] < ub[1::2]).all()
    tkw = _port_kw(kw)
    trt.run_sweep(_tcfg(cfg), _loss_t, prob[3], prob[4], device="cpu", **tkw)
    assert trt.ENGINE_STATS["traces"] - before == 3  # warm: no new trace
    loop = trt.run_sweep(_tcfg(cfg), _loss_t, prob[3], prob[4],
                         device="cpu", policy_mode="loop", **tkw)
    assert trt.ENGINE_STATS["traces"] - before == 3 + 2 * 3
    _assert_bitwise(tout, {k: loop[k] for k in tout})


def test_sweep_traces_match_reference_cold():
    """With both engine caches cleared, a sweep bumps the port's counter
    as often as the reference traces, in mixture and in loop mode."""
    prob = _problem(3, 8)
    cfg = jrt.SimConfig(n_devices=8, n_scheduled=3, rounds=3,
                        algo_params=AP01, compression="topk")
    for mode in ("mixture", "loop"):
        for seeds in ([0], [0, 1], [0]):
            jrt._ENGINE_CACHE.clear()
            trt._ENGINE_CACHE.clear()
            j0, t0 = jrt.ENGINE_STATS["traces"], trt.ENGINE_STATS["traces"]
            _sweeps(cfg, prob, seeds=seeds, policies=["random", "pf"],
                    compressions=["topk", "none"], policy_mode=mode)
            assert (trt.ENGINE_STATS["traces"] - t0
                    == jrt.ENGINE_STATS["traces"] - j0)


def test_policy_mixture_matches_reference_and_port_loop():
    """Every registry policy: the port's mixture against the reference's
    mixture, its loop against the reference's loop, and its mixture
    bitwise its loop (the reference's two modes may differ by an ulp)."""
    rounds, n = 5, 8
    prob = _problem(rounds, n)
    cfg = jrt.SimConfig(n_devices=n, n_scheduled=3, rounds=rounds,
                        algo_params=AP01, model_bits=32.0 * D,
                        compression="topk")
    kw = dict(seeds=[2, 5], policies=list(jsched.policy_names()))
    jmix, tmix = _sweeps(cfg, prob, **kw)
    jloop, tloop = _sweeps(cfg, prob, policy_mode="loop", **kw)
    _assert_sweep_match(jmix, tmix)
    _assert_sweep_match(jloop, tloop)
    _assert_bitwise(tmix, tloop)


@pytest.mark.parametrize("n", [8, 16])
def test_pf_round_zero_ties_match_reference(n):
    """PF at seeds 0-7: in round 0 every score is an SNR over itself. The
    reference's compiled program folds ``(rx / n0) / avg`` into ``rx / (n0
    * avg)``, which lands an ulp off 1 for some devices and so breaks the
    ties; the flat engine hands the policy ``snr_parts`` to score the same
    way."""
    rounds = 3
    prob = _problem(rounds, n)
    cfg = jrt.SimConfig(n_devices=n, n_scheduled=3, rounds=rounds,
                        algo_params=AP01)
    _assert_sweep_match(*_sweeps(cfg, prob, seeds=list(range(8)),
                                 policies=["pf"]))


def test_sweep_devices_one_degrades_to_single_card():
    rounds, n = 3, 8
    prob = _problem(rounds, n)
    cfg = _tcfg(jrt.SimConfig(n_devices=n, n_scheduled=3, rounds=rounds,
                              algo_params=AP01))
    kw = dict(seeds=[0, 1], policies=["random", "pf"], device="cpu")
    ref = trt.run_sweep(cfg, _loss_t, prob[3], prob[4], **kw)
    for devices in (1, "auto", [torch.device("cpu")]):
        _assert_bitwise(ref, trt.run_sweep(cfg, _loss_t, prob[3], prob[4],
                                           devices=devices, **kw))
    with pytest.raises(ValueError, match="devices"):
        trt.run_sweep(cfg, _loss_t, prob[3], prob[4], devices=10_000, **kw)
    # more than one member needs a process group of as many
    # (tests/test_torch_cluster_sweep.py runs one)
    with pytest.raises(RuntimeError, match="process group of 2 members"):
        trt.run_sweep(cfg, _loss_t, prob[3], prob[4],
                      devices=[torch.device("cpu")] * 2, **kw)
    with pytest.raises(ValueError, match="1-D mesh"):
        trt.run_sweep(cfg, _loss_t, prob[3], prob[4],
                      mesh=Mesh((2, 2), ("a", "b"), bind=False), **kw)
    with pytest.raises(ValueError, match="not both"):
        trt.run_sweep(cfg, _loss_t, prob[3], prob[4], devices=1,
                      mesh=Mesh((1,), ("variants",)), **kw)
    h = HFLConfig(n_clusters=3, inter_cluster_period=3)
    with pytest.raises(ValueError, match="pass hcfg= or hcfgs=, not both"):
        trt.run_sweep(cfg, _loss_t, prob[3], prob[4], hcfg=h, hcfgs=[h],
                      **kw)


def test_sweep_argument_errors_match_reference():
    prob = _problem(2, 8)
    cfg = jrt.SimConfig(n_devices=8, n_scheduled=3, rounds=2,
                        algo_params=AP01)
    cases = [(dict(seeds=[]), "at least one"),
             (dict(seeds=[0], fparams_grid=[]), "fparams_grid"),
             (dict(seeds=[0], privacies=[]), "privacies"),
             (dict(seeds=[0], privacies=["dp"], pparams_grid=[]),
              "pparams_grid"),
             (dict(seeds=[0], policy_mode="bogus"), "policy_mode")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            jrt.run_sweep(cfg, prob[1], prob[0], prob[2], **kw)
        with pytest.raises(ValueError, match=match):
            trt.run_sweep(_tcfg(cfg), _loss_t, prob[3], prob[4],
                          device="cpu", **kw)


def test_fault_grid_sweep_zero_retraces_warm():
    rounds, n = 5, 8
    prob = _problem(rounds, n)
    fgrid = [jfaults.fault_params(drop_prob=p) for p in (0.0, 0.2, 0.5, 0.9)]
    cfg = jrt.SimConfig(n_devices=n, n_scheduled=3, rounds=rounds,
                        algo_params=AP01, seed=7, faults=fgrid[0])
    kw = dict(seeds=[0, 1], policies=["random", "best_channel"],
              fparams_grid=fgrid)
    jout, tout = _sweeps(cfg, prob, **kw)
    _assert_sweep_match(jout, tout)
    before = trt.ENGINE_STATS["traces"]
    again = trt.run_sweep(_tcfg(cfg), _loss_t, prob[3], prob[4],
                          device="cpu", **_port_kw(kw))
    assert trt.ENGINE_STATS["traces"] == before
    _assert_bitwise(tout, again)
    surv = tout["random"].n_survived.reshape(2, 4, rounds).mean(axis=2)
    assert (surv[:, 0] > surv[:, -1]).all()


def test_sweep_mixes_none_with_mechanisms():
    prob = _problem(4, 8)
    cfg = jrt.SimConfig(n_devices=8, n_scheduled=3, rounds=4,
                        algo_params=AP01, seed=7)
    jout, tout = _sweeps(
        cfg, prob, seeds=[0, 3], privacies=["none", "dp", "secagg_dp"],
        pparams_grid=[jpriv.privacy_params(clip=1.0, sigma=1.0),
                      jpriv.privacy_params(clip=0.5, sigma=0.6)])
    _assert_sweep_match(jout, tout)
    assert np.isinf(tout[("random", "none")].epsilon).all()
    assert np.isfinite(tout[("random", "dp")].epsilon).all()


def test_sweep_algorithm_axis_with_faults_and_eval_batch():
    """The algorithm name axis and an eval batch, under faults with a
    decode threshold, clear of it by more than an ulp of the fading."""
    rounds, n = 4, 8
    prob = _problem(rounds, n)
    fp = jfaults.fault_params(drop_prob=0.2, churn_p_off=0.2,
                              churn_p_on=0.6, snr_min=2.0, fading_rho=0.5)
    cfg = jrt.SimConfig(n_devices=n, n_scheduled=3, rounds=rounds, seed=3,
                        faults=fp, max_retries=1, compression="topk",
                        compression_params=compression_params(k=4))
    assert _snr_margin(cfg, [0, 1]) > 1e-5
    eval_batch = {k: v[0, 0] for k, v in prob[2].items()}
    params, loss_fn, batches, tparams, tbatches = prob
    kw = dict(seeds=[0, 1], policies=["random", "pf"],
              algorithms=["fedavg", "scaffold", "fedbuff"],
              aparams_grid=[AP01, jrt.algo_params(lr=0.05)])
    jout = jrt.run_sweep(cfg, loss_fn, params, batches,
                         eval_batch=eval_batch, **kw)
    tout = trt.run_sweep(_tcfg(cfg), _loss_t, tparams, tbatches,
                         eval_batch={k: np.asarray(v)
                                     for k, v in eval_batch.items()},
                         device="cpu", **_port_kw(kw))
    _assert_sweep_match(jout, tout)


def _snr_margin(cfg, seeds):
    """The reference's smallest ``|snr / snr_min - 1|`` over the rounds'
    Gauss-Markov draws and retries of every seed (default channel)."""
    n, fp = cfg.n_devices, cfg.faults
    chan = jwl.channel_params(jwl.WirelessConfig(n_devices=n))
    worst = np.inf
    for seed in seeds:
        k_pos, k_rounds = jax.random.split(jax.random.PRNGKey(seed))
        dist = jwl.sample_positions_jax(k_pos, chan, n)
        fad = jax.numpy.zeros((n, 2))
        for t in range(cfg.rounds):
            kt = jax.random.fold_in(k_rounds, t)
            fad, power = jfaults.gauss_markov_fading(fp, kt, fad, t)
            draws = [power] + [jfaults.retry_fading(kt, r, n)
                               for r in range(1, cfg.max_retries + 1)]
            for p in draws:
                snr = np.asarray(jwl.snr_jax(dist, p, chan))
                worst = min(worst, float(np.abs(snr / float(fp.snr_min)
                                                - 1.0).min()))
    return worst


def test_sweep_on_kernel_row_path():
    """N = 32768, d = 32 (N * D = 2^20): client rows reach the row
    kernels' plain versions, in blocks of 4096, on-device data."""
    from repro.data import make_linear_datagen as jdatagen
    from repro_torch.data import make_linear_datagen as tdatagen

    n, d = 32768, 32
    params, loss_fn, _, w_star = make_linear_problem(d=d)
    kw = dict(n_devices=n, n_scheduled=64, rounds=1, local_steps=2,
              chunk_size=4096, compression="topk", seed=20)
    jcfg = jrt.SimConfig(algo_params=AP01,
                         datagen=jdatagen(w_star, batch=2), **kw)
    tcfg = dataclasses.replace(_tcfg(jcfg),
                               datagen=tdatagen(np.asarray(w_star), batch=2))
    sw = dict(seeds=[0], policies=["random", "best_channel"])
    jout = jrt.run_sweep(jcfg, loss_fn, params, None, **sw)
    tout = trt.run_sweep(tcfg, _loss_t, {"w": np.asarray(params["w"])},
                         None, device="cpu", **sw)
    _assert_sweep_match(jout, tout)

