"""The port's hierarchical engine against the JAX engine, on the CPU.

(a) ``core/hierarchy.py``: the hex deployment for seeds 0-4 x N in {12, 21,
    1000} x L in {1, 3, 7}, ``hex_centers``, the three averages and
    ``hfl_round_latency``; ``wireless.gather_channel_params``.
(b) ``run_hfl`` on ``make_linear_problem(d=16)`` at N = 12 and
    ``HFLConfig(3, 3)`` for 9 rounds (the reference's own HFL cell, seed 3)
    over policies x compressors, the four HFL algorithms, per-cluster
    budgets and cells, faults and privacy; the bench's LM cell (N = 21, D =
    5120, 7 clusters) for 6 rounds.
(c) Inside the port: scan == host loop bitwise, secagg == its unmasked
    oracle bitwise.
(d) ``run_sweep(hcfg=, hcfgs=)`` per variant, with the reference's trace
    counts, and the engine's argument errors.

Tolerances: geometry ``cluster_ids``, ``member`` and sizes equal, ``dist``
within rtol 1e-6 (the reference's nearest and second-nearest SBS are more
than 1e-3 m apart at every seed here, so an ulp cannot move a device);
participation, schedule sizes, uplink, downlink and mask bits, survivors,
drops and retransmissions equal; latency within rtol 1e-5, loss within rtol
1e-4, epsilon within rtol 1e-5, final params within atol 1e-5.

Seeds: 3 (the reference's HFL tests) everywhere except secagg x QSGD, which
runs at seed 1. QSGD's stochastic rounding steps a coordinate by a whole
level where the rounding fraction lies within an ulp of the dither, and the
two packages' models differ by ulps (reduction orders; the reference's
field scale is a few ulps low, ROADMAP queue C): secagg x QSGD flips one in
the last round at seeds 0, 3 and 7, and best_channel x QSGD one in round 5
at seed 3, moving the loss by 1e-4 to 1e-3; QSGD runs here under random
scheduling at seed 3 and under secagg at seed 1, where none flips. Fault runs assert the reference's smallest
``|snr / snr_min - 1|`` over every draw exceeds 1e-5.

Under faults the reference's compiled step sums QSGD's non-integer price in
an order its vectorizer picks per program, so there the uplink bits are
held to within 2 ulp (``test_faults_qsgd_uplink_bits_within_two_ulp``,
ROADMAP queue C6); every integer-valued price (none, top-k and scaled sign
at d = 16, field and mask bits) is held equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from benchmarks.common import make_linear_problem, make_lm_problem  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import hierarchy as jh  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro.core import wireless as jwl  # noqa: E402
from repro.core.compression import compression_params  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import hierarchy as th  # noqa: E402
from repro_torch.core import wireless as twl  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from test_torch_engine import _loss_t  # noqa: E402
from test_torch_sweep import _port_kw, _tcfg, _twcfg  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401

D, N, ROUNDS, SEED = 16, 12, 9, 3
HCFG = jh.HFLConfig(n_clusters=3, inter_cluster_period=3)
AP01 = jrt.algo_params(lr=0.1)
FAULTS = jfaults.fault_params(drop_prob=0.2, churn_p_off=0.05,
                              churn_p_on=0.5, straggler_prob=0.1,
                              straggler_alpha=1.5, snr_min=1.0,
                              fading_rho=0.5)
PP = jpriv.privacy_params(clip=0.5, sigma=0.3)
LOSS_RTOL, LAT_RTOL, EPS_RTOL = 1e-4, 1e-5, 1e-5
EXACT = ("participation", "n_scheduled", "uplink_bits", "downlink_bits",
         "n_survived", "n_dropped", "retransmissions", "mask_bits", "delta")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _keep_engine_caches():
    """Leave both packages' engine caches as each test found them: the
    reference's own tests count the traces a first call makes."""
    saved = (dict(jrt._ENGINE_CACHE),
             {k: set(v) for k, v in trt._ENGINE_CACHE.items()})
    yield
    for cache, old in zip((jrt._ENGINE_CACHE, trt._ENGINE_CACHE), saved):
        cache.clear()
        cache.update(old)


def _cfg(**kw):
    kw.setdefault("n_devices", N)
    kw.setdefault("n_scheduled", 3)
    kw.setdefault("rounds", ROUNDS)
    kw.setdefault("algo_params", AP01)
    kw.setdefault("policy", "best_channel")
    kw.setdefault("seed", SEED)
    kw.setdefault("model_bits", 32.0 * D)
    return jrt.SimConfig(**kw)


def _linear(rounds=ROUNDS, n=N):
    params, loss_fn, make_batches, _ = make_linear_problem(d=D)
    return params, loss_fn, make_batches, jrt.stack_batches(make_batches,
                                                            rounds, n)


def _np(tree):
    return None if tree is None else {k: np.asarray(v)
                                      for k, v in tree.items()}


def _ref_scan(jcfg, h, loss_fn, params, batches, eval_batch=None,
              cluster_wcfgs=None):
    """The reference's compiled HFL engine: (final params, SimLogs)."""
    wstat, chan = jrt._resolve_hfl_channel(jcfg, h, None, cluster_wcfgs)
    eng = jrt._get_hfl_engine(jcfg, h, wstat, loss_fn, eval_batch is not None)
    extra = ((jcfg.faults,) if jcfg.faults is not None else ()) + (
        (jrt._resolve_pparams(jcfg),) if jcfg.privacy != "none" else ())
    final, outs = eng(jax.random.PRNGKey(jcfg.seed), chan,
                      jrt._resolve_cparams(jcfg, params),
                      jrt._resolve_aparams(jcfg),
                      jnp.float32(h.backhaul_rate_bps), *extra, params,
                      batches, eval_batch)
    logs = dict(zip(trt._LOG_FIELDS, jax.device_get(outs)))
    return final, jrt.SimLogs(**logs)


def _port_scan(jcfg, h, loss_fn, params, batches, eval_batch=None,
               cluster_wcfgs=None):
    """The same run through the port's engine on the CPU."""
    tcfg = _tcfg(jcfg)
    th_ = convert.hfl_config_from_jax(h)
    wstat, chan = trt._resolve_hfl_channel(
        tcfg, th_, None,
        [_twcfg(w) for w in cluster_wcfgs] if cluster_wcfgs else None, CPU)
    return trt._run_hfl_scan(tcfg, th_, loss_fn, _np(params), _np(batches),
                             _np(eval_batch), chan, wstat, CPU)


def _assert_logs(jl, tl, ubits_ulp=0):
    for f in EXACT:
        if f == "uplink_bits" and ubits_ulp:
            np.testing.assert_array_max_ulp(tl.uplink_bits, jl.uplink_bits,
                                            maxulp=ubits_ulp)
            continue
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f),
                                      err_msg=f)
    np.testing.assert_allclose(tl.latency_s, jl.latency_s, rtol=LAT_RTOL)
    np.testing.assert_allclose(tl.loss, jl.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl.staleness_mean, jl.staleness_mean,
                               rtol=1e-6)
    np.testing.assert_array_equal(np.isinf(tl.epsilon), np.isinf(jl.epsilon))
    fin = np.isfinite(jl.epsilon)
    np.testing.assert_allclose(tl.epsilon[fin], jl.epsilon[fin],
                               rtol=EPS_RTOL)


def _hfl_snr_margin(jcfg, h, cluster_wcfgs=None):
    """The reference run's smallest ``|snr / snr_min - 1|`` over every
    Gauss-Markov and retry draw of every device."""
    fp = jcfg.faults
    k_geo, k_rounds = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    ids, dist, _, _ = jh.hfl_geometry_jax(k_geo, h, jcfg.n_devices)
    _, chan = jrt._resolve_hfl_channel(jcfg, h, None, cluster_wcfgs)
    chan = jwl.gather_channel_params(chan, ids)
    fad = jnp.zeros((jcfg.n_devices, 2), jnp.float32)
    worst = np.inf
    for t in range(jcfg.rounds):
        kt = jax.random.fold_in(k_rounds, t)
        fad, power = jfaults.gauss_markov_fading(fp, kt, fad, jnp.int32(t))
        for p in [power] + [jfaults.retry_fading(kt, r, jcfg.n_devices)
                            for r in range(1, jcfg.max_retries + 1)]:
            snr = np.asarray(jwl.snr_jax(dist, p, chan))
            worst = min(worst, float(np.abs(snr / float(fp.snr_min)
                                            - 1.0).min()))
    return worst


# ---------------------------------------------------------------------------
# (a) hierarchy.py and gather_channel_params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("n", [12, 21, 1000])
@pytest.mark.parametrize("n_clusters", [1, 3, 7])
def test_geometry_matches_reference(seed, n, n_clusters):
    jhc = jh.HFLConfig(n_clusters=n_clusters)
    jpos, jids, jdist, jmem, jsizes = (
        np.asarray(a) for a in jh.hfl_geometry_xy_jax(
            jax.random.PRNGKey(seed), jhc, n))
    tpos, tids, tdist, tmem, tsizes = th.hfl_geometry_xy_jax(
        trandom.PRNGKey(seed), convert.hfl_config_from_jax(jhc), n)
    if n_clusters > 1:
        centers = jh.hex_centers(n_clusters).astype(np.float32)
        d = np.sort(np.linalg.norm(jpos[:, None] - centers[None], axis=-1),
                    axis=1)
        assert (d[:, 1] - d[:, 0]).min() > 1e-3
    np.testing.assert_array_equal(tids.numpy(), jids)
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tmem.numpy(), jmem)
    np.testing.assert_array_equal(tsizes.numpy(), jsizes)
    np.testing.assert_allclose(tdist.numpy(), jdist, rtol=1e-6)
    np.testing.assert_allclose(tpos.numpy(), jpos, rtol=1e-6, atol=1e-4)
    four = th.hfl_geometry_jax(trandom.PRNGKey(seed),
                               convert.hfl_config_from_jax(jhc), n)
    for a, b in zip(four, (tids, tdist, tmem, tsizes)):
        assert torch.equal(a, b)


def test_hex_centers_and_assignment_match_reference():
    for n_clusters in range(1, 8):
        np.testing.assert_array_equal(th.hex_centers(n_clusters, 300.0),
                                      jh.hex_centers(n_clusters, 300.0))
    for bad in (0, 8):
        with pytest.raises(ValueError, match="7-hex"):
            th.hex_centers(bad)
    pos = np.random.default_rng(0).uniform(-750, 750, (50, 2))
    np.testing.assert_array_equal(
        th.assign_clusters_hex(pos, th.hex_centers()),
        jh.assign_clusters_hex(pos, jh.hex_centers()))
    assert (convert.hfl_config_from_jax(HCFG).static_key()
            == convert.hfl_config_from_jax(dataclasses.replace(
                HCFG, backhaul_rate_bps=1e5)).static_key())


@pytest.mark.parametrize("sizes", [None, (4.0, 0.0, 8.0)])
def test_cluster_averages_match_reference(sizes):
    rng = np.random.default_rng(1)
    models = {"a": rng.normal(size=(12, 3, 2)).astype(np.float32),
              "b": rng.normal(size=(12, 5)).astype(np.float32)}
    ids = np.array([0, 2, 2, 0, 2, 0, 0, 2, 2, 2, 0, 2], np.int32)
    tmodels = convert.params_from_jax(models)
    intra_t = th.intra_cluster_average(tmodels, torch.tensor(ids), 3)
    intra_j = jh.intra_cluster_average(models, jnp.asarray(ids), 3)
    for k in models:
        np.testing.assert_allclose(intra_t[k].numpy(),
                                   np.asarray(intra_j[k]), rtol=1e-6,
                                   atol=1e-7)
    cs_j = None if sizes is None else jnp.asarray(sizes, jnp.float32)
    cs_t = None if sizes is None else torch.tensor(sizes)
    inter_t = th.inter_cluster_average(intra_t, cs_t)
    inter_j = jh.inter_cluster_average(intra_j, cs_j)
    for k in models:
        np.testing.assert_allclose(inter_t[k].numpy(),
                                   np.asarray(inter_j[k]), rtol=1e-6,
                                   atol=1e-7)
    back_t = th.broadcast_to_clients(convert.params_from_jax(intra_j),
                                     torch.tensor(ids))
    back_j = jh.broadcast_to_clients(intra_j, jnp.asarray(ids))
    for k in models:
        np.testing.assert_array_equal(back_t[k].numpy(),
                                      np.asarray(back_j[k]))


@pytest.mark.parametrize("model_bits,rate,h", [(1e8, 1e6, 4), (3.2e5, 2e7, 2),
                                               (1e6, 5e5, 6)])
def test_hfl_round_latency_matches_reference(model_bits, rate, h):
    jcfg = jh.HFLConfig(inter_cluster_period=h, fronthaul_speedup=50.0)
    assert (th.hfl_round_latency(model_bits, rate,
                                 convert.hfl_config_from_jax(jcfg))
            == jh.hfl_round_latency(model_bits, rate, jcfg))


def test_gather_channel_params_matches_reference():
    ws = [jwl.WirelessConfig(n_devices=N, tx_power_dbm=10.0 + c,
                             bandwidth_hz=1e7 * (c + 1)) for c in range(3)]
    ids = np.array([2, 0, 1, 1, 2, 0], np.int32)
    for jc, tc in ((jwl.stack_channel_params(ws),
                    twl.stack_channel_params([_twcfg(w) for w in ws])),
                   (jwl.channel_params(ws[1]),
                    twl.channel_params(_twcfg(ws[1])))):
        jg = jwl.gather_channel_params(jc, jnp.asarray(ids))
        tg = twl.gather_channel_params(tc, torch.tensor(ids))
        for f in twl.ChannelParams._fields:
            np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                          np.asarray(getattr(jg, f)),
                                          err_msg=f)


# ---------------------------------------------------------------------------
# (b) run_hfl against the reference's engine
# ---------------------------------------------------------------------------
CELLS = [5.0, 10.0, 15.0]   # per-cluster tx power (dBm) of the cells case
ENGINE_CASES = {
    "random-topk": dict(policy="random", compression="topk"),
    "round_robin-none": dict(policy="round_robin"),
    "best_channel-scaled_sign": dict(compression="scaled_sign"),
    "pf-topk": dict(policy="pf", compression="topk"),
    "age-none": dict(policy="age"),
    "random-qsgd": dict(policy="random", compression="qsgd"),
    "fedavg_m-topk": dict(policy="random", compression="topk",
                          algorithm="fedavg_m"),
    "fedprox-none": dict(algorithm="fedprox"),
    "scaffold-topk": dict(policy="random", compression="topk",
                          algorithm="scaffold"),
    "scaffold-none": dict(algorithm="scaffold"),
    "tuple-random": dict(policy="random", n_scheduled=(2, 3, 1),
                         compression="topk"),
    "tuple-round_robin": dict(policy="round_robin", n_scheduled=(2, 3, 1)),
    "tuple-pf": dict(policy="pf", n_scheduled=(2, 3, 1)),
    "cells-best_channel": dict(compression="topk", cells=True),
    "cells-age": dict(policy="age", cells=True),
    "faults-none": dict(policy="random", faults=FAULTS, max_retries=2),
    "faults-topk": dict(policy="random", compression="topk", faults=FAULTS,
                        max_retries=2),
    "faults-scaffold": dict(compression="scaled_sign", algorithm="scaffold",
                            faults=FAULTS, max_retries=2),
    "secagg-qsgd": dict(policy="random", compression="qsgd",
                        privacy="secagg", privacy_params=PP, seed=1),
    "secagg-none": dict(policy="random", privacy="secagg",
                        privacy_params=PP),
    "dp-topk": dict(policy="random", compression="topk", privacy="dp",
                    privacy_params=PP),
    "secagg_dp-scaled_sign": dict(policy="random", compression="scaled_sign",
                                  privacy="secagg_dp", privacy_params=PP),
    "secagg-faults": dict(policy="random", privacy="secagg",
                          privacy_params=PP, faults=FAULTS, max_retries=2),
}


def _cells():
    return [jwl.WirelessConfig(n_devices=N, tx_power_dbm=p) for p in CELLS]


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_run_hfl_matches_reference(case):
    kw = dict(ENGINE_CASES[case])
    cells = _cells() if kw.pop("cells", False) else None
    jcfg = _cfg(**kw)
    if jcfg.faults is not None:
        assert _hfl_snr_margin(jcfg, HCFG, cells) > 1e-5
    params, loss_fn, _, batches = _linear()
    jp, jl = _ref_scan(jcfg, HCFG, loss_fn, params, batches,
                       cluster_wcfgs=cells)
    tp, tl = _port_scan(jcfg, HCFG, _loss_t, params, batches,
                        cluster_wcfgs=cells)
    _assert_logs(jl, tl)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               atol=1e-5)
    assert (tl.n_scheduled > 0).any()


def test_faults_qsgd_uplink_bits_within_two_ulp():
    """Everything but the uplink bits exact; those within 2 ulp (the
    reference's compiled sum of QSGD's non-integer price, ROADMAP C6)."""
    jcfg = _cfg(policy="random", compression="qsgd", faults=FAULTS,
                max_retries=2)
    assert _hfl_snr_margin(jcfg, HCFG) > 1e-5
    params, loss_fn, _, batches = _linear()
    _, jl = _ref_scan(jcfg, HCFG, loss_fn, params, batches)
    _, tl = _port_scan(jcfg, HCFG, _loss_t, params, batches)
    _assert_logs(jl, tl, ubits_ulp=2)


def _lm_loss_t(p, b):
    """``benchmarks/common.make_lm_problem``'s loss in PyTorch."""
    h = torch.relu(p["emb"][b["tokens"]] @ p["w1"])
    logits = h @ p["w2"]
    gold = torch.gather(logits, -1, b["labels"][..., None].long())[..., 0]
    return (torch.logsumexp(logits, -1) - gold).mean(), {}


def test_lm_cell_matches_reference():
    """``bench_hfl.py``'s cell (N = 21, D = 5120, 7 clusters, H = 2, top-k
    at 1%, 1e8 model bits) with the example's per-cluster cells, 6 rounds,
    the loss on the eval batch."""
    n, rounds = 21, 6
    params, loss_fn, sample, eval_fn = make_lm_problem(n_clients=n,
                                                       alpha=0.3)
    d = sum(p.size for p in params.values())
    assert d == 5120
    jcfg = jrt.SimConfig(
        n_devices=n, n_scheduled=n, rounds=rounds, algo_params=jrt.algo_params(
            lr=1.0), local_steps=2, policy="random", model_bits=1e8,
        compression="topk", compression_params=compression_params(k=d // 100))
    h = jh.HFLConfig(n_clusters=7, inter_cluster_period=2)
    cells = [jwl.WirelessConfig(n_devices=n, tx_power_dbm=10.0 if c == 0
                                else 15.0) for c in range(7)]
    batches = jrt.stack_batches(sample, rounds, n)
    jp, jl = _ref_scan(jcfg, h, loss_fn, params, batches, eval_fn.eval_batch,
                       cluster_wcfgs=cells)
    tp, tl = _port_scan(jcfg, h, _lm_loss_t, params, batches,
                        eval_fn.eval_batch, cluster_wcfgs=cells)
    _assert_logs(jl, tl)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# (c) inside the port
# ---------------------------------------------------------------------------
def _port_round_logs(jcfg, make_batches, **kw):
    return trt.run_hfl(_tcfg(jcfg), convert.hfl_config_from_jax(HCFG),
                       _loss_t, {"w": np.zeros(D, np.float32)},
                       lambda t, n: _np(make_batches(t, n)), device="cpu",
                       **kw)


def _log_array(logs, f):
    return np.array([getattr(r, f) for r in logs])


@pytest.mark.parametrize("kw", [dict(), dict(compression="topk"),
                                dict(policy="random", compression="qsgd",
                                     faults=FAULTS, max_retries=2),
                                dict(policy="random", privacy="dp",
                                     compression="topk", privacy_params=PP)])
def test_scan_equals_host_bitwise(kw):
    _, _, make_batches, _ = _linear()
    jcfg = _cfg(rounds=4, **kw)
    scan = _port_round_logs(jcfg, make_batches)
    host = _port_round_logs(jcfg, make_batches, engine="host")
    for f in ("participation", "loss", "latency_s", "uplink_bits",
              "downlink_bits", "n_survived", "n_dropped", "retransmissions",
              "epsilon", "mask_bits"):
        np.testing.assert_array_equal(_log_array(host, f),
                                      _log_array(scan, f), err_msg=f)


def test_opaque_eval_fn_takes_the_host_loop():
    """An ``eval_fn`` without ``eval_batch`` gets the population-weighted
    global model each round, on the host loop, as in the reference."""
    params, loss_fn, make_batches, _ = _linear()
    eb = make_batches(99, 8)
    eb = {k: v[:, 0].reshape((-1,) + v.shape[3:]) for k, v in eb.items()}
    teb = {k: torch.tensor(np.asarray(v)) for k, v in eb.items()}
    jcfg = _cfg(rounds=4, compression="topk")
    jlogs = jrt.run_hfl(jcfg, HCFG, loss_fn, params, make_batches,
                        eval_fn=lambda p: float(loss_fn(p, eb)[0]))
    seen = []

    def eval_t(p):
        seen.append(p)
        return float(_loss_t(p, teb)[0])

    tlogs = _port_round_logs(jcfg, make_batches, eval_fn=eval_t)
    assert len(seen) == 4 and set(seen[0]) == {"w"}
    np.testing.assert_allclose(_log_array(tlogs, "loss"),
                               _log_array(jlogs, "loss"), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(_log_array(tlogs, "participation"),
                                  _log_array(jlogs, "participation"))
    with pytest.raises(ValueError, match="in-program eval"):
        _port_round_logs(jcfg, make_batches, eval_fn=eval_t, engine="scan")


def test_secagg_equals_unmasked_oracle_bitwise():
    params, _, _, batches = _linear()
    outs = [_port_scan(_cfg(policy="random", compression="qsgd", privacy=p,
                            privacy_params=PP, seed=1), HCFG, _loss_t,
                       params, batches)
            for p in ("secagg", "_secagg_unmasked")]
    (pm, lm), (pu, lu) = outs
    assert torch.equal(pm["w"], pu["w"])
    np.testing.assert_array_equal(lm.loss, lu.loss)
    assert (lm.mask_bits > 0).all() and (lu.mask_bits == 0).all()


# ---------------------------------------------------------------------------
# (d) run_sweep(hcfg=, hcfgs=), trace counts, argument errors
# ---------------------------------------------------------------------------
def _cold():
    jrt._ENGINE_CACHE.clear()
    trt._ENGINE_CACHE.clear()
    return jrt.ENGINE_STATS["traces"], trt.ENGINE_STATS["traces"]


def _traces(before):
    return (jrt.ENGINE_STATS["traces"] - before[0],
            trt.ENGINE_STATS["traces"] - before[1])


def _sweeps(jcfg, batches, **kw):
    params, loss_fn, _, _ = _linear()
    jout = jrt.run_sweep(jcfg, loss_fn, params, batches, **kw)
    port_kw = _port_kw(kw)
    if port_kw.get("hcfg") is not None:
        port_kw["hcfg"] = convert.hfl_config_from_jax(port_kw["hcfg"])
    if port_kw.get("hcfgs") is not None:
        port_kw["hcfgs"] = [convert.hfl_config_from_jax(h)
                            for h in port_kw["hcfgs"]]
    tout = trt.run_sweep(_tcfg(jcfg), _loss_t, {"w": np.zeros(D, np.float32)},
                         _np(batches), device="cpu", **port_kw)
    assert list(tout) == list(jout)
    for key in jout:
        _assert_logs(jax.device_get(jout[key]), tout[key])
    return tout


def test_sweep_one_trace_per_name_tuple():
    """The reference's 2 x 2 x 2 name grid: 8 traces, none on a repeat."""
    rounds = 2
    _, _, make_batches, _ = _linear()
    batches = jrt.stack_batches(make_batches, rounds, N)
    cfg = jrt.SimConfig(n_devices=N, n_scheduled=3, rounds=rounds,
                        algo_params=AP01, model_bits=32.0 * D)
    kw = dict(seeds=[0, 1], policies=["random", "best_channel"],
              compressions=["none", "topk"],
              cparams_grid=[compression_params(k=2), compression_params(k=8)],
              algorithms=["fedavg", "fedprox"], hcfg=HCFG)
    before = _cold()
    out = _sweeps(cfg, batches, **kw)
    assert _traces(before) == (8, 8)
    ub = out["random", "topk", "fedavg"].uplink_bits.reshape(2, 2, rounds)
    assert (ub[:, 0] < ub[:, 1]).all()   # k = 2 bills less than k = 8
    _sweeps(cfg, batches, **kw)
    assert _traces(before) == (8, 8)


def test_sweep_backhaul_grid_and_run_hfl_rates_share_one_trace():
    rounds = 6
    params, loss_fn, make_batches, _ = _linear()
    batches = jrt.stack_batches(make_batches, rounds, N)
    cfg = jrt.SimConfig(n_devices=N, n_scheduled=3, rounds=rounds,
                        algo_params=AP01, policy="best_channel",
                        model_bits=32.0 * D)
    before = _cold()
    out = _sweeps(cfg, batches, seeds=[0, 1], hcfgs=[
        dataclasses.replace(HCFG, backhaul_rate_bps=r) for r in (1e5, 1e9)])
    assert _traces(before) == (1, 1)
    lat = out["best_channel"].latency_s[:, -1].reshape(2, 2)
    assert (lat[:, 0] > lat[:, 1]).all()
    _sweeps(cfg, batches, seeds=[0, 1], hcfgs=[
        dataclasses.replace(HCFG, backhaul_rate_bps=r) for r in (2e6, 5e6)])
    assert _traces(before) == (1, 1)
    # run_hfl across backhaul rates: one engine, no new trace
    jcfg = _cfg(rounds=rounds)
    tcfg = _tcfg(jcfg)
    logs = {}
    for rate in (1e5, 1e9):
        h = dataclasses.replace(HCFG, backhaul_rate_bps=rate)
        if rate == 1e9:
            before = (jrt.ENGINE_STATS["traces"], trt.ENGINE_STATS["traces"])
        jrt.run_hfl(jcfg, h, loss_fn, params, make_batches)
        logs[rate] = trt.run_hfl(tcfg, convert.hfl_config_from_jax(h),
                                 _loss_t, _np(params),
                                 lambda t, n: _np(make_batches(t, n)),
                                 device="cpu")
    assert _traces(before) == (0, 0)
    assert logs[1e5][-1].latency_s > logs[1e9][-1].latency_s
    # the host loop counts none
    trt.run_hfl(tcfg, convert.hfl_config_from_jax(HCFG), _loss_t,
                _np(params), lambda t, n: _np(make_batches(t, n)),
                engine="host", device="cpu")
    assert trt.ENGINE_STATS["traces"] - before[1] == 0


def test_sweep_faults_privacy_seeds_match_reference():
    """Seeds (each its own deployment) x a dropout grid x privacy none and
    dp, every variant against the reference's."""
    rounds = 3
    _, _, make_batches, _ = _linear()
    batches = jrt.stack_batches(make_batches, rounds, N)
    cfg = jrt.SimConfig(n_devices=N, n_scheduled=2, rounds=rounds,
                        algo_params=AP01, compression="topk", seed=SEED,
                        model_bits=32.0 * D)
    out = _sweeps(cfg, batches, seeds=[0, 1, 2], policies=["random"],
                  fparams_grid=[jfaults.fault_params(drop_prob=p)
                                for p in (0.1, 0.4)],
                  privacies=["none", "dp"], pparams_grid=[PP], hcfg=HCFG)
    p = out["random", "none"].participation
    assert (p[0] != p[2]).any() or (p[0] != p[4]).any()


def _cells_with(i, **kw):
    """CELLS' configs with cell ``i`` changed by ``kw``."""
    return [jwl.WirelessConfig(n_devices=N, tx_power_dbm=p,
                               **(kw if c == i else {}))
            for c, p in enumerate(CELLS)]


# name: (SimConfig fields, run_hfl keywords from a WirelessConfig converter,
# the error's text)
ERROR_CASES = {
    "slowmo": (dict(algorithm="slowmo"), None, "client-side algorithms"),
    "fedadam": (dict(algorithm="fedadam"), None, "client-side algorithms"),
    "fedbuff": (dict(algorithm="fedbuff"), None, "client-side algorithms"),
    "double_ef": (dict(compression="topk", double_ef=True), None,
                  "double_ef"),
    "chunk_size": (dict(chunk_size=4), None, "fleet-scale"),
    "sparse_ef": (dict(compression="topk", ef_mode="sparse"), None,
                  "fleet-scale"),
    "bf16": (dict(state_dtype="bfloat16"), None, "fleet-scale"),
    "tuple_len": (dict(n_scheduled=(2, 3)), None, "one budget per cluster"),
    "engine": ({}, lambda w: dict(engine="bogus"), "unknown engine"),
    "both_channels": ({}, lambda w: dict(
        wcfg=w(jwl.WirelessConfig(n_devices=N)),
        cluster_wcfgs=[w(c) for c in _cells()]), "not both"),
    "cells_count": ({}, lambda w: dict(
        cluster_wcfgs=[w(c) for c in _cells()[:2]]), "one WirelessConfig"),
    "cells_static": ({}, lambda w: dict(cluster_wcfgs=[
        w(c) for c in _cells_with(1, n_subchannels=10)]), "static fields"),
    "cells_age_bw": (dict(policy="age"), lambda w: dict(cluster_wcfgs=[
        w(c) for c in _cells_with(2, bandwidth_hz=1e7)]), "bandwidth_hz"),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_argument_errors_match_reference(case):
    cfg_kw, call_kw, match = ERROR_CASES[case]
    call_kw = call_kw or (lambda w: {})
    params, loss_fn, make_batches, _ = _linear(rounds=2)
    jcfg = _cfg(rounds=2, **cfg_kw)
    with pytest.raises(ValueError, match=match):
        jrt.run_hfl(jcfg, HCFG, loss_fn, params, make_batches,
                    **call_kw(lambda w: w))
    with pytest.raises(ValueError, match=match):
        trt.run_hfl(_tcfg(jcfg), convert.hfl_config_from_jax(HCFG), _loss_t,
                    _np(params), lambda t, n: _np(make_batches(t, n)),
                    device="cpu", **call_kw(_twcfg))


def test_zero_rounds_and_sweep_hcfg_errors():
    params, loss_fn, make_batches, batches = _linear(rounds=2)
    th_ = convert.hfl_config_from_jax(HCFG)
    assert trt.run_hfl(_tcfg(_cfg(rounds=0)), th_, _loss_t, _np(params),
                       make_batches, device="cpu") == []
    assert jrt.run_hfl(_cfg(rounds=0), HCFG, loss_fn, params,
                       make_batches) == []
    tcfg = _tcfg(_cfg(rounds=2))
    mixed = [HCFG, dataclasses.replace(HCFG, n_clusters=2)]
    for jkw, match in ((dict(hcfg=HCFG, hcfgs=[HCFG]), "hcfg"),
                       (dict(hcfgs=mixed), "static"),
                       (dict(hcfgs=[]), "at least one HFLConfig")):
        with pytest.raises(ValueError, match=match):
            jrt.run_sweep(_cfg(rounds=2), loss_fn, params, batches,
                          seeds=[0], **jkw)
        tkw = {k: (convert.hfl_config_from_jax(v) if k == "hcfg" else
                   [convert.hfl_config_from_jax(h) for h in v])
               for k, v in jkw.items()}
        with pytest.raises(ValueError, match=match):
            trt.run_sweep(tcfg, _loss_t, _np(params), _np(batches),
                          seeds=[0], device="cpu", **tkw)
