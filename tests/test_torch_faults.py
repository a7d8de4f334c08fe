"""The port's fault layer against ``repro.core.faults`` and the JAX engine.

Unit draws on the same keys: uniform-driven draws (churn, dropout, the
straggler selection) are bitwise; the Pareto multiplier is within rtol 1e-6
(``pow`` may differ by an ulp); Gauss-Markov fading within rtol 1e-6, atol
1e-7; the exponential draws within 2 ulps (``log1p``).

Engine runs on the reference tests' problem (``make_linear_problem(d=16)``,
N = 8, 3 scheduled, 8 rounds) with ``tests/test_faults.py``'s ``FAULTS`` and
``max_retries=2``: participation, the schedule and survivor counts,
retransmissions and the uplink and downlink bits are equal; the staleness
mean within rtol 1e-6, latency within rtol 1e-5, loss within rtol 1e-4.
A decode threshold turns an ulp of the fading normals into a participation
flip when an SNR lands on it, so each engine test asserts that the
reference run's smallest ``|snr / snr_min - 1|`` is above 1e-5: the seed is
checked, not trusted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from benchmarks.common import make_linear_problem  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import scheduling as jsched  # noqa: E402
from repro.core import wireless as jwireless  # noqa: E402
from repro.data import make_linear_datagen as jdatagen  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro_torch.convert import (fault_params_from_jax,  # noqa: E402
                                 key_from_jax)
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import scheduling as tsched  # noqa: E402
from repro_torch.core.algorithms import registry as talg  # noqa: E402
from repro_torch.core.compression import registry as tcomp  # noqa: E402
from repro_torch.data import make_linear_datagen as tdatagen  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from repro_torch.fl import server as tserver  # noqa: E402
from test_torch_engine import _loss_t  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401

FAULTS = jfaults.fault_params(drop_prob=0.3, churn_p_off=0.2, churn_p_on=0.6,
                              straggler_prob=0.3, straggler_alpha=1.5,
                              snr_min=2.0, fading_rho=0.7)
SEED = 7
N, K, ROUNDS, D = 8, 3, 8, 16
SNR_MARGIN = 1e-5
KEYS = (0, 5, 123)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _ulps(a, b):
    """Distance in float32 ulps between two arrays of positive floats."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


# ---------------------------------------------------------------------------
# unit draws
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", KEYS)
def test_uniform_draws_bitwise(seed):
    """Churn, dropout and the straggler selection uniforms."""
    kt = jax.random.PRNGKey(seed)
    tkt = key_from_jax(kt)
    tfp = fault_params_from_jax(FAULTS)
    avail = np.random.default_rng(seed).random(257) < 0.6
    np.testing.assert_array_equal(
        tfaults.churn_step(tfp, tkt, _t(avail)).numpy(),
        np.asarray(jfaults.churn_step(FAULTS, kt, jnp.asarray(avail))))
    np.testing.assert_array_equal(
        tfaults.dropout_draw(tfp, tkt, 257).numpy(),
        np.asarray(jfaults.dropout_draw(FAULTS, kt, 257)))
    for sub in (0, 1):
        k = jax.random.fold_in(kt, jfaults.STRAGGLER_FOLD)
        np.testing.assert_array_equal(
            tfaults._client_uniform(key_from_jax(k), sub, 257).numpy(),
            np.asarray(jfaults._client_uniform(k, sub, 257)))


@pytest.mark.parametrize("seed", KEYS)
def test_straggler_multiplier(seed):
    kt = jax.random.PRNGKey(seed)
    want = np.asarray(jfaults.straggler_multiplier(FAULTS, kt, 257))
    got = tfaults.straggler_multiplier(fault_params_from_jax(FAULTS),
                                       key_from_jax(kt), 257).numpy()
    np.testing.assert_array_equal(got == 1.0, want == 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("t", [0, 3])
@pytest.mark.parametrize("rho", [0.0, 0.7])
def test_gauss_markov_fading(t, rho):
    fp = jfaults.fault_params(fading_rho=rho)
    kt = jax.random.PRNGKey(11 + t)
    fad = (0.7 * np.random.default_rng(t).standard_normal((300, 2))
           ).astype(np.float32)
    js, jp = jfaults.gauss_markov_fading(fp, kt, jnp.asarray(fad),
                                         jnp.int32(t))
    ts, tp = tfaults.gauss_markov_fading(fault_params_from_jax(fp),
                                         key_from_jax(kt), _t(fad), t)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("seed", KEYS)
def test_exponential_draws_within_2_ulps(seed):
    kt = jax.random.PRNGKey(seed)
    tkt = key_from_jax(kt)
    for attempt in (1, 2):
        assert _ulps(tfaults.retry_fading(tkt, attempt, 300).numpy(),
                     jfaults.retry_fading(kt, attempt, 300)) <= 2
    assert _ulps(tfaults.d2d_fading(tkt, 300).numpy(),
                 jfaults.d2d_fading(kt, 300)) <= 2
    assert _ulps(tfaults.downlink_fading(tkt, 300).numpy(),
                 jfaults.downlink_fading(kt, 300)) <= 2


def test_masked_round_state_bitwise():
    rng = np.random.default_rng(0)
    vals = {f: rng.random(64).astype(np.float32)
            for f in ("snr_lin", "avg_snr", "rates", "comm_lat", "comp_lat",
                      "ages", "update_norms")}
    m = rng.random(64) < 0.5
    key = jax.random.PRNGKey(1)
    jst = jsched.RoundState(t=jnp.int32(2), key=key,
                            **{f: jnp.asarray(v) for f, v in vals.items()})
    tst = tsched.RoundState(t=2, key=key_from_jax(key),
                            **{f: _t(v) for f, v in vals.items()})
    for knew in (None, jax.random.PRNGKey(9)):
        jm = jsched.masked_round_state(jst, jnp.asarray(m), knew)
        tm = tsched.masked_round_state(
            tst, _t(m), None if knew is None else key_from_jax(knew))
        for f in vals:
            np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                          np.asarray(getattr(jm, f)))
        np.testing.assert_array_equal(tm.key.numpy(),
                                      np.asarray(jm.key).astype(np.int64))


def test_stack_and_convert_fault_params():
    grid = [jfaults.fault_params(drop_prob=p, snr_min=s)
            for p, s in ((0.1, 1.0), (0.5, 3.0))]
    jst = jfaults.stack_fault_params(grid)
    tst = tfaults.stack_fault_params([fault_params_from_jax(p)
                                      for p in grid])
    for f in tfaults.FaultParams._fields:
        got = getattr(tst, f)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jst, f)))
    assert tfaults.default_fault_params() == tfaults.fault_params()
    direct = tfaults.fault_params(drop_prob=0.3, churn_p_off=0.2,
                                  churn_p_on=0.6, straggler_prob=0.3,
                                  straggler_alpha=1.5, snr_min=2.0,
                                  fading_rho=0.7)
    for a, b in zip(direct, fault_params_from_jax(FAULTS)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------
def snr_margin_jax(seed, n, rounds, fp, max_retries, part=None):
    """The smallest ``|snr / snr_min - 1|`` the reference engine meets in a
    run (the round's Gauss-Markov draw and every retry draw), over the
    clients ``part`` ((rounds, n) bool, default all) marks."""
    wcfg = jwireless.WirelessConfig(n_devices=n)
    chan = jwireless.channel_params(wcfg)
    k_pos, k_rounds = jax.random.split(jax.random.PRNGKey(seed))
    dist = jwireless.sample_positions_jax(k_pos, chan, n)
    fad = jnp.zeros((n, 2), jnp.float32)
    worst = np.inf
    for t in range(rounds):
        kt = jax.random.fold_in(k_rounds, t)
        fad, power = jfaults.gauss_markov_fading(fp, kt, fad, jnp.int32(t))
        draws = [power] + [jfaults.retry_fading(kt, r, n)
                           for r in range(1, max_retries + 1)]
        for p in draws:
            snr = np.asarray(jwireless.snr_jax(dist, p, chan))
            m = np.abs(snr / float(fp.snr_min) - 1.0)
            worst = min(worst, float(m[part[t]].min() if part is not None
                                     else m.min()))
    return worst


def _problem():
    params, loss_fn, make_batches, _ = make_linear_problem(d=D)
    return params, loss_fn, jrt.stack_batches(make_batches, ROUNDS, N)


def _port_run(batches, **kw):
    if "faults" in kw and kw["faults"] is not None:
        kw["faults"] = fault_params_from_jax(kw["faults"])
    cfg = trt.SimConfig(n_devices=N, n_scheduled=K, rounds=ROUNDS,
                        policy="random", seed=SEED,
                        algo_params=talg.algo_params(lr=0.1), **kw)
    return trt.run_simulation_scan(
        cfg, _loss_t, _port_params(),
        {k: np.asarray(v) for k, v in batches.items()}, device="cpu")


def _port_params():
    return {"w": np.zeros(D, np.float32)}


ENGINE_CASES = [("fedavg", "none"), ("fedavg", "topk"), ("fedavg", "qsgd"),
                ("fedavg", "scaled_sign"), ("scaffold", "topk"),
                ("fedbuff", "none")]


@pytest.fixture(scope="module")
def reference_runs():
    """The JAX engine once per case (``None``: the fault-free fedavg run)."""
    params, loss_fn, batches = _problem()
    runs = {}
    for case in ENGINE_CASES + [None]:
        algo, comp = case or ("fedavg", "none")
        fkw = dict(faults=FAULTS, max_retries=2) if case else {}
        cfg = jrt.SimConfig(n_devices=N, n_scheduled=K, rounds=ROUNDS,
                            policy="random", seed=SEED, algorithm=algo,
                            compression=comp,
                            algo_params=jrt.algo_params(lr=0.1), **fkw)
        runs[case] = jrt.run_simulation_scan(cfg, loss_fn, params, batches)
    return batches, runs


def _assert_fault_logs_match(jl, tl):
    for f in ("participation", "n_scheduled", "n_survived", "n_dropped",
              "retransmissions", "uplink_bits", "downlink_bits"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f),
                                      err_msg=f)
    np.testing.assert_allclose(tl.staleness_mean, jl.staleness_mean,
                               rtol=1e-6)
    np.testing.assert_allclose(tl.latency_s, jl.latency_s, rtol=1e-5)
    np.testing.assert_allclose(tl.loss, jl.loss, rtol=1e-4)


@pytest.mark.parametrize("algo,comp", ENGINE_CASES)
def test_engine_with_faults_matches_reference(reference_runs, algo, comp):
    batches, runs = reference_runs
    jp, jl = runs[(algo, comp)]
    assert snr_margin_jax(SEED, N, ROUNDS, FAULTS, 2) > SNR_MARGIN
    tp, tl = _port_run(batches, algorithm=algo, compression=comp,
                       faults=FAULTS, max_retries=2)
    _assert_fault_logs_match(jl, tl)
    # the faults really act: clients drop, decodes fail and are retried
    assert jl.n_dropped.sum() > 0 and jl.retransmissions.sum() > 0
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-4, atol=1e-6)


def test_fault_free_log_fields_match_reference(reference_runs):
    """The seven fields the fault and privacy layers add, with both off."""
    batches, runs = reference_runs
    _, jl = runs[None]
    _, tl = _port_run(batches)
    for f in ("n_survived", "n_dropped", "retransmissions", "staleness_mean",
              "epsilon", "delta", "mask_bits"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f),
                                      err_msg=f)
    np.testing.assert_array_equal(tl.n_survived, tl.n_scheduled)
    assert np.isinf(tl.epsilon).all() and (tl.delta == 1.0).all()
    assert ([_round_log_counts(r) for r in tl.to_round_logs()]
            == [_round_log_counts(r) for r in jl.to_round_logs()])


def _round_log_counts(r):
    """A RoundLog's exact fields (participation aside)."""
    return (r.round, r.n_scheduled, r.n_survived, r.n_dropped,
            r.retransmissions, r.staleness_mean, r.epsilon, r.delta,
            r.mask_bits, r.uplink_bits, r.downlink_bits)


def test_faults_off_is_bitwise_legacy_stream(reference_runs):
    batches, _ = reference_runs
    ap, al = _port_run(batches)
    bp, bl = _port_run(batches, faults=None, max_retries=0)
    assert torch.equal(ap["w"], bp["w"])
    for f in trt._LOG_FIELDS:
        np.testing.assert_array_equal(getattr(al, f), getattr(bl, f))


@pytest.mark.parametrize("algo,comp,ef_mode", [
    ("fedavg", "qsgd", "dense"), ("scaffold", "topk", "sparse"),
    ("fedbuff", "none", "dense")])
def test_chunked_equals_unchunked_bitwise_with_faults(algo, comp, ef_mode):
    """N = 10 in blocks of 4 (a ragged last block) against one block."""
    _, _, make_batches, _ = make_linear_problem(d=24, h=2, b=4)
    batches = trt.stack_batches(make_batches, 5, 10)
    outs = []
    for chunk in (4, None):
        cfg = trt.SimConfig(
            n_devices=10, n_scheduled=4, rounds=5, local_steps=2,
            algorithm=algo, compression=comp, ef_mode=ef_mode,
            chunk_size=chunk, seed=SEED, double_ef=comp == "qsgd",
            faults=fault_params_from_jax(FAULTS), max_retries=2,
            algo_params=talg.algo_params(lr=0.1))
        outs.append(trt.run_simulation_scan(
            cfg, _loss_t, {"w": np.zeros(24, np.float32)}, batches,
            device="cpu"))
    (cp, cl), (up, ul) = outs
    assert torch.equal(cp["w"], up["w"])
    for f in trt._LOG_FIELDS:
        np.testing.assert_array_equal(getattr(cl, f), getattr(ul, f))
    assert cl.n_dropped.sum() > 0


@pytest.mark.parametrize("algo,comp", [("fedavg", "none"),
                                       ("scaffold", "topk")])
def test_all_dropped_is_noop(algo, comp):
    """drop_prob = 1: every round has no survivor. The engine's params stay
    at their start bit for bit, and one round through ``fl_round`` with the
    engine's switches keeps params, server state, downlink EF, the EF rows
    and SCAFFOLD's variates bitwise."""
    params, _, make_batches, _ = make_linear_problem(d=D)
    batches = trt.stack_batches(make_batches, 3, N)
    cfg = trt.SimConfig(n_devices=N, n_scheduled=K, rounds=3, seed=SEED,
                        algorithm=algo, compression=comp,
                        faults=tfaults.fault_params(drop_prob=1.0),
                        algo_params=talg.algo_params(lr=0.1))
    p0 = _port_params()
    tp, tl = trt.run_simulation_scan(cfg, _loss_t, p0, batches, device="cpu")
    for k in p0:
        np.testing.assert_array_equal(tp[k].numpy(), p0[k])
    assert (tl.n_survived == 0).all() and (tl.n_dropped == K).all()

    rng = np.random.default_rng(2)
    state = tserver.init_fl_state({k: _t(v) for k, v in p0.items()}, N,
                                  algo=algo, use_ef=comp != "none",
                                  double_ef=comp != "none")
    if state.client_error is not None:
        state.client_error = _t(rng.standard_normal(
            state.client_error.shape).astype(np.float32))
        state.server_error = _t(rng.standard_normal(
            state.server_error.shape).astype(np.float32))
    if state.ctrl is not None:
        state.ctrl = _t(rng.standard_normal(state.ctrl.shape).astype(
            np.float32))
        state.server_opt = _t(rng.standard_normal(
            state.server_opt.shape).astype(np.float32))
    kw = (dict(compression_name=comp, key=key_from_jax(jax.random.PRNGKey(1)),
               cparams=tcomp.compression_params(k=3.0))
          if comp != "none" else {})
    new, _ = tserver.fl_round(
        state, {k: v[0] for k, v in batches.items()}, _loss_t, algo=algo,
        aparams=talg.algo_params(lr=0.1), participation=torch.zeros(N),
        gate_ef=True, guard_empty=True, **kw)
    for k in p0:
        assert torch.equal(new.params[k], state.params[k])
    for a, b in ((new.client_error, state.client_error),
                 (new.server_error, state.server_error),
                 (new.ctrl, state.ctrl), (new.server_opt, state.server_opt)):
        assert (a is None and b is None) or torch.equal(a, b)


def test_simconfig_validates_faults():
    with pytest.raises(ValueError, match="max_retries"):
        trt.SimConfig(max_retries=-1)
    with pytest.raises(ValueError, match="FaultParams"):
        trt.SimConfig(faults=object())
    with pytest.raises(ValueError, match="FaultParams"):
        trt.SimConfig(faults=FAULTS)  # the reference's NamedTuple
    cfg = trt.SimConfig(faults=tfaults.fault_params(drop_prob=0.1),
                        max_retries=3)
    assert cfg.max_retries == 3


def test_run_simulation_round_logs_with_faults():
    """``run_simulation`` returns the fault fields per round."""
    params, loss_fn, make_batches, _ = make_linear_problem(d=D)
    kw = dict(n_devices=N, n_scheduled=K, rounds=4, seed=SEED,
              max_retries=2)
    jlogs = jrt.run_simulation(
        jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1), faults=FAULTS,
                      **kw), loss_fn, params, make_batches, engine="scan")
    tlogs = trt.run_simulation(
        trt.SimConfig(algo_params=talg.algo_params(lr=0.1),
                      faults=fault_params_from_jax(FAULTS), **kw),
        _loss_t, _port_params(), make_batches, device="cpu")
    for j, t in zip(jlogs, tlogs):
        assert (t.n_survived, t.n_dropped, t.retransmissions) == (
            j.n_survived, j.n_dropped, j.retransmissions)
        np.testing.assert_allclose(t.loss, j.loss, rtol=1e-4)


# ---------------------------------------------------------------------------
# fleet shape: the kernel row path (N * D = 2^20) with faults
# ---------------------------------------------------------------------------
FLEET = dict(n_devices=4096, n_scheduled=64, rounds=2, local_steps=2,
             policy="random", seed=20, compression="topk", chunk_size=1024,
             max_retries=2)
D_FLEET = 256


def test_kernel_path_with_faults_matches_reference():
    params, loss_fn, _, w_star = make_linear_problem(d=D_FLEET)
    jcfg = jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1),
                         datagen=jdatagen(w_star, batch=2), faults=FAULTS,
                         **FLEET)
    jp, jl = jrt.run_simulation_scan(jcfg, loss_fn, params)
    assert snr_margin_jax(FLEET["seed"], FLEET["n_devices"], FLEET["rounds"],
                          FAULTS, 2, jl.participation) > SNR_MARGIN
    tcfg = trt.SimConfig(algo_params=talg.algo_params(lr=0.1),
                         datagen=tdatagen(np.asarray(w_star), batch=2),
                         faults=fault_params_from_jax(FAULTS), **FLEET)
    tp, tl = trt.run_simulation_scan(
        tcfg, _loss_t, {"w": np.zeros(D_FLEET, np.float32)}, device="cpu")
    _assert_fault_logs_match(jl, tl)
    assert (jl.n_dropped > 0).all()
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-4, atol=1e-6)
