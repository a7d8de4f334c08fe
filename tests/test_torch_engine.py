"""The port's flat engine against the JAX engine, end to end, on the CPU.

(a) The reference's linear problem (N = 40, 8 scheduled, d = 32, 12 rounds,
    pre-stacked batches) under all ten policies without compression, and
    under PF with each kernel-backed compressor.
(b) The kernel row path at fleet shape: ``test_torch_engine_fleet.py``.
(c) Inside the port, the chunked pass equals the unchunked one bitwise.

Tolerances: participation and uplink bits are equal; latency within rtol
1e-5, loss within rtol 1e-4.

The seed is one where two properties of the reference's CPU arithmetic stay
out of the comparison. At round 0 PF ranks instantaneous over averaged SNR,
which are equal for every device; XLA's CPU division is reciprocal-based, so
``x / x`` lands an ulp off 1 for some devices and those ulps order the tie,
where the port's IEEE division gives exactly 1 and index order. With this
seed the reference's round-0 order is index order too. And QSGD's stochastic
rounding flips one coordinate by a quantization step where the rounding
fraction lies within an ulp of the dither; at this seed no such coordinate
lands among the scheduled clients (seed 13, say, flips one in round 9).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from benchmarks.common import make_linear_problem  # noqa: E402
from repro.core import scheduling as jsched  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro_torch.core.algorithms import registry as talg  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401

SEED = 20
LOSS_RTOL = 1e-4
LAT_RTOL = 1e-5


def _loss_t(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}


def _assert_logs_match(jl, tl):
    np.testing.assert_array_equal(tl.participation, jl.participation)
    np.testing.assert_array_equal(tl.n_scheduled, jl.n_scheduled)
    np.testing.assert_array_equal(tl.uplink_bits, jl.uplink_bits)
    np.testing.assert_array_equal(tl.downlink_bits, jl.downlink_bits)
    np.testing.assert_allclose(tl.latency_s, jl.latency_s, rtol=LAT_RTOL)
    np.testing.assert_allclose(tl.loss, jl.loss, rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# (a) the linear problem, every policy
# ---------------------------------------------------------------------------
ENGINE_CASES = ([(p, "none") for p in jsched.policy_names()]
                + [("pf", c) for c in ("topk", "qsgd", "scaled_sign")])


@pytest.mark.parametrize("policy,comp", ENGINE_CASES)
def test_engine_matches_reference(policy, comp):
    params, loss_fn, make_batches, _ = make_linear_problem(d=32)
    kw = dict(n_devices=40, n_scheduled=8, rounds=12, local_steps=2,
              policy=policy, compression=comp, seed=SEED)
    jcfg = jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1), **kw)
    tcfg = trt.SimConfig(algo_params=talg.algo_params(lr=0.1), **kw)
    batches = jrt.stack_batches(make_batches, 12, 40)
    jp, jl = jrt.run_simulation_scan(jcfg, loss_fn, params, batches)
    tp, tl = trt.run_simulation_scan(
        tcfg, _loss_t, {"w": np.asarray(params["w"])},
        {k: np.asarray(v) for k, v in batches.items()}, device="cpu")
    _assert_logs_match(jl, tl)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-4, atol=1e-6)


def test_run_simulation_round_logs():
    params, loss_fn, make_batches, _ = make_linear_problem(d=32)
    kw = dict(n_devices=40, n_scheduled=8, rounds=3, local_steps=2, seed=SEED)
    jlogs = jrt.run_simulation(
        jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1), **kw), loss_fn,
        params, make_batches, engine="scan")
    tlogs = trt.run_simulation(
        trt.SimConfig(algo_params=talg.algo_params(lr=0.1), **kw), _loss_t,
        {"w": np.asarray(params["w"])}, make_batches, engine="scan",
        device="cpu")
    assert [r.round for r in tlogs] == [0, 1, 2]
    for j, t in zip(jlogs, tlogs):
        np.testing.assert_array_equal(t.participation, j.participation)
        np.testing.assert_allclose(t.loss, j.loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(t.latency_s, j.latency_s, rtol=LAT_RTOL)


@pytest.mark.parametrize("comp,double_ef", [("topk", True), ("qsgd", False),
                                            ("scaled_sign", False)])
def test_fl_round_gate_ef_and_guard_empty_match_reference(comp, double_ef):
    """One round with the fault engine's hooks: non-participants' EF rows
    frozen (gate_ef), and a round nobody survives a no-op (guard_empty)."""
    from repro.core import compression as jcomp
    from repro.core.compression import registry as jcomp_reg
    from repro.fl import server as jserver
    from repro_torch.convert import key_from_jax
    from repro_torch.core.compression import registry as tcomp
    from repro_torch.fl import server as tserver

    params, loss_fn, make_batches, _ = make_linear_problem(d=32)
    batches = make_batches(0, 12)
    rng = np.random.default_rng(1)
    ef0 = (0.01 * rng.standard_normal((12, 32))).astype(np.float32)
    key = jax.random.PRNGKey(9)
    for part in (np.array([1, 0] * 6, np.float32), np.zeros(12, np.float32)):
        js = jserver.init_fl_state(params, 12, use_ef=True,
                                   double_ef=double_ef)
        js = jserver.FLState(js.params, jnp.asarray(ef0), js.server_error,
                             js.server_opt)
        jnew, jm = jserver.fl_round(
            js, batches, loss_fn, aparams=jrt.algo_params(lr=0.1),
            participation=jnp.asarray(part),
            compress_fn=jcomp_reg.get_compressor(comp),
            cparams=jcomp.compression_params(k=3.0), key=key,
            compression_name=comp, gate_ef=True, guard_empty=True)
        ts = tserver.init_fl_state({"w": torch.zeros(32)}, 12, use_ef=True,
                                   double_ef=double_ef)
        ts.client_error = torch.from_numpy(ef0.copy())
        tnew, tm = tserver.fl_round(
            ts, {k: torch.tensor(np.asarray(v)) for k, v in batches.items()},
            _loss_t, aparams=talg.algo_params(lr=0.1),
            participation=torch.from_numpy(part), compression_name=comp,
            cparams=tcomp.compression_params(k=3.0), key=key_from_jax(key),
            gate_ef=True, guard_empty=True)
        np.testing.assert_allclose(tnew.params["w"].numpy(),
                                   np.asarray(jnew.params["w"]), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(tnew.client_error.numpy(),
                                   np.asarray(jnew.client_error), rtol=1e-4,
                                   atol=1e-6)
        frozen = part == 0
        np.testing.assert_array_equal(tnew.client_error.numpy()[frozen],
                                      ef0[frozen])
        assert float(tm["uplink_bits"]) == float(jm["uplink_bits"])
        if not part.any():
            assert not tnew.params["w"].any()


# ---------------------------------------------------------------------------
# (c) chunk invariance (the kernel path's in test_torch_engine_fleet.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("comp,ef_mode,state_dtype", [
    ("none", "dense", "float32"), ("topk", "dense", "float32"),
    ("topk", "sparse", "bfloat16"), ("qsgd", "dense", "bfloat16"),
    ("scaled_sign", "dense", "float32"), ("rtopk", "sparse", "float32")])
def test_chunked_equals_unchunked_bitwise(comp, ef_mode, state_dtype):
    """N = 10 in blocks of 4 (a ragged last block) against one block."""
    _, _, make_batches, _ = make_linear_problem(d=24, h=2, b=4)
    batches = trt.stack_batches(make_batches, 4, 10)
    outs = []
    for chunk in (4, None):
        cfg = trt.SimConfig(n_devices=10, n_scheduled=4, rounds=4,
                            local_steps=2, compression=comp, ef_mode=ef_mode,
                            state_dtype=state_dtype, chunk_size=chunk,
                            double_ef=comp == "topk", seed=SEED,
                            algo_params=talg.algo_params(lr=0.1))
        outs.append(trt.run_simulation_scan(
            cfg, _loss_t, {"w": np.zeros(24, np.float32)}, batches,
            device="cpu"))
    (cp, cl), (up, ul) = outs
    assert torch.equal(cp["w"], up["w"])
    for f in ("loss", "latency_s", "participation", "uplink_bits"):
        np.testing.assert_array_equal(getattr(cl, f), getattr(ul, f))


# ---------------------------------------------------------------------------
# entry points: the card by default, never a silent CPU fallback
# ---------------------------------------------------------------------------
def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = trt.SimConfig(n_devices=4, n_scheduled=2, rounds=1)
    batches = {"x": np.zeros((1, 4, 1, 2, 3), np.float32),
               "y": np.zeros((1, 4, 1, 2), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.run_simulation_scan(cfg, _loss_t, {"w": np.zeros(3, np.float32)},
                                batches)


def test_engine_argument_errors_match_reference():
    """A bogus engine, a scan asked to serve an opaque ``eval_fn`` and a
    per-cluster budget on the flat engine raise the reference's
    ``ValueError``s; a list budget becomes a tuple in both."""
    params, loss_fn, make_batches, _ = make_linear_problem(d=8)
    tparams = {"w": np.zeros(8, np.float32)}
    for rt_, loss, extra in ((jrt, loss_fn, {}),
                             (trt, _loss_t, dict(device="cpu"))):
        p = params if rt_ is jrt else tparams
        cfg = rt_.SimConfig(n_devices=4, n_scheduled=2, rounds=1)
        with pytest.raises(ValueError, match="unknown engine 'bogus'"):
            rt_.run_simulation(cfg, loss, p, make_batches, engine="bogus",
                               **extra)
        with pytest.raises(ValueError, match="engine='scan' needs an "
                           "in-program eval"):
            rt_.run_simulation(cfg, loss, p, make_batches, engine="scan",
                               eval_fn=lambda q: 0.0, **extra)
        tcfg = rt_.SimConfig(n_devices=4, n_scheduled=[2, 2], rounds=1)
        assert tcfg.n_scheduled == (2, 2)
        with pytest.raises(ValueError, match="per-cluster n_scheduled "
                           "tuples are a hierarchical-engine feature"):
            rt_.run_simulation_scan(tcfg, loss, p, rt_.stack_batches(
                make_batches, 1, 4), **extra)


# ---------------------------------------------------------------------------
# logs: zero rounds, positional SimLogs, batched logs, the reference's types
# ---------------------------------------------------------------------------
def test_zero_rounds_returns_initial_params_and_empty_logs():
    from repro.data.ondevice import make_linear_datagen as jdatagen
    from repro_torch.data import make_linear_datagen as tdatagen

    params, loss_fn, _, w_star = make_linear_problem(d=8)
    kw = dict(n_devices=6, n_scheduled=2, rounds=0, seed=SEED)
    jp, jl = jrt.run_simulation_scan(
        jrt.SimConfig(datagen=jdatagen(w_star), **kw), loss_fn, params)
    w0 = np.asarray(params["w"])
    tp, tl = trt.run_simulation_scan(
        trt.SimConfig(datagen=tdatagen(np.asarray(w_star)), **kw), _loss_t,
        {"w": w0}, device="cpu")
    np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
    for f in trt._LOG_FIELDS:
        j, t = np.asarray(getattr(jl, f)), getattr(tl, f)
        assert (t.shape, t.dtype) == (j.shape, j.dtype), f
    assert tl.participation.shape == (0, 6)
    assert tl.to_round_logs() == []


def test_simlogs_positional_and_batched_like_reference():
    """Seven positional fields work, with the reference's defaults for the
    rest; ``(variants, rounds)`` logs refuse ``to_round_logs``."""
    loss = np.array([3.0, 2.0], np.float32)
    seven = (loss, np.array([1.0, 2.0], np.float32), np.array([2, 2]),
             np.zeros((2, 4), bool), np.zeros(2), np.zeros(2), np.zeros(2))
    jr, tr = (jrt.SimLogs(*seven).to_round_logs(),
              trt.SimLogs(*seven).to_round_logs())
    for j, t in zip(jr, tr):
        jd, td = vars(j), vars(t)
        assert jd.keys() == td.keys()
        for k in jd:
            np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
            assert type(td[k]) is type(jd[k]), k
    assert tr[0].epsilon == float("inf") and tr[0].delta == 1.0
    batched = tuple(np.stack([a, a]) for a in seven)
    for rt_ in (jrt, trt):
        with pytest.raises(ValueError, match="to_round_logs needs "
                           "unbatched"):
            rt_.SimLogs(*batched).to_round_logs()


def test_log_types_match_reference():
    """All fifteen fields: the reference's types (the counts int32) and
    shapes, on a run with faults and DP so every field is live."""
    from repro.core import faults as jfaults
    from repro.core import privacy as jpriv
    from repro_torch.convert import (fault_params_from_jax,
                                     privacy_params_from_jax)

    params, loss_fn, make_batches, _ = make_linear_problem(d=16)
    fp = jfaults.fault_params(drop_prob=0.3, snr_min=0.5)
    pp = jpriv.privacy_params(clip=1.0, sigma=0.8)
    kw = dict(n_devices=8, n_scheduled=3, rounds=3, seed=SEED,
              max_retries=1, privacy="dp")
    batches = jrt.stack_batches(make_batches, 3, 8)
    _, jl = jrt.run_simulation_scan(
        jrt.SimConfig(faults=fp, privacy_params=pp, **kw), loss_fn, params,
        batches)
    _, tl = trt.run_simulation_scan(
        trt.SimConfig(faults=fault_params_from_jax(fp),
                      privacy_params=privacy_params_from_jax(pp), **kw),
        _loss_t, {"w": np.asarray(params["w"])},
        {k: np.asarray(v) for k, v in batches.items()}, device="cpu")
    jl = jax.device_get(jl)
    for f in trt._LOG_FIELDS:
        j, t = np.asarray(getattr(jl, f)), getattr(tl, f)
        assert (t.shape, t.dtype) == (j.shape, j.dtype), f
    for f in ("n_scheduled", "n_survived", "n_dropped"):
        assert getattr(tl, f).dtype == np.int32
        assert type(tl.to_round_logs()[0].n_survived) is int


# ---------------------------------------------------------------------------
# the engine's state options against the reference at N = 40
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("comp,ef_mode,state_dtype", [
    ("topk", "sparse", "float32"), ("randk", "sparse", "float32"),
    ("topk", "sparse", "bfloat16"), ("topk", "dense", "bfloat16"),
    ("scaled_sign", "dense", "bfloat16")])
def test_sparse_ef_and_bf16_state_match_reference(comp, ef_mode,
                                                  state_dtype):
    from repro.core import compression as jcomp
    from repro_torch.core.compression import registry as tcomp

    params, loss_fn, make_batches, _ = make_linear_problem(d=32)
    kw = dict(n_devices=40, n_scheduled=8, rounds=8, local_steps=2,
              policy="random", compression=comp, ef_mode=ef_mode,
              state_dtype=state_dtype, seed=SEED)
    batches = jrt.stack_batches(make_batches, 8, 40)
    jp, jl = jrt.run_simulation_scan(
        jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1),
                      compression_params=jcomp.compression_params(k=3.0),
                      **kw), loss_fn, params, batches)
    tp, tl = trt.run_simulation_scan(
        trt.SimConfig(algo_params=talg.algo_params(lr=0.1),
                      compression_params=tcomp.compression_params(k=3.0),
                      **kw), _loss_t, {"w": np.asarray(params["w"])},
        {k: np.asarray(v) for k, v in batches.items()}, device="cpu")
    _assert_logs_match(jl, tl)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", range(5))
def test_qsgd_engine_any_seed_one_dither_flip_a_round(seed):
    """QSGD at any seed: each round of the port runs from the reference's
    round state and is held against the reference's next state. The
    reference's CPU arithmetic may move one coordinate of one client's
    stochastic rounding by one level (ROADMAP queue C), so at most one EF
    element a round may differ, by exactly one step ``||c_i|| / levels``;
    all else holds to the engine tolerances."""
    from repro.core import compression as jcomp
    from repro.core import wireless as jwl
    from repro.core.algorithms import registry as jalg
    from repro_torch.convert import fl_state_from_jax
    from repro_torch.core import wireless as twl
    from repro_torch.core.compression import registry as tcomp

    levels, n, rounds = 256.0, 40, 8
    params, loss_fn, make_batches, _ = make_linear_problem(d=32)
    # model_bits = 32 d prices the d-dim message itself (payload scale 1)
    kw = dict(n_devices=n, n_scheduled=8, rounds=rounds, local_steps=2,
              policy="random", compression="qsgd", seed=seed,
              model_bits=32.0 * 32)
    jcfg = jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1),
                         compression_params=jcomp.compression_params(
                             levels=levels), **kw)
    tcfg = trt.SimConfig(algo_params=talg.algo_params(lr=0.1),
                         compression_params=tcomp.compression_params(
                             levels=levels), **kw)
    jw, tw = jwl.WirelessConfig(n_devices=n), twl.WirelessConfig(n_devices=n)
    init_carry, _, _ = jrt._make_sim_fns(jcfg, jw, loss_fn, False)
    jstep = jrt._get_host_step(jcfg, jw, loss_fn, False)
    k_pos, k_rounds = jax.random.split(jax.random.PRNGKey(seed))
    chan = jwl.channel_params(jw)
    dist = jwl.sample_positions_jax(k_pos, chan, n)
    engine = trt._Engine(tcfg, tw, _loss_t, False)
    tparams = {"w": torch.from_numpy(np.asarray(params["w"]).copy())}
    v = trt._single_variant(engine, tcfg, tw, tparams, torch.device("cpu"))
    client = jax.vmap(lambda b: jalg.get_algorithm("fedavg").client_update(
        loss_fn, jcfg.algo_params, carry[0].params, b, None)[0]["w"])

    carry = init_carry(params)
    n_flips = 0
    for t in range(rounds):
        bt = make_batches(t, n)
        state, clock, ages, norms, avg_snr = jax.device_get(carry)
        tcarry = trt._Carry(
            fl_state_from_jax(state), *(torch.from_numpy(np.array(x))
                                        for x in (clock, ages, norms,
                                                  avg_snr)))
        corrected = np.asarray(client(bt), np.float64) + np.asarray(
            state.client_error, np.float64)
        carry, jout = jstep(chan, jcfg.compression_params, jcfg.algo_params,
                            dist, k_rounds, None, carry, (jnp.int32(t), bt))
        tnew, tout = engine.step(
            t, tcarry, v, {k: torch.tensor(np.asarray(x))
                           for k, x in bt.items()}, None)
        jout = [np.asarray(x) for x in jout]
        np.testing.assert_array_equal(tout[2].numpy(), jout[2])
        np.testing.assert_array_equal(tout[4].numpy(), jout[4])
        np.testing.assert_allclose(tout[1].numpy(), jout[1], rtol=LAT_RTOL)
        np.testing.assert_allclose(tout[0].numpy(), jout[0], rtol=LOSS_RTOL)
        je, te = np.asarray(carry[0].client_error), tnew.state.client_error
        flips = ~np.isclose(te.numpy(), je, rtol=1e-5, atol=1e-6)
        assert flips.sum() <= 1, f"round {t}: {flips.sum()} EF flips"
        cols = np.ones(32, bool)
        if flips.any():
            i, j = np.argwhere(flips)[0]
            step = np.linalg.norm(corrected[i]) / levels
            np.testing.assert_allclose(abs(te[i, j] - je[i, j]), step,
                                       rtol=1e-3)
            cols[j] = False
            n_flips += 1
        np.testing.assert_allclose(tnew.state.params["w"].numpy()[cols],
                                   np.asarray(carry[0].params["w"])[cols],
                                   rtol=1e-4, atol=1e-6)
    assert n_flips <= rounds
