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


def test_unported_features_raise():
    """Faults and privacy are ported (``test_torch_faults.py``,
    ``test_torch_privacy.py``); the host loop and opaque ``eval_fn``s are
    not."""
    _, _, make_batches, _ = make_linear_problem(d=8)
    cfg = trt.SimConfig(n_devices=4, n_scheduled=2, rounds=1)
    params = {"w": np.zeros(8, np.float32)}
    with pytest.raises(NotImplementedError):
        trt.run_simulation(cfg, _loss_t, params, make_batches,
                           engine="host", device="cpu")
    with pytest.raises(NotImplementedError):
        trt.run_simulation(cfg, _loss_t, params, make_batches,
                           eval_fn=lambda p: 0.0, device="cpu")
