"""The port's algorithm family against the JAX package, on the CPU.

(a) ``core/aggregation.py`` function by function.
(b) Each of the eight algorithms through ``run_simulation_scan`` on the
    reference's linear problem (N = 40, 12 rounds, random scheduling of 8)
    without compression and with top-k and dense EF.
(c) SCAFFOLD and fedbuff on the kernel row path (N = 4096, d = 256,
    1024-client blocks, on-device data) with top-k and QSGD: SCAFFOLD's
    ctrl delta is a second uplink message through the row kernel.
(d) ``fl_round`` and ``pssgd_round`` one round at a time: fedbuff with no
    discount is fedavg bitwise, ``guard_empty`` leaves the server state
    alone, a round resumes from a JAX state carried across by
    ``convert.fl_state_from_jax``, and the deprecated spellings map onto the
    registry.

Tolerances, as in ``test_torch_engine.py``: participation and uplink bits
are equal; latency within rtol 1e-5 and loss within rtol 1e-4 (float32 sums
in another order, and XLA's CPU pow/sqrt/division a few ulp off PyTorch's,
compound over rounds); one round's params and states within rtol 1e-5,
atol 1e-6. The seed is the engine tests' (20), where the reference's
non-IEEE CPU arithmetic neither orders a tie nor flips a QSGD dither among
the scheduled clients. Bitwise claims (fedbuff vs fedavg, guard_empty) hold
inside the port.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from benchmarks.common import make_linear_problem  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core.algorithms import registry as jalg  # noqa: E402
from repro.core.compression import registry as jcomp_reg  # noqa: E402
from repro.data import make_linear_datagen as jdatagen  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro.fl import server as jserver  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core.algorithms import registry as talg  # noqa: E402
from repro_torch.core.compression import registry as tcomp  # noqa: E402
from repro_torch.data import make_linear_datagen as tdatagen  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from repro_torch.fl import server as tserver  # noqa: E402
from repro_torch.kernels import qsgd, topk_mask  # noqa: E402
from test_torch_engine import SEED, _assert_logs_match, _loss_t  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401

ALGOS = ("fedavg", "fedavg_m", "fedprox", "scaffold", "slowmo", "fedadam",
         "fedyogi", "fedbuff")
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    """Two states of one structure (tensors vs arrays), leaf by leaf."""
    if want is None:
        assert got is None
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   rtol=RTOL, atol=ATOL)


def _same(got, want):
    """Bitwise equality of two port states of one structure."""
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    elif isinstance(want, dict):
        for k in want:
            _same(got[k], want[k])
    else:
        for g, w in zip(got, want):
            _same(g, w)


def _stacked(seed=0, n=6):
    rng = np.random.default_rng(seed)
    tree = {"b": rng.standard_normal(n).astype(np.float32),
            "w": rng.standard_normal((n, 3, 4)).astype(np.float32)}
    return tree, {k: torch.from_numpy(v) for k, v in tree.items()}


def _single(tree):
    return ({k: v[0] for k, v in tree[0].items()},
            {k: v[0] for k, v in tree[1].items()})


# ---------------------------------------------------------------------------
# (a) aggregation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weighted", [False, True])
def test_average_gradients_and_fedavg_match_reference(weighted):
    jt, tt = _stacked(0)
    w = np.array([1, 0, 2, 1, 0, 1], np.float32) if weighted else None
    jw, tw = (None, None) if w is None else (jnp.asarray(w),
                                             torch.from_numpy(w))
    _close(tagg.average_gradients(tt, tw), jagg.average_gradients(jt, jw))
    _close(tagg.fedavg(tt, tw), jagg.fedavg(jt, jw))


def test_signsgd_majority_vote_matches_reference():
    jt, tt = _stacked(1, n=5)
    got, want = tagg.signsgd_majority_vote(tt), jagg.signsgd_majority_vote(jt)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("weighted", [False, True])
def test_slowmo_matches_reference(weighted):
    jt, tt = _stacked(2)
    jp, tp = _single(_stacked(3))
    w = np.array([1, 1, 0, 1, 0, 1], np.float32) if weighted else None
    js, ts = jagg.init_slowmo(jp), tagg.init_slowmo(tp)
    _close(ts, js)
    for _ in range(3):  # momentum carries across steps
        jp, js = jagg.slowmo(jp, jt, js, inner_lr=0.1, alpha=0.7, beta=0.5,
                             participation=None if w is None
                             else jnp.asarray(w))
        tp, ts = tagg.slowmo(tp, tt, ts, inner_lr=0.1, alpha=0.7, beta=0.5,
                             participation=None if w is None
                             else torch.from_numpy(w))
        _close(tp, jp)
        _close(ts.momentum, js.momentum)


@pytest.mark.parametrize("yogi", [False, True])
def test_fedadam_and_fedyogi_match_reference(yogi):
    jt, tt = _stacked(4)
    jp, tp = _single(_stacked(5))
    js, ts = jagg.init_server_opt(jp), tagg.init_server_opt(tp)
    _close(ts, js)
    for _ in range(3):
        jp, js = jagg.fedadam(jp, jt, js, server_lr=0.05, yogi=yogi)
        tp, ts = tagg.fedadam(tp, tt, ts, server_lr=0.05, yogi=yogi)
        _close(tp, jp)
        _close((ts.m, ts.v), (js.m, js.v))
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32


# ---------------------------------------------------------------------------
# (b) every algorithm through the engine
# ---------------------------------------------------------------------------
def test_registry_has_every_reference_algorithm():
    assert talg.algorithm_names() == jalg.algorithm_names() == ALGOS
    for name in ALGOS:
        t, j = talg.get_algorithm(name), jalg.get_algorithm(name)
        assert (t.uses_ctrl, t.uplink_factor, t.uses_staleness) == (
            j.uses_ctrl, j.uplink_factor, j.uses_staleness)
    assert talg.SERVER_ALIASES == jalg.SERVER_ALIASES


def _linear_runs(algo, comp, **extra):
    params, loss_fn, make_batches, _ = make_linear_problem(d=32)
    kw = dict(n_devices=40, n_scheduled=8, rounds=12, local_steps=2,
              policy="random", compression=comp, seed=SEED, algorithm=algo)
    batches = jrt.stack_batches(make_batches, 12, 40)
    jp, jl = jrt.run_simulation_scan(
        jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1, **extra), **kw),
        loss_fn, params, batches)
    tp, tl = trt.run_simulation_scan(
        trt.SimConfig(algo_params=talg.algo_params(lr=0.1, **extra), **kw),
        _loss_t, {"w": np.asarray(params["w"])},
        {k: np.asarray(v) for k, v in batches.items()}, device="cpu")
    return (jp, jl), (tp, tl)


@pytest.mark.parametrize("comp", ["none", "topk"])
@pytest.mark.parametrize("algo", ALGOS)
def test_algorithm_engine_matches_reference(algo, comp):
    (jp, jl), (tp, tl) = _linear_runs(algo, comp)
    _assert_logs_match(jl, tl)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-4, atol=1e-6)


def test_fedbuff_without_discount_is_fedavg_bitwise():
    """buffer_goal = 1, staleness_pow = 0: the buffer holds one round's mean
    delta and every weight is exactly 1.0, so each round is fedavg's."""
    params, _, make_batches, _ = make_linear_problem(d=32)
    batches = {k: np.asarray(v) for k, v in
               jrt.stack_batches(make_batches, 6, 40).items()}
    out = []
    for algo in ("fedavg", "fedbuff"):
        cfg = trt.SimConfig(
            n_devices=40, n_scheduled=8, rounds=6, local_steps=2,
            algorithm=algo, compression="topk", seed=SEED,
            algo_params=talg.algo_params(lr=0.1, staleness_pow=0.0,
                                         buffer_goal=1.0))
        out.append(trt.run_simulation_scan(
            cfg, _loss_t, {"w": np.asarray(params["w"])}, batches,
            device="cpu"))
    (ap, al), (bp, bl) = out
    assert torch.equal(ap["w"], bp["w"])
    for f in ("loss", "latency_s", "participation", "uplink_bits"):
        np.testing.assert_array_equal(getattr(al, f), getattr(bl, f))


def test_fedbuff_buffer_goal_and_discount_match_reference():
    """A buffer of 3 rounds with the staleness discount on."""
    (jp, jl), (tp, tl) = _linear_runs("fedbuff", "none", buffer_goal=3.0,
                                      staleness_pow=0.5)
    _assert_logs_match(jl, tl)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the kernel row path
# ---------------------------------------------------------------------------
FLEET = dict(n_devices=4096, n_scheduled=64, rounds=2, local_steps=2,
             policy="random", seed=SEED, chunk_size=1024)
D_FLEET = 256


@pytest.mark.parametrize("comp", ["topk", "qsgd"])
@pytest.mark.parametrize("algo", ["scaffold", "fedbuff"])
def test_kernel_path_algorithms_match_reference(algo, comp):
    params, loss_fn, _, w_star = make_linear_problem(d=D_FLEET)
    jcfg = jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1), algorithm=algo,
                         compression=comp, datagen=jdatagen(w_star, batch=2),
                         **FLEET)
    jp, jl = jrt.run_simulation_scan(jcfg, loss_fn, params)
    before = (topk_mask.topk_rows.launches, qsgd.qsgd_rows.launches)
    tcfg = trt.SimConfig(algo_params=talg.algo_params(lr=0.1),
                         algorithm=algo, compression=comp,
                         datagen=tdatagen(np.asarray(w_star), batch=2),
                         **FLEET)
    tp, tl = trt.run_simulation_scan(
        tcfg, _loss_t, {"w": np.zeros(D_FLEET, np.float32)}, device="cpu")
    _assert_logs_match(jl, tl)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-4, atol=1e-6)
    # the CPU wrappers take the plain versions: nothing launched
    assert before == (topk_mask.topk_rows.launches, qsgd.qsgd_rows.launches)


# ---------------------------------------------------------------------------
# (d) one round at a time
# ---------------------------------------------------------------------------
def _round_inputs(n=12, d=32):
    params, loss_fn, make_batches, _ = make_linear_problem(d=d)
    jb = make_batches(0, n)
    tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
    return params, loss_fn, jb, tb


def _both_rounds(algo, jstate, part, *, comp="topk", guard_empty=False):
    """One fl_round of each package from the same state (the port's carried
    across by the converter); returns both new states and metrics."""
    params, loss_fn, jb, tb = _round_inputs()
    tstate = convert.fl_state_from_jax(jstate)
    key = jax.random.PRNGKey(5)
    jnew, jm = jserver.fl_round(
        jstate, jb, loss_fn, algo=algo, aparams=jrt.algo_params(lr=0.1),
        participation=jnp.asarray(part),
        compress_fn=jcomp_reg.get_compressor(comp),
        cparams=jcomp.compression_params(k=3.0), key=key,
        compression_name=comp, guard_empty=guard_empty)
    tnew, tm = tserver.fl_round(
        tstate, tb, _loss_t, algo=algo, aparams=talg.algo_params(lr=0.1),
        participation=torch.from_numpy(part), compression_name=comp,
        cparams=tcomp.compression_params(k=3.0),
        key=convert.key_from_jax(key), guard_empty=guard_empty)
    return (jnew, jm), (tstate, tnew, tm)


def _jax_state_after(algo, rounds=2, n=12):
    """A mid-run JAX state: ``rounds`` rounds of top-k with double EF."""
    params, loss_fn, jb, _ = _round_inputs(n)
    st = jserver.init_fl_state(params, n, algo=algo, use_ef=True,
                               double_ef=True)
    for r in range(rounds):
        st, _ = jserver.fl_round(
            st, jb, loss_fn, algo=algo, aparams=jrt.algo_params(lr=0.1),
            participation=jnp.asarray(np.arange(n) % 3 != r, jnp.float32),
            compress_fn=jcomp_reg.get_compressor("topk"),
            cparams=jcomp.compression_params(k=3.0),
            key=jax.random.PRNGKey(r), compression_name="topk")
    return st


@pytest.mark.parametrize("algo", ["scaffold", "slowmo", "fedadam", "fedyogi",
                                  "fedbuff"])
def test_round_resumes_from_converted_jax_state(algo):
    jstate = _jax_state_after(algo)
    part = (np.arange(12) % 2).astype(np.float32)
    (jnew, jm), (tstate, tnew, tm) = _both_rounds(algo, jstate, part)
    # the converter carried everything across, dtypes included
    assert tstate.round == 2 and tstate.params["w"].dtype == torch.float32
    _close((tstate.server_opt, tstate.ctrl, tstate.client_error),
           (jstate.server_opt, jstate.ctrl, jstate.client_error))
    _close((tnew.params, tnew.server_opt, tnew.ctrl, tnew.client_error,
            tnew.server_error),
           (jnew.params, jnew.server_opt, jnew.ctrl, jnew.client_error,
            jnew.server_error))
    assert float(tm["uplink_bits"]) == float(jm["uplink_bits"])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL)


@pytest.mark.parametrize("algo", ["fedadam", "fedbuff"])
def test_guard_empty_keeps_server_state(algo):
    """No participant and guard_empty: params, the server optimizer state
    and the downlink EF are bitwise the round's input, as in the
    reference (a zero mean delta would still advance Adam's moments and
    step, or fedbuff's buffer counter)."""
    jstate = _jax_state_after(algo)
    (jnew, _), (tstate, tnew, _) = _both_rounds(
        algo, jstate, np.zeros(12, np.float32), guard_empty=True)
    for old, new in ((tstate.params, tnew.params),
                     (tstate.server_opt, tnew.server_opt),
                     (tstate.server_error, tnew.server_error)):
        _same(new, old)
    _close((tnew.params, tnew.server_opt, tnew.server_error),
           (jnew.params, jnew.server_opt, jnew.server_error))


@pytest.mark.parametrize("comp", ["none", "qsgd", "topk"])
def test_pssgd_round_matches_reference(comp):
    params, loss_fn, jb, tb = _round_inputs(n=8)
    key = jax.random.PRNGKey(3)
    kw = {} if comp == "none" else dict(
        compression=comp, key=key, cparams=jcomp.compression_params(k=4.0))
    jp, jl = jserver.pssgd_round(params, jb, loss_fn, lr=0.1, **kw)
    tkw = {} if comp == "none" else dict(
        compression=comp, key=convert.key_from_jax(key),
        cparams=tcomp.compression_params(k=4.0))
    tp, tl = tserver.pssgd_round({"w": torch.tensor(np.asarray(params["w"]))},
                                 tb, _loss_t, lr=0.1, **tkw)
    _close(tp, jp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    if comp != "none":
        with pytest.raises(ValueError):
            tserver.pssgd_round({"w": torch.zeros(32)}, tb, _loss_t, lr=0.1,
                                compression=comp)


def test_simconfig_server_alias_warns_and_maps():
    with pytest.warns(DeprecationWarning):
        cfg = trt.SimConfig(server="adam")
    assert cfg.algorithm == "fedadam" and cfg.server is None
    with pytest.warns(DeprecationWarning):
        cfg = trt.SimConfig(lr=0.3)
    assert float(cfg.algo_params.lr) == pytest.approx(0.3)
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError):
        trt.SimConfig(server="adam", algorithm="slowmo")


@pytest.mark.parametrize("legacy,algo,ap", [
    (dict(server="slowmo", slowmo_beta=0.7), "slowmo",
     dict(slowmo_beta=0.7)),
    (dict(momentum=0.8), "fedavg_m", dict(momentum=0.8)),
    (dict(lr=0.2, server_lr=0.5), "fedavg", dict(lr=0.2, server_lr=0.5))])
def test_fl_round_deprecated_spellings_map_onto_registry(legacy, algo, ap):
    params, _, _, tb = _round_inputs()
    p0 = {"w": torch.tensor(np.asarray(params["w"]))}
    with pytest.warns(DeprecationWarning):
        got, _ = tserver.fl_round(
            tserver.init_fl_state(p0, 12, algo=algo), tb, _loss_t, **legacy)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want, _ = tserver.fl_round(
            tserver.init_fl_state(p0, 12, algo=algo), tb, _loss_t,
            algo=algo, aparams=talg.algo_params(**ap))
    assert torch.equal(got.params["w"], want.params["w"])
    with pytest.warns(DeprecationWarning):
        st = tserver.init_fl_state(p0, 12, server="yogi")
    assert isinstance(st.server_opt, tagg.ServerOptState)


def test_scaffold_state_layout():
    """SCAFFOLD allocates its (n_rows, D) ctrl matrix in state_dtype and a
    (D,) server control variate; other algorithms carry no ctrl."""
    p0 = {"b": torch.zeros(3), "w": torch.zeros(4, 5)}
    st = tserver.init_fl_state(p0, 10, algo="scaffold", n_rows=16,
                               state_dtype=torch.bfloat16)
    assert st.ctrl.shape == (16, 23) and st.ctrl.dtype == torch.bfloat16
    assert st.server_opt.shape == (23,)
    assert tserver.init_fl_state(p0, 10, algo="fedbuff").ctrl is None
