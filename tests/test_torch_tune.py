"""The port's auto-tuner (``repro_torch/fl/tune.py``) against the JAX
package's, on the CPU: each test of ``tests/test_tune.py`` (and the epsilon
budget of ``tests/test_privacy.py``) as a comparison of the two.

Scores are seed-averaged losses, held within rtol 1e-4. The tuner ranks by
``(score, repr(candidate))``, so an ulp of loss could reorder two nearly
equal candidates or groups: winners and surviving groups are held equal
only where the reference's margin between the first and the second exceeds
that tolerance, and each test checks the margin it relies on. Trace counts
are the reference's with both engine caches cleared (cold) and 0 warm.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from benchmarks.common import make_linear_problem  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro.fl import tune as jtune  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from repro_torch.fl import tune as ttune  # noqa: E402
from test_torch_engine import _loss_t  # noqa: E402
from test_torch_sweep import _tcfg  # noqa: E402
from test_torch_steps import _one_thread  # noqa: E402,F401

N, ROUNDS = 8, 6
TOL = 1e-4


def _problem():
    params, loss_fn, make_batches, _ = make_linear_problem(d=16)
    cfg = jrt.SimConfig(n_devices=N, n_scheduled=3, rounds=ROUNDS,
                        compression="topk")
    batches = jrt.stack_batches(make_batches, ROUNDS, N)
    return cfg, loss_fn, params, batches


def _tunes(cold=True, **kw):
    """The same tune through both packages: (reference, port)."""
    cfg, loss_fn, params, batches = _problem()
    if cold:
        jrt._ENGINE_CACHE.clear()
        trt._ENGINE_CACHE.clear()
    jres = jtune.tune(cfg, loss_fn, params, batches, **kw)
    tres = ttune.tune(_tcfg(cfg), _loss_t, {"w": np.asarray(params["w"])},
                      {k: np.asarray(v) for k, v in batches.items()},
                      device="cpu", **kw)
    return jres, tres


def _fields(c):
    return (c.policy, c.compression, c.n_scheduled, c.k, c.lr)


def _margin(scores, key=lambda c: c):
    """Relative gap between the best and the second-best distinct value of
    ``scores`` grouped by ``key``."""
    best = {}
    for c, v in scores.items():
        g = key(c)
        best[g] = min(best.get(g, np.inf), v)
    vals = sorted(best.values())
    if len(vals) < 2 or not np.isfinite(vals[0]):
        return np.inf
    return (vals[1] - vals[0]) / abs(vals[0])


def _assert_tune_match(jres, tres, *, need_margin=True):
    """Same scores (rtol), counts and rung shapes; the same winners and
    groups where the reference's margins clear the tolerance."""
    assert [_fields(c) for c in tres.scores] == [_fields(c)
                                                 for c in jres.scores]
    np.testing.assert_allclose(list(tres.scores.values()),
                               list(jres.scores.values()), rtol=TOL)
    assert tres.n_variants == jres.n_variants
    assert tres.refined_n_scheduled == jres.refined_n_scheduled
    assert [(r.rung, r.n_seeds) for r in tres.history] == [
        (r.rung, r.n_seeds) for r in jres.history]
    assert tres.history[0].groups == jres.history[0].groups
    np.testing.assert_allclose(tres.best_score, jres.best_score, rtol=TOL)
    clear = _margin(jres.scores) > TOL
    assert clear or not need_margin, "the winner's margin is within tolerance"
    if clear:
        assert _fields(tres.best) == _fields(jres.best)
        assert repr(tres.best) == repr(jres.best)
        for j, t in zip(jres.history, tres.history):
            assert t.groups == j.groups
            assert _fields(t.best) == _fields(j.best)
            np.testing.assert_allclose(t.best_score, j.best_score, rtol=TOL)


def test_loss_at_budget_scoring():
    loss = np.array([[5.0, 4.0, 3.0], [9.0, 8.0, 7.0]])
    lat = np.array([[1.0, 2.0, 3.0], [1.0, 2.0, 3.0]])  # cumulative
    eps = np.array([[0.5, 1.0, 2.0], [0.2, 0.4, 5.0]])
    seven = dict(loss=loss, latency_s=lat, n_scheduled=None,
                 participation=None, uplink_bits=None, comm_s=None,
                 comp_s=None)
    for extra in ({}, dict(epsilon=eps)):
        jl, tl = jrt.SimLogs(**seven, **extra), trt.SimLogs(**seven, **extra)
        for budget, eps_budget in ((None, None), (2.5, None), (0.5, None),
                                   (None, 1.0), (None, 0.1), (2.5, 2.0),
                                   (None, 10.0)):
            np.testing.assert_array_equal(
                ttune.loss_at_budget(tl, budget, eps_budget),
                jtune.loss_at_budget(jl, budget, eps_budget))
    np.testing.assert_array_equal(
        ttune.loss_at_budget(trt.SimLogs(**seven), None, 10.0),
        [np.inf, np.inf])


def test_tune_picks_best_lr_and_reuses_cache():
    kw = dict(seeds=(0, 1), policies=["random", "best_channel"],
              lr_grid=(0.001, 0.2))
    jres, tres = _tunes(**kw)
    _assert_tune_match(jres, tres)
    assert tres.best.lr == jres.best.lr == pytest.approx(0.2)
    assert tres.n_traces == jres.n_traces >= 1  # cold: the reference's count
    assert isinstance(tres.best, ttune.Candidate)
    assert ttune.Candidate._fields == tuple(
        f.name for f in jtune.dataclasses.fields(jtune.Candidate))
    jres2, tres2 = _tunes(cold=False, **kw)
    assert tres2.n_traces == jres2.n_traces == 0  # warm
    assert tres2.best == tres.best and tres2.best_score == tres.best_score


def test_tune_successive_halving_narrows_groups():
    kw = dict(seeds=(0, 1, 2, 3), policies=["random", "latency"],
              compressions=["topk", "none"], n_scheduled_grid=(2, 4),
              lr_grid=(0.05, 0.1))
    jres, tres = _tunes(**kw)
    _assert_tune_match(jres, tres)
    assert tres.n_traces == jres.n_traces  # cold, over four rungs' shapes
    sizes = [len(r.groups) for r in tres.history]
    assert sizes[0] == 4 and sizes[-1] < sizes[0]
    assert [r.n_seeds for r in tres.history][-1] == 4
    # each rung kept the groups the reference kept: the margin that the
    # halving relies on is the reference's at its cut, between the last
    # group kept and the first dropped, at that rung's seeds
    cfg, loss_fn, params, batches = _problem()
    k = [max(1, 16 // 100)]
    for rung, nxt in zip(jres.history, jres.history[1:]):
        group = {}
        for n_s, comp in rung.groups:
            got = jtune._score_group(
                cfg, loss_fn, params, batches, n_scheduled=n_s, comp=comp,
                seeds=kw["seeds"][:rung.n_seeds], policies=kw["policies"],
                cps=[jtune.compression_params(k=k[0])], k_grid=k,
                aps=[jtune.algo_params(lr=lr) for lr in kw["lr_grid"]],
                lr_grid=kw["lr_grid"], wcfg=None, eval_batch=None,
                budget_s=None, eps_budget=None, devices=None, mesh=None)
            group[(n_s, comp)] = min(got.values())
        vals = sorted(group.values())
        cut = len(nxt.groups)
        assert sorted(group, key=group.get)[:cut] == nxt.groups
        assert (vals[cut] - vals[cut - 1]) / abs(vals[cut - 1]) > TOL


def test_tune_refine_n_scheduled_bounds():
    jres, tres = _tunes(seeds=(0,), policies=["random"],
                        n_scheduled_grid=(4,), lr_grid=(0.1,),
                        refine_n_scheduled=True)
    _assert_tune_match(jres, tres)
    assert tres.n_traces == jres.n_traces
    assert 1 <= tres.refined_n_scheduled <= N
    probed = {c.n_scheduled for c in tres.scores if c.policy == "random"}
    assert tres.refined_n_scheduled in probed


def test_tune_budget_changes_objective():
    kw = dict(seeds=(0,), policies=["random"], lr_grid=(0.1,))
    jt, tt = _tunes(budget_s=1e-9, **kw)
    _assert_tune_match(jt, tt, need_margin=False)  # one candidate, all inf
    assert tt.best_score == jt.best_score == np.inf
    jl, tl = _tunes(cold=False, budget_s=1e9, **kw)
    jf, tf = _tunes(cold=False, budget_s=None, **kw)
    _assert_tune_match(jl, tl, need_margin=False)
    assert tl.best_score == tf.best_score
    np.testing.assert_allclose(tf.best_score, jf.best_score, rtol=TOL)


def test_tune_validates_inputs():
    cfg, loss_fn, params, batches = _problem()
    args = (_tcfg(cfg), _loss_t, {"w": np.asarray(params["w"])},
            {k: np.asarray(v) for k, v in batches.items()})
    for kw, match in ((dict(reduction=1), "reduction"),
                      (dict(n_scheduled_grid=(0, 4)), "n_scheduled_grid"),
                      (dict(n_scheduled_grid=(N + 1,)), "n_scheduled_grid")):
        with pytest.raises(ValueError, match=match):
            jtune.tune(cfg, loss_fn, params, batches, **kw)
        with pytest.raises(ValueError, match=match):
            ttune.tune(*args, device="cpu", **kw)
