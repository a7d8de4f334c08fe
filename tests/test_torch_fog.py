"""The port's fog hybrid (``run_fog``) against the JAX engine, on the CPU.

(a) The deployment: the port's fog variant builds the reference's
    same-cluster D2D graph bitwise (hex geometry, pairwise distances, the
    ``d2d_radius_m`` cut, the Laplacian mixing matrix) at N = 12 in 3
    clusters and N = 64 in 7, seeds 0-4.
(b) ``run_fog`` on the reference's linear problem at its N = 12 and
    ``HFLConfig(3, 3)``: gossip steps 1-3, radius pruning, top-k with
    Metropolis-Hastings mixing, QSGD, churn, scaled sign under faults, an
    eval batch, fedavg_m; each against the JAX engine, the port's host loop
    bitwise its scan, and the reference's own checks (sync collapses drift
    and bills the backhaul exactly there).
(c) Trace counts equal to the reference's over one sequence of calls.
(d) ``examples/fog_hybrid.py``'s LM cell (N = 28, 7 clusters, H = 4, k = 1,
    QSGD, 1e6 model bits, lr 0.5, the eval batch), each round run from the
    reference's round state, QSGD's dither flips counted (none in these 4
    rounds; a whole run drifts by ulps and then flips, as in
    ``test_torch_gossip.py``).

Parity contract: ``n_edges``, ``n_online``, ``uplink_bits`` (a message
price times the edge count, summed over the gossip steps in the
reference's order, plus the sync bill) and ``backhaul_bits`` equal;
``latency_s``, ``comm_s`` and ``comp_s`` within rtol 1e-5; ``loss`` within
rtol 1e-4; ``consensus_err`` within rtol 1e-4 and atol 1e-6 (on a sync
round every online node holds the same mean, and the drift is round-off,
1e-8 to 1e-7); final per-node params within atol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from benchmarks.common import make_lm_problem  # noqa: E402
from repro.core import hierarchy as jh  # noqa: E402
from repro.core import topology as jt  # noqa: E402
from repro.core import wireless as jwl  # noqa: E402
from repro.core.algorithms import registry as jalg  # noqa: E402
from repro.core.compression.registry import compression_params  # noqa: E402
from repro.core.faults import fault_params  # noqa: E402
from repro.fl import decentralized as jdz  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import wireless as twl  # noqa: E402
from repro_torch.fl import decentralized as tdz  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from test_torch_engine import _loss_t  # noqa: E402
from test_torch_gossip import (LAT_RTOL, LOSS_RTOL, DRIFT_RTOL,  # noqa: E402
                               PARAM_ATOL, _assert_bitwise, _assert_logs,
                               _assert_params, _np, _problem, _tbatches)
from test_torch_hfl import (_keep_engine_caches,  # noqa: E402,F401
                            _lm_loss_t)
from test_torch_steps import _one_thread  # noqa: E402,F401

N = 12
HCFG = jh.HFLConfig(n_clusters=3, inter_cluster_period=3)


def _fog_both(jcfg, hcfg=HCFG, eval_batch=None, engine="scan"):
    params, loss_fn, make_batches = _problem()
    ref = jdz.run_fog(jcfg, hcfg, loss_fn, params, make_batches,
                      eval_batch=eval_batch)
    port = tdz.run_fog(convert.gossip_config_from_jax(jcfg),
                       convert.hfl_config_from_jax(hcfg), _loss_t,
                       _np(params), _tbatches(make_batches),
                       eval_batch=_np(eval_batch), engine=engine,
                       device="cpu")
    return ref, port


# ---------------------------------------------------------------------------
# (a) the deployment and its D2D graph
# ---------------------------------------------------------------------------
def _ref_fog_graph(seed, n, hcfg, radius, mixing):
    """What the reference's fog engine builds before its first round."""
    k_pos, _ = jax.random.split(jax.random.PRNGKey(seed))
    pos, ids, dist_sbs, _, _ = jh.hfl_geometry_xy_jax(k_pos, hcfg, n)
    dist = jwl.pairwise_dist_jax(pos)
    adj = (ids[:, None] == ids[None, :]) & ~jnp.eye(n, dtype=bool)
    if radius is not None:
        adj = adj & (dist <= radius)
    mix = (jt.laplacian_mixing_jax if mixing == "laplacian"
           else jt.metropolis_hastings_mixing_jax)
    return tuple(np.asarray(a) for a in (mix(adj), dist, ids, dist_sbs,
                                         adj))


@pytest.mark.parametrize("mixing", ["laplacian", "mh"])
@pytest.mark.parametrize("radius", [None, 150.0, 400.0])
@pytest.mark.parametrize("n,n_clusters", [(12, 3), (64, 7)])
@pytest.mark.parametrize("seed", range(5))
def test_fog_graph_bitwise(seed, n, n_clusters, radius, mixing):
    hcfg = jh.HFLConfig(n_clusters=n_clusters, inter_cluster_period=4)
    w, dist, ids, dist_sbs, adj = _ref_fog_graph(seed, n, hcfg, radius,
                                                 mixing)
    cfg = tdz.GossipConfig(n_nodes=n, d2d_radius_m=radius, mixing=mixing)
    eng = tdz._FogEngine(cfg, convert.hfl_config_from_jax(hcfg), _loss_t,
                         False)
    params = {"w": torch.zeros(32)}
    v = eng.variant(
        torch.tensor([0, seed]), twl.channel_params(
            twl.WirelessConfig(n_devices=n)),
        tdz._resolve_cparams(cfg, params, torch.device("cpu")),
        tdz._resolve_aparams(cfg, torch.device("cpu")), 1e9, None, params)
    np.testing.assert_array_equal(v.dist_nn.numpy(), dist)
    np.testing.assert_array_equal(v.cluster_ids.numpy(), ids)
    np.testing.assert_array_equal(v.dist_sbs.numpy(), dist_sbs)
    np.testing.assert_array_equal((v.w.numpy() > 0) & ~np.eye(n, dtype=bool),
                                  adj)
    if mixing == "laplacian":
        np.testing.assert_array_equal(v.w.numpy(), w)
    else:
        off = ~np.eye(n, dtype=bool)
        np.testing.assert_array_equal(v.w.numpy()[off], w[off])
        np.testing.assert_allclose(np.diag(v.w.numpy()), np.diag(w),
                                   rtol=0, atol=2.4e-7)


# ---------------------------------------------------------------------------
# (b) run_fog against the JAX engine; host loop == scan
# ---------------------------------------------------------------------------
FOG_CASES = {
    "k1": dict(rounds=6),
    "k2": dict(rounds=6, gossip_steps=2),
    "k2_1e6": dict(rounds=6, gossip_steps=2, model_bits=1e6),
    "k3_qsgd": dict(rounds=4, gossip_steps=3, compression="qsgd",
                    compression_params=compression_params(levels=8),
                    model_bits=32.0 * 32),
    "radius": dict(rounds=3, d2d_radius_m=150.0),
    "topk_mh": dict(rounds=4, gossip_steps=2, compression="topk",
                    compression_params=compression_params(k=4), mixing="mh"),
    "churn": dict(rounds=5, faults=fault_params(churn_p_off=0.3,
                                                churn_p_on=0.5)),
    "faults_sign": dict(rounds=6, gossip_steps=2, compression="scaled_sign",
                        faults=fault_params(churn_p_off=0.2, churn_p_on=0.6,
                                            straggler_prob=0.3,
                                            fading_rho=0.5)),
    "fedavg_m": dict(rounds=4, algorithm="fedavg_m",
                     algo_params=jalg.algo_params(lr=0.05, momentum=0.9)),
}


@pytest.mark.parametrize("case", sorted(FOG_CASES))
def test_fog_matches_reference(case):
    cfg = jdz.GossipConfig(n_nodes=N, **FOG_CASES[case])
    (jp, jl), (tp, tl) = _fog_both(cfg)
    _assert_logs(jl, tl)
    _assert_params(jp, tp)


@pytest.mark.parametrize("case", ["k2", "topk_mh", "faults_sign", "k3_qsgd"])
def test_fog_host_equals_scan_bitwise(case):
    params, _, make_batches = _problem()
    cfg = convert.gossip_config_from_jax(jdz.GossipConfig(
        n_nodes=N, **FOG_CASES[case]))
    h = convert.hfl_config_from_jax(HCFG)
    runs = [tdz.run_fog(cfg, h, _loss_t, _np(params),
                        _tbatches(make_batches), engine=e, device="cpu")
            for e in ("scan", "host")]
    _assert_bitwise(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0]["w"], runs[1][0]["w"])


def test_fog_sync_collapses_drift_and_prices_backhaul():
    """The reference's own checks, on the port's logs: between syncs the
    clusters drift apart; a sync round pulls drift to round-off and bills
    the backhaul and the member uplink exactly there."""
    cfg = jdz.GossipConfig(n_nodes=N, rounds=6, gossip_steps=2,
                           model_bits=1e6)
    (_, jl), (_, tl) = _fog_both(cfg)
    _assert_logs(jl, tl)
    period = HCFG.inter_cluster_period
    sync = [t for t in range(cfg.rounds) if (t + 1) % period == 0]
    off = [t for t in range(cfg.rounds) if (t + 1) % period != 0]
    assert (tl.backhaul_bits[sync] == 2e6 * HCFG.n_clusters).all()
    assert (tl.backhaul_bits[off] == 0).all()
    for t in sync:
        assert tl.consensus_err[t] < 1e-6 < 1e-3 < tl.consensus_err[t - 1]
    assert tl.uplink_bits[sync[0]] == tl.uplink_bits[off[0]] + 1e6 * N


def test_fog_radius_prunes_edges():
    wide = jdz.GossipConfig(n_nodes=N, rounds=3)
    tight = jdz.GossipConfig(n_nodes=N, rounds=3, d2d_radius_m=150.0)
    (_, jw), (_, tw) = _fog_both(wide)
    (_, jtl), (_, tt) = _fog_both(tight)
    _assert_logs(jtl, tt)
    assert tt.n_edges[0] <= tw.n_edges[0]


@pytest.mark.parametrize("engine", ["scan", "host"])
def test_fog_eval_batch_matches_reference(engine):
    _, _, make_batches = _problem()
    eval_batch = jax.tree.map(lambda a: a[0, 0], make_batches(99, N))
    cfg = jdz.GossipConfig(n_nodes=N, rounds=8, gossip_steps=2)
    (jp, jl), (tp, tl) = _fog_both(cfg, eval_batch=eval_batch,
                                   engine=engine)
    _assert_logs(jl, tl)
    _assert_params(jp, tp)
    assert tl.loss[-1] < 0.5 * tl.loss[0]


def test_fog_backhaul_rate_and_cells_match_reference():
    import dataclasses
    h = dataclasses.replace(HCFG, backhaul_rate_bps=1e5)
    params, loss_fn, make_batches = _problem()
    cfg = jdz.GossipConfig(n_nodes=N, rounds=6, model_bits=1e5)
    wc = dict(bandwidth_hz=5e6, tx_power_dbm=15.0)
    jp, jl = jdz.run_fog(cfg, h, loss_fn, params, make_batches,
                         wcfg=jwl.WirelessConfig(n_devices=N, **wc))
    tp, tl = tdz.run_fog(convert.gossip_config_from_jax(cfg),
                         convert.hfl_config_from_jax(h), _loss_t,
                         _np(params), _tbatches(make_batches),
                         wcfg=twl.WirelessConfig(n_devices=N, **wc),
                         device="cpu")
    _assert_logs(jl, tl)
    _assert_params(jp, tp)


# ---------------------------------------------------------------------------
# (c) trace counts
# ---------------------------------------------------------------------------
def test_fog_trace_counts_match_reference():
    import dataclasses
    params, loss_fn, make_batches = _problem()
    th_ = convert.hfl_config_from_jax(HCFG)
    slow = dataclasses.replace(HCFG, backhaul_rate_bps=1e6)
    cfgs = {k: jdz.GossipConfig(n_nodes=N, rounds=3, gossip_steps=k)
            for k in (1, 2)}

    def both(k, engine="scan", h=HCFG):
        return (lambda: jdz.run_fog(cfgs[k], h, loss_fn, params,
                                    make_batches, engine=engine),
                lambda: tdz.run_fog(convert.gossip_config_from_jax(cfgs[k]),
                                    convert.hfl_config_from_jax(h), _loss_t,
                                    _np(params), _tbatches(make_batches),
                                    engine=engine, device="cpu"))

    calls = {"scan": both(1), "again": both(1), "backhaul": both(1, h=slow),
             "k = 2": both(2), "host": both(1, "host"),
             "host again": both(1, "host"), "host k = 2": both(2, "host")}
    assert th_.static_key() == convert.hfl_config_from_jax(slow).static_key()
    jrt._ENGINE_CACHE.clear()
    trt._ENGINE_CACHE.clear()
    counts = {}
    for what, (jcall, tcall) in calls.items():
        counts[what] = []
        for stats, call in ((jrt.ENGINE_STATS, jcall),
                            (trt.ENGINE_STATS, tcall)):
            before = stats["traces"]
            call()
            counts[what].append(stats["traces"] - before)
    assert all(j == t for j, t in counts.values()), counts
    assert counts["again"] == [0, 0] and counts["backhaul"] == [0, 0]
    assert counts["scan"] == [1, 1] and counts["host"] == [1, 1]


# ---------------------------------------------------------------------------
# (d) the example's LM cell, round by round from the reference's state
# ---------------------------------------------------------------------------
def test_lm_cell_counts_dither_flips():
    """``examples/fog_hybrid.py``'s cell at k = 1 (N = 28, D = 5120, QSGD
    at 256 levels, 1e6 model bits, lr 0.5, 7 clusters synced every 4
    rounds, the eval batch), 4 rounds (the last a sync), each round of the
    port from the reference's round state. Every log value holds to the
    contract; a flip (an edge message's coordinate rounded to the
    neighbouring level: the packages' message norms differ by ulps) moves
    that edge's EF element by exactly one step ``||m|| / levels``; flips are
    counted, and a node that receives none holds its model to atol 1e-5
    (on a sync round, where every online node takes the mean, only when no
    edge flipped)."""
    n, rounds, levels = 28, 4, 256.0
    hcfg = jh.HFLConfig(n_clusters=7, inter_cluster_period=4)
    params, loss_fn, sample, eval_fn = make_lm_problem(n_clients=n,
                                                       alpha=0.5)
    eb = eval_fn.eval_batch
    cfg = jdz.GossipConfig(n_nodes=n, rounds=rounds, compression="qsgd",
                           model_bits=1e6,
                           algo_params=jalg.algo_params(lr=0.5))
    init_carry, step, _ = jdz._make_fog_fns(cfg, hcfg, loss_fn, True)
    jstep = jax.jit(step)
    chan = jwl.channel_params(jwl.WirelessConfig(n_devices=n))
    cparams = jdz._resolve_cparams(cfg, params)
    k_pos, k_rounds = jax.random.split(jax.random.PRNGKey(cfg.seed))
    w, dist, ids, dist_sbs, _ = _ref_fog_graph(cfg.seed, n, hcfg, None,
                                               "laplacian")
    geom = tuple(jnp.asarray(a) for a in (w, dist, ids, dist_sbs))
    bh = jnp.float32(hcfg.backhaul_rate_bps)

    eng = tdz._FogEngine(convert.gossip_config_from_jax(cfg),
                         convert.hfl_config_from_jax(hcfg), _lm_loss_t, True)
    v = eng.variant(convert.key_from_jax(jax.random.PRNGKey(cfg.seed)),
                    twl.channel_params(twl.WirelessConfig(n_devices=n)),
                    convert.compression_params_from_jax(cparams),
                    convert.algo_params_from_jax(cfg.algo_params),
                    hcfg.backhaul_rate_bps, None,
                    convert.params_from_jax(params))
    np.testing.assert_array_equal(v.w.numpy(), w)
    carry = init_carry(params)
    n_flips = 0
    for t in range(rounds):
        bt = sample(t, n)
        x, ef, clock = jax.device_get(carry)
        inp = np.asarray(x)[:, None, :] + np.asarray(ef)
        carry, jout = jstep(chan, cparams, cfg.algo_params, None, bh, geom,
                            k_rounds, params, eb, carry, (jnp.int32(t), bt))
        tc = tdz._GossipCarry(*(torch.tensor(np.array(a))
                                for a in (x, ef, clock)))
        tnew, tout = eng.step(t, tc, v, convert.params_from_jax(bt),
                              convert.params_from_jax(eb))
        jout = [np.asarray(a) for a in jout]
        for i in (4, 5, 7, 8):
            np.testing.assert_array_equal(tout[i].numpy(), jout[i])
        for i, rtol in ((1, LAT_RTOL), (2, LAT_RTOL), (3, LAT_RTOL),
                        (0, LOSS_RTOL)):
            np.testing.assert_allclose(tout[i].numpy(), jout[i], rtol=rtol)
        np.testing.assert_allclose(tout[6].numpy(), jout[6],
                                   rtol=DRIFT_RTOL, atol=1e-6)
        je, te = np.asarray(carry[1]), tnew.ef.numpy()
        flips = np.argwhere(~np.isclose(te, je, rtol=1e-5, atol=1e-6))
        receivers = np.zeros(n, bool)
        for s, d, k in flips:
            step_ = np.linalg.norm(inp[s, d]) / levels
            np.testing.assert_allclose(abs(te[s, d, k] - je[s, d, k]),
                                       step_, rtol=1e-3)
            receivers[d] = True
        if (t + 1) % hcfg.inter_cluster_period == 0 and len(flips):
            receivers[:] = True
        n_flips += len(flips)
        jx, tx = np.asarray(carry[0]), tnew.x.numpy()
        np.testing.assert_allclose(tx[~receivers], jx[~receivers],
                                   atol=PARAM_ATOL, rtol=0)
        assert len(flips) <= 8, f"round {t}: {len(flips)} dither flips"
    assert n_flips <= 8 * rounds
