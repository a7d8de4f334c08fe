"""The port's gossip engine against the JAX engine, on the CPU.

(a) ``run_gossip`` on the reference's linear problem (``make_linear_problem``,
    d = 32, H = 2, B = 8) at the reference's N = 9 over its four topologies
    (ring, 3x3 torus, ER(0.4) with Metropolis-Hastings weights, star), with
    top-k and QSGD, with scaled sign under faults, with an eval batch, with
    fedavg_m and fedprox; each against the JAX engine, and the port's host
    loop bitwise its scan.
(b) The uncompressed exchange against numpy's ``W @ X``; all-offline nodes
    keep their models bitwise; ``run_gossip_sweep`` bitwise the port's single
    runs and against the reference's vmapped sweep; trace counts equal to
    the reference's over one sequence of calls.
(c) ``examples/decentralized_gossip.py``'s LM cell (N = 16, ring, QSGD, 1e6
    model bits, lr 0.5, the eval batch), each round run from the
    reference's round state, with QSGD's dither flips counted.
(d) ``GossipConfig`` and ``_check_w`` errors, ``consensus_step`` and
    ``gossip_round``, ``convert.gossip_config_from_jax``.

Parity contract: ``n_edges``, ``n_online``, ``uplink_bits`` and
``backhaul_bits`` equal; ``latency_s``, ``comm_s`` and ``comp_s`` within
rtol 1e-5; ``loss`` within rtol 1e-4; ``consensus_err`` within rtol 1e-4
(atol 1e-6 where drift falls to round-off); final per-node params within
atol 1e-5.

QSGD's stochastic rounding steps a coordinate by a whole level where the
rounding fraction lies within an ulp of the dither, and the two packages'
models and message norms differ by ulps (summation orders): at N = 9 no
coordinate flips over seeds 0-4 at 8 and 256 levels. In the LM cell (D =
5120) a whole run drifts by ulps and then flips coordinates (the final
params 0.03 apart after 2 rounds), so (c) runs each round from the
reference's state and counts the flips of that round (none in these 3
rounds; at most 8 a round allowed, each exactly one step).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from benchmarks.common import make_linear_problem, make_lm_problem  # noqa: E402
from repro.core import topology as jt  # noqa: E402
from repro.core import wireless as jwl  # noqa: E402
from repro.core.algorithms import registry as jalg  # noqa: E402
from repro.core.compression.registry import compression_params  # noqa: E402
from repro.core.faults import fault_params  # noqa: E402
from repro.fl import decentralized as jdz  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import wireless as twl  # noqa: E402
from repro_torch.fl import decentralized as tdz  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from test_torch_engine import _loss_t  # noqa: E402
from test_torch_hfl import (_keep_engine_caches,  # noqa: E402,F401
                            _lm_loss_t)
from test_torch_steps import _one_thread  # noqa: E402,F401

N = 9
LOSS_RTOL, LAT_RTOL, DRIFT_RTOL, DRIFT_ATOL = 1e-4, 1e-5, 1e-4, 1e-6
PARAM_ATOL = 1e-5
EXACT = ("uplink_bits", "backhaul_bits", "n_edges", "n_online")
CLOSE = (("latency_s", LAT_RTOL), ("comm_s", LAT_RTOL), ("comp_s", LAT_RTOL),
         ("loss", LOSS_RTOL))
TOPOLOGIES = {
    "ring": lambda: jt.laplacian_mixing(jt.ring(N)),
    "torus": lambda: jt.laplacian_mixing(jt.torus_2d(3, 3)),
    "er_mh": lambda: jt.metropolis_hastings_mixing(jt.erdos_renyi(1, N, 0.4)),
    "star": lambda: jt.laplacian_mixing(jt.star(N)),
}
FAULTS = dict(churn_p_off=0.2, churn_p_on=0.6, straggler_prob=0.3,
              fading_rho=0.5)


def _np(tree):
    return None if tree is None else {k: np.asarray(v)
                                      for k, v in tree.items()}


def _problem():
    params, loss_fn, make_batches, _ = make_linear_problem()
    return params, loss_fn, make_batches


def _tbatches(make_batches):
    return lambda t, n: _np(make_batches(t, n))


def _both(jcfg, w, eval_batch=None, engine="scan"):
    """The same gossip run through both packages: ((ref params, ref logs),
    (port params, port logs))."""
    params, loss_fn, make_batches = _problem()
    ref = jdz.run_gossip(jcfg, loss_fn, params, make_batches, w,
                         eval_batch=eval_batch)
    port = tdz.run_gossip(convert.gossip_config_from_jax(jcfg), _loss_t,
                          _np(params), _tbatches(make_batches), w,
                          eval_batch=_np(eval_batch), engine=engine,
                          device="cpu")
    return ref, port


def _assert_logs(jl, tl, drift_atol=DRIFT_ATOL):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f),
                                      err_msg=f)
        assert getattr(tl, f).dtype == np.float32
    for f, rtol in CLOSE:
        np.testing.assert_allclose(getattr(tl, f), getattr(jl, f),
                                   rtol=rtol, err_msg=f)
    np.testing.assert_allclose(tl.consensus_err, jl.consensus_err,
                               rtol=DRIFT_RTOL, atol=drift_atol)


def _assert_params(jp, tp):
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == np.asarray(jp[k]).shape
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=PARAM_ATOL, rtol=0)


def _assert_bitwise(a, b):
    for f in dataclasses.fields(tdz.GossipLogs):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                      err_msg=f.name)


# ---------------------------------------------------------------------------
# (a) run_gossip against the JAX engine; host loop == scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_gossip_matches_reference(topology):
    cfg = jdz.GossipConfig(n_nodes=N, rounds=5)
    (jp, jl), (tp, tl) = _both(cfg, TOPOLOGIES[topology]())
    _assert_logs(jl, tl)
    _assert_params(jp, tp)
    assert tl.loss.shape == (5,)


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_gossip_host_equals_scan_bitwise(topology):
    params, _, make_batches = _problem()
    cfg = convert.gossip_config_from_jax(jdz.GossipConfig(n_nodes=N,
                                                          rounds=5))
    w = TOPOLOGIES[topology]()
    runs = [tdz.run_gossip(cfg, _loss_t, _np(params), _tbatches(make_batches),
                           w, engine=e, device="cpu") for e in ("scan",
                                                                "host")]
    _assert_bitwise(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0]["w"], runs[1][0]["w"])


@pytest.mark.parametrize("topology", ["torus", "er_mh"])
@pytest.mark.parametrize("compression", ["topk", "qsgd"])
def test_gossip_compressed_matches_reference(compression, topology):
    cfg = jdz.GossipConfig(n_nodes=N, rounds=4, compression=compression,
                           compression_params=compression_params(k=4))
    w = TOPOLOGIES[topology]()
    (jp, jl), (tp, tl) = _both(cfg, w)
    _assert_logs(jl, tl)
    _assert_params(jp, tp)
    _, hl = _both(cfg, w, engine="host")[1]
    _assert_bitwise(tl, hl)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("levels", [8.0, 256.0])
def test_gossip_qsgd_any_seed_no_flip(seed, levels):
    """QSGD at seeds 0-4: the price a round equals the reference program's
    (a non-integer price times the edge count; 32 d model bits price the
    d-dim message itself), and no dither flips at N = 9, d = 32 (the final
    params hold to atol 1e-5)."""
    cfg = jdz.GossipConfig(n_nodes=N, rounds=4, compression="qsgd",
                           compression_params=compression_params(
                               levels=levels), seed=seed,
                           model_bits=32.0 * 32)
    (jp, jl), (tp, tl) = _both(cfg, TOPOLOGIES["torus"]())
    assert jl.uplink_bits[0] % 1 != 0
    _assert_logs(jl, tl)
    flips = np.abs(tp["w"].numpy() - np.asarray(jp["w"])) > PARAM_ATOL
    assert flips.sum() == 0, f"{flips.sum()} dither flips"


@pytest.mark.parametrize("compression", ["sign", "scaled_sign", "none"])
def test_gossip_faults_match_reference(compression):
    cfg = jdz.GossipConfig(n_nodes=N, rounds=5, compression=compression,
                           faults=fault_params(**FAULTS))
    w = TOPOLOGIES["er_mh"]()
    (jp, jl), (tp, tl) = _both(cfg, w)
    _assert_logs(jl, tl)
    _assert_params(jp, tp)
    assert (tl.n_online < N).any()
    _, hl = _both(cfg, w, engine="host")[1]
    _assert_bitwise(tl, hl)


@pytest.mark.parametrize("algorithm,ap", [
    ("fedavg_m", dict(lr=0.05, momentum=0.9)),
    ("fedprox", dict(lr=0.1, prox_mu=0.5)),
    ("fedavg", dict(lr=0.1))])
def test_gossip_algorithms_match_reference(algorithm, ap):
    cfg = jdz.GossipConfig(n_nodes=N, rounds=4, algorithm=algorithm,
                           algo_params=jalg.algo_params(**ap),
                           compression="topk",
                           compression_params=compression_params(k=8))
    (jp, jl), (tp, tl) = _both(cfg, TOPOLOGIES["ring"]())
    _assert_logs(jl, tl)
    _assert_params(jp, tp)


@pytest.mark.parametrize("engine", ["scan", "host"])
def test_gossip_eval_batch_matches_reference(engine):
    _, _, make_batches = _problem()
    eval_batch = jax.tree.map(lambda a: a[0, 0], make_batches(99, N))
    cfg = jdz.GossipConfig(n_nodes=N, rounds=8)
    (jp, jl), (tp, tl) = _both(cfg, TOPOLOGIES["torus"](), eval_batch,
                               engine=engine)
    _assert_logs(jl, tl)
    _assert_params(jp, tp)
    assert tl.loss[-1] < 0.5 * tl.loss[0]


@pytest.mark.parametrize("model_bits,wcfg", [
    (1e6, dict()), (512.0, dict(bandwidth_hz=1e6, cell_radius_m=200.0))])
def test_gossip_channel_and_prices_match_reference(model_bits, wcfg):
    params, loss_fn, make_batches = _problem()
    cfg = jdz.GossipConfig(n_nodes=N, rounds=4, model_bits=model_bits,
                           compression="blockwise_scaled_sign",
                           compression_params=compression_params(block=8))
    w = TOPOLOGIES["torus"]()
    jp, jl = jdz.run_gossip(cfg, loss_fn, params, make_batches, w,
                            wcfg=jwl.WirelessConfig(n_devices=N, **wcfg))
    tp, tl = tdz.run_gossip(convert.gossip_config_from_jax(cfg), _loss_t,
                            _np(params), _tbatches(make_batches), w,
                            wcfg=twl.WirelessConfig(n_devices=N, **wcfg),
                            device="cpu")
    _assert_logs(jl, tl)
    _assert_params(jp, tp)


# ---------------------------------------------------------------------------
# (b) numpy reference, offline nodes, the sweep, trace counts
# ---------------------------------------------------------------------------
def test_consensus_matches_numpy_reference():
    """The T+1-round run's extra round: the exchange is numpy's float32
    ``W @ X_T`` of the T-round per-node params, then the local delta."""
    params, _, make_batches = _problem()
    w = TOPOLOGIES["torus"]()
    runs = [tdz.run_gossip(tdz.GossipConfig(n_nodes=N, rounds=r,
                                            comp_latency_s=0.0),
                           _loss_t, _np(params), _tbatches(make_batches), w,
                           device="cpu")[0] for r in (3, 4)]
    x_t = runs[0]["w"].numpy()
    mixed = np.asarray(w, np.float32) @ x_t
    algo = jalg.get_algorithm("fedavg")
    _, loss_fn, _ = _problem()
    deltas, _, _ = jax.vmap(lambda p, b: algo.client_update(
        loss_fn, jalg.default_algo_params(), {"w": p}, b, None))(
        jnp.asarray(mixed), make_batches(3, N))
    np.testing.assert_allclose(runs[1]["w"].numpy(),
                               mixed + np.asarray(deltas["w"]),
                               rtol=1e-5, atol=1e-6)


def test_all_offline_keeps_models_bitwise():
    params, _, make_batches = _problem()
    cfg = tdz.GossipConfig(n_nodes=N, rounds=4, compression="qsgd",
                           faults=tfaults.fault_params(churn_p_off=1.0,
                                                       churn_p_on=0.0))
    ps, logs = tdz.run_gossip(cfg, _loss_t, _np(params),
                              _tbatches(make_batches),
                              TOPOLOGIES["er_mh"](), device="cpu")
    x0 = np.tile(np.asarray(params["w"], np.float32)[None], (N, 1))
    np.testing.assert_array_equal(ps["w"].numpy(), x0)
    assert (logs.n_online == 0).all() and (logs.n_edges == 0).all()
    assert (logs.comp_s == 0).all() and (logs.comm_s == 0).all()


def _sweep_kw(faults: bool):
    kw = dict(wgrid=[TOPOLOGIES["ring"](), TOPOLOGIES["er_mh"]()],
              seeds=(0, 1), cparams_grid=[compression_params(k=2),
                                          compression_params(k=6)])
    if faults:
        kw["fparams_grid"] = [fault_params(churn_p_off=p, churn_p_on=0.5)
                              for p in (0.0, 0.3)]
    return kw


def _port_sweep_kw(kw):
    out = dict(kw)
    out["cparams_grid"] = [convert.compression_params_from_jax(p)
                           for p in kw["cparams_grid"]]
    if "fparams_grid" in kw:
        out["fparams_grid"] = [convert.fault_params_from_jax(p)
                               for p in kw["fparams_grid"]]
    return out


@pytest.mark.parametrize("faults", [False, True])
def test_sweep_matches_reference_and_single_runs(faults):
    """The row-major product grid: each variant against the reference's
    vmapped sweep, and bitwise the port's single run of that variant."""
    params, loss_fn, make_batches = _problem()
    cfg = jdz.GossipConfig(n_nodes=N, rounds=3, compression="topk")
    kw = _sweep_kw(faults)
    jl = jdz.run_gossip_sweep(cfg, loss_fn, params, make_batches, **kw)
    tcfg = convert.gossip_config_from_jax(cfg)
    tkw = _port_sweep_kw(kw)
    tl = tdz.run_gossip_sweep(tcfg, _loss_t, _np(params),
                              _tbatches(make_batches), device="cpu", **tkw)
    n_var = 2 * 2 * 2 * (2 if faults else 1)
    assert tl.loss.shape == (n_var, 3)
    _assert_logs(jl, tl)
    grid = [(s, w, c, f) for s in (0, 1) for w in range(2) for c in range(2)
            for f in range(2 if faults else 1)]
    for v, (s, wi, ci, fi) in enumerate(grid):
        one = dataclasses.replace(
            tcfg, seed=s, compression_params=tkw["cparams_grid"][ci],
            faults=tkw["fparams_grid"][fi] if faults else None)
        _, single = tdz.run_gossip(one, _loss_t, _np(params),
                                   _tbatches(make_batches),
                                   kw["wgrid"][wi], device="cpu")
        for f in dataclasses.fields(tdz.GossipLogs):
            np.testing.assert_array_equal(getattr(tl, f.name)[v],
                                          getattr(single, f.name),
                                          err_msg=f"{v} {f.name}")


def test_trace_counts_match_reference():
    """One sequence of calls through both packages, each call's new traces
    counted: a new W of the same shape costs none, a topology grid one, a
    fault grid one, the host loop one, a new problem size one."""
    params, loss_fn, make_batches = _problem()
    p16, loss16, batches16, _ = make_linear_problem(d=16)
    ring, star = TOPOLOGIES["ring"](), TOPOLOGIES["star"]()
    cfg = jdz.GossipConfig(n_nodes=N, rounds=3)
    tcfg = convert.gossip_config_from_jax(cfg)
    wgrid = [jt.laplacian_mixing(a)
             for a in jt.standard_adjacencies(N, seed=2).values()]
    fgrid = [fault_params(churn_p_off=p, churn_p_on=0.5)
             for p in (0.0, 0.2, 0.5)]
    calls = [
        ("single ring", lambda: jdz.run_gossip(cfg, loss_fn, params,
                                               make_batches, ring),
         lambda: tdz.run_gossip(tcfg, _loss_t, _np(params),
                                _tbatches(make_batches), ring,
                                device="cpu")),
        ("single star", lambda: jdz.run_gossip(cfg, loss_fn, params,
                                               make_batches, star),
         lambda: tdz.run_gossip(tcfg, _loss_t, _np(params),
                                _tbatches(make_batches), star,
                                device="cpu")),
        ("host", lambda: jdz.run_gossip(cfg, loss_fn, params, make_batches,
                                        ring, engine="host"),
         lambda: tdz.run_gossip(tcfg, _loss_t, _np(params),
                                _tbatches(make_batches), ring,
                                engine="host", device="cpu")),
        ("host again", lambda: jdz.run_gossip(cfg, loss_fn, params,
                                              make_batches, star,
                                              engine="host"),
         lambda: tdz.run_gossip(tcfg, _loss_t, _np(params),
                                _tbatches(make_batches), star,
                                engine="host", device="cpu")),
        ("grid", lambda: jdz.run_gossip_sweep(cfg, loss_fn, params,
                                              make_batches, wgrid=wgrid,
                                              seeds=(0, 1)),
         lambda: tdz.run_gossip_sweep(tcfg, _loss_t, _np(params),
                                      _tbatches(make_batches), wgrid=wgrid,
                                      seeds=(0, 1), device="cpu")),
        ("grid again", lambda: jdz.run_gossip_sweep(
            cfg, loss_fn, params, make_batches, wgrid=wgrid[::-1],
            seeds=(2, 3)),
         lambda: tdz.run_gossip_sweep(
            tcfg, _loss_t, _np(params), _tbatches(make_batches),
            wgrid=wgrid[::-1], seeds=(2, 3), device="cpu")),
        ("fault grid", lambda: jdz.run_gossip_sweep(
            cfg, loss_fn, params, make_batches, wgrid=[ring],
            fparams_grid=fgrid),
         lambda: tdz.run_gossip_sweep(
            tcfg, _loss_t, _np(params), _tbatches(make_batches),
            wgrid=[ring], device="cpu",
            fparams_grid=[convert.fault_params_from_jax(p) for p in fgrid])),
        ("d = 16", lambda: jdz.run_gossip(cfg, loss16, p16, batches16, ring),
         lambda: tdz.run_gossip(tcfg, _loss_t, _np(p16),
                                _tbatches(batches16), ring, device="cpu")),
    ]
    jrt._ENGINE_CACHE.clear()
    trt._ENGINE_CACHE.clear()
    counts = {}
    for what, jcall, tcall in calls:
        counts[what] = []
        for stats, call in ((jrt.ENGINE_STATS, jcall),
                            (trt.ENGINE_STATS, tcall)):
            before = stats["traces"]
            call()
            counts[what].append(stats["traces"] - before)
    assert all(j == t for j, t in counts.values()), counts
    assert counts["single star"] == [0, 0] and counts["grid"] == [1, 1]
    assert counts["host"] == [1, 1] and counts["host again"] == [0, 0]


# ---------------------------------------------------------------------------
# (c) the example's LM cell, round by round from the reference's state
# ---------------------------------------------------------------------------
def test_lm_cell_counts_dither_flips():
    """``examples/decentralized_gossip.py``'s ring cell (N = 16, D = 5120,
    QSGD at 256 levels, 1e6 model bits, lr 0.5, the eval batch): each
    round of the port starts from the reference's round state. Every log
    value holds to the contract; an edge message's coordinate may round to
    the neighbouring QSGD level (the packages' message norms differ by
    ulps), which moves that edge's EF element by exactly one step ``||m|| /
    levels``: such flips are counted, and a node that receives none holds
    its model to atol 1e-5."""
    from repro.core import wireless as jwl
    n, rounds, levels = 16, 3, 256.0
    params, loss_fn, sample, eval_fn = make_lm_problem(n_clients=n,
                                                       alpha=0.5)
    cfg = jdz.GossipConfig(n_nodes=n, rounds=rounds, compression="qsgd",
                           model_bits=1e6,
                           algo_params=jalg.algo_params(lr=0.5))
    w = jt.laplacian_mixing(jt.ring(n))
    eb = eval_fn.eval_batch
    init_carry, _, _ = jdz._make_gossip_fns(cfg, loss_fn, True)
    jstep = jdz._get_gossip_host_step(cfg, loss_fn, True)
    chan = jwl.channel_params(jwl.WirelessConfig(n_devices=n))
    cparams = jdz._resolve_cparams(cfg, params)
    k_pos, k_rounds = jax.random.split(jax.random.PRNGKey(cfg.seed))
    dist = jwl.pairwise_dist_jax(jwl.sample_positions_xy_jax(k_pos, chan, n))
    wj = jnp.asarray(w, jnp.float32)

    tcfg = convert.gossip_config_from_jax(cfg)
    eng = tdz._GossipEngine(tcfg, _lm_loss_t, True)
    tparams = convert.params_from_jax(params)
    v = eng.variant(convert.key_from_jax(jax.random.PRNGKey(cfg.seed)),
                    twl.channel_params(twl.WirelessConfig(n_devices=n)),
                    convert.compression_params_from_jax(
                        cparams), convert.algo_params_from_jax(
                        cfg.algo_params), torch.tensor(
                        tdz._check_w(w, n)), None, tparams)
    np.testing.assert_array_equal(v.dist_nn.numpy(), np.asarray(dist))
    carry = init_carry(params)
    n_flips = 0
    for t in range(rounds):
        bt = sample(t, n)
        x, ef, clock = jax.device_get(carry)
        inp = np.asarray(x)[:, None, :] + np.asarray(ef)
        carry, jout = jstep(chan, cparams, cfg.algo_params, None, wj, dist,
                            k_rounds, params, eb, carry, jnp.int32(t), bt)
        tc = tdz._GossipCarry(*(torch.tensor(np.array(a))
                                for a in (x, ef, clock)))
        tnew, tout = eng.step(t, tc, v, convert.params_from_jax(bt),
                              convert.params_from_jax(eb))
        jout = [np.asarray(a) for a in jout]
        for i in (4, 5, 7, 8):
            np.testing.assert_array_equal(tout[i].numpy(), jout[i])
        for i, rtol in ((1, LAT_RTOL), (2, LAT_RTOL), (3, LAT_RTOL),
                        (0, LOSS_RTOL), (6, DRIFT_RTOL)):
            np.testing.assert_allclose(tout[i].numpy(), jout[i], rtol=rtol)
        je, te = np.asarray(carry[1]), tnew.ef.numpy()
        flips = np.argwhere(~np.isclose(te, je, rtol=1e-5, atol=1e-6))
        receivers = np.zeros(n, bool)
        for s, d, k in flips:
            step = np.linalg.norm(inp[s, d]) / levels
            np.testing.assert_allclose(abs(te[s, d, k] - je[s, d, k]), step,
                                       rtol=1e-3)
            receivers[d] = True
        n_flips += len(flips)
        jx, tx = np.asarray(carry[0]), tnew.x.numpy()
        np.testing.assert_allclose(tx[~receivers], jx[~receivers],
                                   atol=PARAM_ATOL, rtol=0)
        assert len(flips) <= 8, f"round {t}: {len(flips)} dither flips"
    assert n_flips <= 8 * rounds


# ---------------------------------------------------------------------------
# (d) errors, seed-era helpers, conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,exc", [
    (dict(algorithm="scaffold"), ValueError),
    (dict(compression="middle-out"), ValueError),
    (dict(gossip_steps=0), ValueError),
    (dict(mixing="magic"), ValueError),
    (dict(n_nodes=1), ValueError),
    (dict(faults={"drop_prob": 0.5}), TypeError)])
def test_config_errors_match_reference(kw, exc):
    with pytest.raises(exc) as jerr:
        jdz.GossipConfig(**kw)
    with pytest.raises(exc) as terr:
        tdz.GossipConfig(**kw)
    if "faults" in kw:
        assert "GossipConfig.faults must be a FaultParams" in str(terr.value)
    elif "compression" in kw:
        assert "unknown compressor 'middle-out'" in str(terr.value)
    else:
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("w", [jt.ring(N), jt.laplacian_mixing(jt.ring(N + 1)),
                               np.full((N, N), 1.0 / N) + 1e-4])
def test_bad_w_errors_match_reference(w):
    with pytest.raises(ValueError) as jerr:
        jdz._check_w(w, N)
    with pytest.raises(ValueError) as terr:
        tdz._check_w(w, N)
    assert str(terr.value) == str(jerr.value)
    params, _, make_batches = _problem()
    with pytest.raises(ValueError, match="mixing matrix"):
        tdz.run_gossip(tdz.GossipConfig(n_nodes=N, rounds=2), _loss_t,
                       _np(params), _tbatches(make_batches), w, device="cpu")


def test_check_w_float32_and_tolerance_match_reference():
    w = jt.laplacian_mixing(jt.torus_2d(3, 3))
    w_off = w.copy()
    w_off[0, 0] += 5e-6
    for m in (w, w_off):
        got = tdz._check_w(m, N)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(jdz._check_w(m, N)))


def test_engine_argument_errors():
    params, _, make_batches = _problem()
    cfg = tdz.GossipConfig(n_nodes=N, rounds=2)
    with pytest.raises(ValueError, match="engine must be"):
        tdz.run_gossip(cfg, _loss_t, _np(params), _tbatches(make_batches),
                       TOPOLOGIES["ring"](), engine="vmap", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdz.run_gossip(cfg, _loss_t, _np(params),
                           _tbatches(make_batches), TOPOLOGIES["ring"]())


def test_consensus_step_and_gossip_round_match_reference():
    rng = np.random.default_rng(0)
    w = TOPOLOGIES["torus"]().astype(np.float32)
    cp = {"w": rng.normal(size=(N, 32)).astype(np.float32),
          "b": rng.normal(size=(N, 2, 3)).astype(np.float32)}
    jm = jdz.consensus_step(jax.tree.map(jnp.asarray, cp), jnp.asarray(w))
    tm = tdz.consensus_step(convert.params_from_jax(cp), w)
    for k in cp:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-6, atol=1e-6)
    params, loss_fn, make_batches = _problem()
    xs = {"w": rng.normal(size=(N, 32)).astype(np.float32)}
    b = jax.tree.map(lambda a: a[:, 0], make_batches(0, N))
    jp, jloss = jdz.gossip_round(jax.tree.map(jnp.asarray, xs),
                                 jnp.asarray(w), b, loss_fn, 0.1)
    tp, tloss = tdz.gossip_round(convert.params_from_jax(xs), w,
                                 convert.params_from_jax(b), _loss_t, 0.1)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_gossip_config_from_jax():
    jc = jdz.GossipConfig(n_nodes=12, rounds=7, algorithm="fedprox",
                          algo_params=jalg.algo_params(lr=0.3, prox_mu=0.1),
                          seed=4, model_bits=2e5, comp_latency_s=0.1,
                          compression="qsgd",
                          compression_params=compression_params(levels=8),
                          faults=fault_params(drop_prob=0.1),
                          gossip_steps=3, d2d_radius_m=120.0, mixing="mh")
    tc = convert.gossip_config_from_jax(jc)
    assert tc.static_key() == jc.static_key()
    for name in ("algo_params", "compression_params", "faults"):
        for f, a in zip(getattr(jc, name)._fields, getattr(jc, name)):
            assert float(getattr(getattr(tc, name), f)) == float(a)
    plain = convert.gossip_config_from_jax(jdz.GossipConfig())
    assert plain == tdz.GossipConfig()
