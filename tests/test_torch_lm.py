"""The port's LM path through the flat engine against the JAX package, on
the CPU: the data pipeline, the client, and the two examples that train the
transformer LM federated.

(a) ``FederatedLoader`` and ``batch_iterator`` bitwise the reference's (the
    same index streams from ``np.random.default_rng(seed)``).
(b) ``fl/client.py``: ``local_sgd``, ``make_client_step`` and
    ``compute_gradient`` on gemma-2b's ``reduced()`` model.
(c) ``examples/quickstart.py``'s cell at its width (gemma-2b ``reduced()``,
    N = 12, 4 scheduled by age, H = 2, batch 4, seq 32, Dirichlet 0.3, 2%
    top-k with EF, lr 2e-3, 32 x param_count model bits) through
    ``run_simulation_scan`` for QS_ROUNDS rounds: at N * D = 6.5e6 the
    rows go through ``rows_compressor``'s kernel-backed top-k (its plain
    version on the CPU), as the reference's do.
(d) ``examples/private_fl.py``'s runs: none, secagg and secagg_dp (clip 1.0,
    sigma 0.5) and its dp sweep at sigma 0.3, 1.0, 3.0, for PF_ROUNDS rounds.
(e) What lets a 744M-wide message through the engine on one card:
    ``chunking.CanonicalFold`` bitwise ``canonical_sum`` of the stacked
    block partials (signed zeros included), and ``fl_round(donate=True)``
    (the engine's call: EF and ctrl rows written into the given state)
    bitwise the functional round.

Parity contract: participation bitwise; uplink, downlink and mask bits
equal; latency within rtol 1e-5; loss within rtol 1e-4; epsilon within rtol
1e-5. The final params of (c) within atol 1e-5 but for at most
FLIP_MAX coordinates: the two packages' deltas differ by ulps, so where two
|values| of a client row lie within an ulp of each other at the top-k
threshold, the packages keep different coordinates (each kept coordinate
then moves the mean by a quarter of a threshold-sized value). Client
deltas and gradients within rtol 1e-4 / atol 1e-6, losses within rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.core.compression import compression_params  # noqa: E402
from repro.core.privacy import privacy_params  # noqa: E402
from repro.fl import client as jclient  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs, convert, data  # noqa: E402
from repro_torch.core import chunking  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core.algorithms import registry as talg  # noqa: E402
from repro_torch.core.compression import registry as tcomp  # noqa: E402
from repro_torch.core.privacy import registry as tpriv  # noqa: E402
from repro_torch.fl import client as tclient  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from repro_torch.fl import server as tserver  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from test_torch_hfl import _keep_engine_caches  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch ops of this file on one thread: the test run spreads files over
    several processes on one host, where the LM's many small ops stall on
    oversubscribed intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, SCHED, H, B, SEQ = 12, 4, 2, 4, 32
QS_ROUNDS, PF_ROUNDS, FLIP_MAX = 5, 3, 8
LOSS_RTOL, LAT_RTOL, EPS_RTOL = 1e-4, 1e-5, 1e-5
EXACT = ("participation", "n_scheduled", "uplink_bits", "downlink_bits",
         "mask_bits")
SIGMAS = (0.3, 1.0, 3.0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _cell():
    """The examples' data, the reference's and the port's model on it."""
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    cfg = configs.get_config("gemma-2b").reduced()
    ds = data.SyntheticLMDataset(cfg.vocab_size, seq_len=SEQ,
                                 n_sequences=2048)
    parts = data.dirichlet_partition(ds.class_of(np.arange(len(ds))), N,
                                     alpha=0.3, min_per_client=8)
    return jcfg, cfg, ds, parts


def _rounds(ds, parts, rounds):
    loader = data.FederatedLoader(ds, parts, batch=B, local_steps=H)
    rs = [loader.next_round() for _ in range(rounds)]
    return {k: np.stack([r[k] for r in rs]) for k in rs[0]}


def _params(jcfg):
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp))


def _assert_logs(got, want):
    for f in EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f, rtol in (("latency_s", LAT_RTOL), ("comm_s", LAT_RTOL),
                    ("comp_s", LAT_RTOL), ("loss", LOSS_RTOL),
                    ("epsilon", EPS_RTOL)):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# (a) the pipeline
# ---------------------------------------------------------------------------
def test_federated_loader_and_batch_iterator_bitwise():
    jds = jdata.SyntheticLMDataset(64, seq_len=9, n_sequences=300, seed=3)
    tds = data.SyntheticLMDataset(64, seq_len=9, n_sequences=300, seed=3)
    assert np.array_equal(jds.tokens, tds.tokens)
    parts = data.dirichlet_partition(tds.class_of(np.arange(300)), 5,
                                     alpha=0.3, min_per_client=4)
    jl = jdata.FederatedLoader(jds, parts, batch=3, local_steps=2, seed=7)
    tl = data.FederatedLoader(tds, parts, batch=3, local_steps=2, seed=7)
    assert tl.n_clients == jl.n_clients == 5
    for _ in range(3):
        want, got = jl.next_round(), tl.next_round()
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == (5, 2, 3, 9)
            np.testing.assert_array_equal(got[k], want[k])
    ji, ti = jdata.batch_iterator(jds, 4, seed=2), data.batch_iterator(
        tds, 4, seed=2)
    for _ in range(3):
        want, got = next(ji), next(ti)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# (b) the client
# ---------------------------------------------------------------------------
def test_client_matches_reference():
    jcfg, cfg, ds, parts = _cell()
    jp, tp = _params(jcfg)
    r = _rounds(ds, parts, 1)
    batches = {k: v[0, :3] for k, v in r.items()}  # 3 clients, (3, H, B, S)

    def jloss(p, b):
        return jtf.lm_loss(p, jcfg, b, remat=False)

    def tloss(p, b):
        return ttf.lm_loss(p, cfg, b)

    def close(got, want):
        want = convert.lm_params_from_jax(jax.tree.map(np.asarray, want))
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)

    one = {k: v[0] for k, v in batches.items()}
    jd, jfin, jl = jclient.local_sgd(
        jloss, jp, {k: jnp.asarray(v) for k, v in one.items()}, 2e-3, 0.9)
    td, tfin, tl = tclient.local_sgd(tloss, tp,
                                     {k: _t(v) for k, v in one.items()},
                                     2e-3, 0.9)
    close(td, jd)
    close(tfin, jfin)
    torch.testing.assert_close(tl, _t(jl), rtol=1e-5, atol=0)
    jds, jls = jclient.make_client_step(jloss, 2e-3)(
        jp, {k: jnp.asarray(v) for k, v in batches.items()})
    tds, tls = tclient.make_client_step(tloss, 2e-3)(
        tp, {k: _t(v) for k, v in batches.items()})
    assert tls.shape == (3,)
    close(tds, jds)
    torch.testing.assert_close(tls, _t(jls), rtol=1e-5, atol=0)
    b0 = {k: v[0] for k, v in one.items()}
    jg, jl = jclient.compute_gradient(jloss, jp, {k: jnp.asarray(v)
                                                  for k, v in b0.items()})
    tg, tl = tclient.compute_gradient(tloss, tp, {k: _t(v)
                                                  for k, v in b0.items()})
    close(tg, jg)
    torch.testing.assert_close(tl, _t(jl), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# (c) examples/quickstart.py's engine run
# ---------------------------------------------------------------------------
def test_quickstart_engine_matches_reference():
    jcfg, cfg, ds, parts = _cell()
    jp, tp = _params(jcfg)
    d = talg.flat_dim(tp)
    assert N * d >= tcomp.KERNEL_DISPATCH_MIN_ELEMS  # the kernel's path
    batches = _rounds(ds, parts, QS_ROUNDS)
    kw = dict(n_devices=N, n_scheduled=SCHED, rounds=QS_ROUNDS,
              local_steps=H, policy="age", compression="topk",
              model_bits=32.0 * cfg.param_count())
    jcfg_sim = jrt.SimConfig(algo_params=jrt.algo_params(lr=2e-3),
                             compression_params=compression_params(
                                 k=max(1, d // 50)), **kw)
    tcfg_sim = trt.SimConfig(algo_params=talg.algo_params(lr=2e-3),
                             compression_params=tcomp.compression_params(
                                 k=max(1, d // 50)), **kw)
    jfin, jl = jrt.run_simulation_scan(
        jcfg_sim, lambda p, b: jtf.lm_loss(p, jcfg, b, remat=False), jp,
        {k: jnp.asarray(v) for k, v in batches.items()})
    tfin, tl = trt.run_simulation_scan(
        tcfg_sim, lambda p, b: ttf.lm_loss(p, cfg, b, remat=False), tp,
        {k: _t(v) for k, v in batches.items()}, device="cpu")
    _assert_logs(tl, jl)
    assert tl.loss[-1] < tl.loss[0]
    want = convert.lm_params_from_jax(jax.tree.map(np.asarray, jfin))
    off = sum(int(((tfin[k] - want[k]).abs() > 1e-5).sum()) for k in want)
    assert off <= FLIP_MAX, off
    for k in want:
        torch.testing.assert_close(tfin[k], want[k], rtol=0, atol=1e-4)
    # the example's entry point runs the same scan
    logs = trt.run_simulation(
        tcfg_sim, lambda p, b: ttf.lm_loss(p, cfg, b, remat=False), tp,
        lambda t, n: {k: _t(v[t]) for k, v in batches.items()},
        device="cpu")
    assert [lg.loss for lg in logs] == tl.loss.tolist()


# ---------------------------------------------------------------------------
# (d) examples/private_fl.py's runs and its dp sweep
# ---------------------------------------------------------------------------
def _pf_configs(cfg, privacy, rounds):
    kw = dict(n_devices=N, n_scheduled=SCHED, rounds=rounds, local_steps=H,
              policy="age", privacy=privacy,
              model_bits=32.0 * cfg.param_count())
    return (jrt.SimConfig(algo_params=jrt.algo_params(lr=2e-3),
                          privacy_params=privacy_params(clip=1.0, sigma=0.5),
                          **kw),
            trt.SimConfig(algo_params=talg.algo_params(lr=2e-3),
                          privacy_params=tpriv.privacy_params(clip=1.0,
                                                              sigma=0.5),
                          **kw))


@pytest.mark.parametrize("privacy", ["none", "secagg", "secagg_dp"])
def test_private_fl_run_matches_reference(privacy):
    jcfg, cfg, ds, parts = _cell()
    jp, tp = _params(jcfg)
    batches = _rounds(ds, parts, PF_ROUNDS)
    jsim, tsim = _pf_configs(cfg, privacy, PF_ROUNDS)
    _, jl = jrt.run_simulation_scan(
        jsim, lambda p, b: jtf.lm_loss(p, jcfg, b, remat=False), jp,
        {k: jnp.asarray(v) for k, v in batches.items()})
    _, tl = trt.run_simulation_scan(
        tsim, lambda p, b: ttf.lm_loss(p, cfg, b, remat=False), tp,
        {k: _t(v) for k, v in batches.items()}, device="cpu")
    _assert_logs(tl, jl)
    assert (tl.mask_bits > 0).all() == (privacy != "none")


def test_private_fl_dp_sweep_matches_reference():
    jcfg, cfg, ds, parts = _cell()
    jp, tp = _params(jcfg)
    batches = _rounds(ds, parts, PF_ROUNDS)
    jsim, tsim = _pf_configs(cfg, "dp", PF_ROUNDS)
    jres = jrt.run_sweep(
        jsim, lambda p, b: jtf.lm_loss(p, jcfg, b, remat=False), jp,
        {k: jnp.asarray(v) for k, v in batches.items()}, seeds=[0],
        privacies=["dp"],
        pparams_grid=[privacy_params(clip=1.0, sigma=s) for s in SIGMAS])
    tres = trt.run_sweep(
        tsim, lambda p, b: ttf.lm_loss(p, cfg, b, remat=False), tp,
        {k: _t(v) for k, v in batches.items()}, seeds=[0], privacies=["dp"],
        pparams_grid=[tpriv.privacy_params(clip=1.0, sigma=s)
                      for s in SIGMAS], device="cpu")
    assert list(tres) == list(jres) == [("age", "dp")]
    got, want = tres[("age", "dp")], jres[("age", "dp")]
    assert got.loss.shape == (len(SIGMAS), PF_ROUNDS)
    _assert_logs(got, want)
    # more noise, less privacy loss
    assert (np.diff(got.epsilon[:, -1]) < 0).all()


# ---------------------------------------------------------------------------
# (e) the engine's memory at the LM's width
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [1, 2, 3, 5, 12, 16])
def test_canonical_fold_bitwise_canonical_sum(m):
    rng = np.random.default_rng(m)
    parts = (rng.normal(size=(m, 9)) * 10.0 ** rng.uniform(-4, 4, (m, 1)))
    parts[:, 0] = -0.0  # a column of negative zeros: +0.0 padding shows
    parts = torch.as_tensor(parts.astype(np.float32))
    fold = chunking.CanonicalFold()
    for part in parts:
        fold.add(part)
    want = chunking.canonical_sum(parts)
    assert torch.equal(fold.total().view(torch.int32),
                       want.view(torch.int32))


@pytest.mark.parametrize("algo", ["fedavg", "scaffold"])
def test_fl_round_donate_bitwise_functional(algo):
    n, d, chunk = 5, 16, 2
    rng = np.random.default_rng(0)
    params = {"w": torch.as_tensor(rng.normal(size=d).astype(np.float32))}
    batches = {"x": torch.as_tensor(rng.normal(size=(n, H, 8, d))
                                    .astype(np.float32)),
               "y": torch.as_tensor(rng.normal(size=(n, H, 8))
                                    .astype(np.float32))}

    def loss(p, b):
        return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}

    def state():
        st = tserver.init_fl_state(params, n, algo=algo, use_ef=True,
                                   n_rows=6)
        st.client_error.normal_(generator=torch.Generator().manual_seed(1))
        return st

    kw = dict(algo=algo, participation=torch.tensor([1., 0., 1., 1., 0.]),
              compression_name="topk",
              cparams=tcomp.compression_params(k=3),
              key=trandom.PRNGKey(4), chunk_size=chunk)
    kept = state()
    want, wm = tserver.fl_round(kept, batches, loss, **kw)
    assert torch.equal(kept.client_error, state().client_error)  # a copy
    given = state()
    got, gm = tserver.fl_round(given, batches, loss, donate=True, **kw)
    assert got.client_error is given.client_error
    assert got.ctrl is given.ctrl  # None under fedavg
    for a, b in ((got.client_error, want.client_error),
                 (got.params["w"], want.params["w"]),
                 (gm["loss"], wm["loss"]), (gm["uplink_bits"],
                                            wm["uplink_bits"])):
        assert torch.equal(a, b)
    if algo == "scaffold":
        assert torch.equal(got.ctrl, want.ctrl)
