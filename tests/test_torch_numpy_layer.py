"""The port's numpy reference layer against the JAX package's: the position
codec and bit costs of ``core/compression/coding.py``, the numpy half of
``core/wireless.py`` (channel and the update-success analytics of eqs.
47-56) and of ``core/scheduling.py`` (the §III policies).

These are Python and numpy, copied, so they are held bitwise on the same
inputs and generators. Beside that, the port's numpy functions are held
against its own torch twins where both compute the same function:
- the channel on the same float32 inputs: path gain and SNR within rtol
  1e-5 (the twins mirror XLA's float32 log and pow), the Shannon rate within
  ``bw * 2^-22`` absolute plus rtol 1e-6 (``1 + snr`` rounds to float32 in
  the twin), the latency within rtol 1e-6;
- the policies round robin, PF, latency, best channel, BN2, BC-BN2
  (k_c = 2k), BN2-C (d = model_bits / 32, the round is the deadline), the
  deadline greedy and the age greedy select the same sets, with the scores
  tied at the k-th place counted (numpy's quicksort breaks ties in no fixed
  order). Random scheduling draws from numpy's generator on one side and
  threefry on the other, so it is no such pair.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import scheduling as jsched  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.core.compression import coding as jcoding  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import scheduling as tsched  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.core.compression import coding as tcoding  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch ops of this file on one thread (the test run spreads files
    over several processes on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the position codec and bit costs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,nnz,seed", [(1, 1, 0), (64, 1, 1), (100, 7, 2),
                                        (1000, 10, 3), (4096, 4096, 4),
                                        (100_003, 977, 5)])
def test_codec_bitwise(d, nnz, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros(d, bool)
    mask[rng.choice(d, nnz, replace=False)] = True
    idx = tcoding.mask_to_indices(mask.reshape(-1, 1) if d > 1 else mask)
    np.testing.assert_array_equal(idx, jcoding.mask_to_indices(mask))
    assert tcoding._block_size(d, nnz) == jcoding._block_size(d, nnz)
    bits, bs = tcoding.encode_positions(idx, d)
    assert (bits, bs) == jcoding.encode_positions(idx, d)
    assert tcoding.decode_positions(bits, d, bs) == idx.tolist()
    assert len(bits) == tcoding.sparse_message_bits(d, nnz, 0.0)
    for vb in (0.0, 16.0, 32.0):
        assert (tcoding.sparse_message_bits(d, nnz, vb)
                == jcoding.sparse_message_bits(d, nnz, vb))
        assert (tcoding.naive_sparse_bits(d, nnz, vb)
                == jcoding.naive_sparse_bits(d, nnz, vb))
    gaps = np.diff(np.concatenate([[-1], idx])).tolist()
    assert tcoding.elias_gamma_bits(gaps) == jcoding.elias_gamma_bits(gaps)
    assert tcoding.sparse_message_bits(d, 0) == 0.0


def test_codec_rejects_what_the_reference_rejects():
    for fn in (tcoding.encode_positions, jcoding.encode_positions):
        with pytest.raises(AssertionError):
            fn([0, 5], 5)
    # unsorted, repeated indices are sorted and deduplicated on both sides
    assert (tcoding.encode_positions([9, 2, 2, 7], 10)
            == jcoding.encode_positions([9, 2, 2, 7], 10))
    assert (tcoding.elias_gamma_bits([0, 1, 2, 3, 1024])
            == jcoding.elias_gamma_bits([0, 1, 2, 3, 1024]))


# own strategy: dimensions and index sets (no float draws at all)
@given(st.integers(2, 300), st.data())
@settings(max_examples=60, deadline=None)
def test_codec_roundtrip_property(d, data):
    nnz = data.draw(st.integers(1, d))
    idx = sorted(data.draw(st.sets(st.integers(0, d - 1), min_size=nnz,
                                   max_size=nnz)))
    bits, bs = tcoding.encode_positions(idx, d)
    assert tcoding.decode_positions(bits, d, bs) == idx
    assert (bits, bs) == jcoding.encode_positions(idx, d)
    assert len(bits) == tcoding.sparse_message_bits(d, nnz, 0.0)


# ---------------------------------------------------------------------------
# the wireless numpy half
# ---------------------------------------------------------------------------
def _cfgs(**kw):
    return tw.WirelessConfig(**kw), jw.WirelessConfig(**kw)


@pytest.mark.parametrize("kw", [{}, dict(n_devices=5000, cell_radius_m=250.0,
                                          path_loss_exponent=3.7,
                                          tx_power_dbm=23.0)])
def test_channel_numpy_bitwise(kw):
    tcfg, jcfg = _cfgs(**kw)
    pos = tw.sample_positions(np.random.default_rng(1), tcfg)
    np.testing.assert_array_equal(
        pos, jw.sample_positions(np.random.default_rng(1), jcfg))
    fad = tw.sample_fading(np.random.default_rng(2), tcfg.n_devices)
    np.testing.assert_array_equal(
        fad, jw.sample_fading(np.random.default_rng(2), jcfg.n_devices))
    np.testing.assert_array_equal(tw.path_gain(pos, tcfg),
                                  jw.path_gain(pos, jcfg))
    for bw in (None, 1e6):
        s = tw.snr(pos, fad, tcfg, bw)
        np.testing.assert_array_equal(s, jw.snr(pos, fad, jcfg, bw))
    r = tw.shannon_rate(s, 1e6)
    np.testing.assert_array_equal(r, jw.shannon_rate(s, 1e6))
    r[:3] = [0.0, -1.0, 1e-320]  # outages: inf latency
    np.testing.assert_array_equal(tw.comm_latency(1e6, r),
                                  jw.comm_latency(1e6, r))
    for n_alloc in (0, 1, 7):
        np.testing.assert_array_equal(tw.subchannel_rate(s, tcfg, n_alloc),
                                      jw.subchannel_rate(s, jcfg, n_alloc))
    for v in (-30.0, 0.0, 10.0, 23.5):
        assert tw.dbm_to_watt(v) == jw.dbm_to_watt(v)
        assert tw.db_to_lin(v) == jw.db_to_lin(v)


@pytest.mark.parametrize("gamma_db", [20.0, -25.0, 0.0])
def test_update_success_analytics_bitwise(gamma_db):
    """bench_rs_rr_pf.py's grid (K = 4, N = 20, alpha 4) at both regimes
    and the reference test's gamma 1: equal numbers, the same order."""
    k, n, alpha = 4, 20, 4.0
    gamma = 10 ** (gamma_db / 10)
    for noise in (0.0, 0.5):
        v = tw.interference_functional(gamma, alpha, noise)
        assert v == jw.interference_functional(gamma, alpha, noise)
    v = tw.interference_functional(gamma, alpha)
    u = (tw.update_success_rs(k, n, v), tw.update_success_rr(v),
         tw.update_success_pf(k, n, gamma, alpha))
    assert u == (jw.update_success_rs(k, n, v), jw.update_success_rr(v),
                 jw.update_success_pf(k, n, gamma, alpha))
    assert 0 < u[0] < u[1] <= 1 and u[2] >= 0.9 * u[0]
    assert tw.rounds_required(u[0]) == jw.rounds_required(u[0])
    assert (tw.rounds_required_rr(u[1], k, n)
            == jw.rounds_required_rr(u[1], k, n))
    assert tw.rounds_required(1.0) == jw.rounds_required(1.0)


def test_channel_twins_agree():
    """The numpy channel and its torch twins on the same float32 inputs."""
    rng = np.random.default_rng(3)
    cfg = tw.WirelessConfig(n_devices=20_000)
    cp = tw.channel_params(cfg)
    dist = tw.sample_positions(rng, cfg).astype(np.float32)
    fad = tw.sample_fading(rng, cfg.n_devices).astype(np.float32)
    d64, f64 = dist.astype(np.float64), fad.astype(np.float64)
    td, tf = torch.from_numpy(dist), torch.from_numpy(fad)
    np.testing.assert_allclose(tw.path_gain_jax(td, cp).numpy(),
                               tw.path_gain(d64, cfg), rtol=1e-5)
    s32 = tw.snr_jax(td, tf, cp).numpy()
    np.testing.assert_allclose(s32, tw.snr(d64, f64, cfg), rtol=1e-5)
    bw = cfg.bandwidth_hz
    r32 = tw.shannon_rate_jax(torch.from_numpy(s32), cp.bandwidth_hz).numpy()
    np.testing.assert_allclose(r32, tw.shannon_rate(s32.astype(np.float64),
                                                    bw),
                               rtol=1e-6, atol=bw * 2.0 ** -22)
    r32[:2] = [0.0, -3.0]
    np.testing.assert_allclose(
        tw.comm_latency_jax(1e6, torch.from_numpy(r32)).numpy(),
        tw.comm_latency(1e6, r32.astype(np.float64)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the scheduling numpy half
# ---------------------------------------------------------------------------
def _round_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(snr=f(rng.exponential(1.0, n) * 10.0),
                avg=f(rng.exponential(1.0, n) * 10.0),
                rates=f(rng.exponential(1.0, n) * 2e6),
                comm=f(rng.exponential(0.2, n)),
                comp=f(rng.exponential(0.3, n)),
                norms=f(rng.random(n)),
                ages=rng.integers(0, 12, n).astype(np.float32))


@pytest.mark.parametrize("n,k,seed", [(20, 4, 0), (257, 16, 1),
                                      (1000, 100, 2)])
def test_policies_numpy_bitwise(n, k, seed):
    x = _round_inputs(n, seed)
    tcall = lambda name, *a: getattr(tsched, name)(*a)  # noqa: E731
    jcall = lambda name, *a: getattr(jsched, name)(*a)  # noqa: E731
    cases = [("random_schedule", None), ("round_robin", (seed + 3, n, k)),
             ("proportional_fair", (x["snr"], x["avg"], k)),
             ("latency_minimal", (x["comm"], x["comp"], k)),
             ("best_channel", (x["snr"], k)), ("best_norm", (x["norms"], k)),
             ("bc_bn2", (x["snr"], x["norms"], 2 * k, k)),
             ("quantized_norm", (x["norms"], x["rates"], 31_250, 5.0)),
             ("bn2_c", (x["norms"], x["rates"], 31_250, 5.0, k)),
             ("f_alpha", (x["ages"], 1.0)), ("f_alpha", (x["ages"] + 1, 0.5)),
             ("update_ages", (x["ages"], x["snr"] > 10.0)),
             # the greedy's loops are quadratic in Python: 300 devices
             ("deadline_greedy", (x["comm"][:300], x["comp"][:300], 2.0)),
             ("deadline_greedy", (x["comm"][:300], x["comp"][:300], 2.0,
                                  x["snr"][:300] > 5.0))]
    for name, args in cases:
        if name == "random_schedule":
            got = tsched.random_schedule(np.random.default_rng(seed), n, k)
            want = jsched.random_schedule(np.random.default_rng(seed), n, k)
        else:
            got, want = tcall(name, *args), jcall(name, *args)
        np.testing.assert_array_equal(got, want)
    assert tsched._mask(n, [0, n - 1]).tolist() == jsched._mask(
        n, [0, n - 1]).tolist()
    snr_w = np.asarray(np.random.default_rng(seed).exponential(
        1.0, (min(n, 64), 20)) * x["snr"][:min(n, 64), None], np.float32)
    assert (tsched.min_subchannels(snr_w[0], 2e5, 1e6, 20)
            == jsched.min_subchannels(snr_w[0], 2e5, 1e6, 20))
    for alpha in (1.0, 0.5):
        got = tsched.age_based_greedy(x["ages"][:64], snr_w, 2e5, 1e6, 20,
                                      alpha)
        want = jsched.age_based_greedy(x["ages"][:64], snr_w, 2e5, 1e6, 20,
                                       alpha)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _kth_ties(score: np.ndarray, k: int) -> int:
    """How many scores equal the k-th largest, beyond the first."""
    kth = np.sort(score)[::-1][k - 1]
    return int((score == kth).sum()) - 1


@pytest.mark.parametrize("n,k,seed", [(4096, 64, 0), (1000, 100, 1)])
def test_numpy_policies_agree_with_torch_twins(n, k, seed):
    x = _round_inputs(n, seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    pc = tsched.PolicyConfig(n_devices=n, n_scheduled=k, model_bits=1e6,
                             deadline_s=5.0)
    st_ = tsched.RoundState(
        t=seed + 3, key=trandom.PRNGKey(0), snr_lin=t(x["snr"]),
        avg_snr=t(x["avg"]), rates=t(x["rates"]), comm_lat=t(x["comm"]),
        comp_lat=t(x["comp"]), ages=t(x["ages"]), update_norms=t(x["norms"]))
    d_params = int(pc.model_bits / 32)
    pairs = {
        "round_robin": (tsched.round_robin(seed + 3, n, k), None),
        "pf": (tsched.proportional_fair(x["snr"], x["avg"], k),
               x["snr"] / np.maximum(x["avg"], 1e-12)),
        "latency": (tsched.latency_minimal(x["comm"], x["comp"], k),
                    -(x["comm"] + x["comp"])),
        "best_channel": (tsched.best_channel(x["snr"], k), x["snr"]),
        "bn2": (tsched.best_norm(x["norms"], k), x["norms"]),
        "bc_bn2": (tsched.bc_bn2(x["snr"], x["norms"], 2 * k, k), x["snr"]),
        "bn2_c": (tsched.bn2_c(x["norms"], x["rates"], d_params,
                               pc.deadline_s, k),
                  tsched.quantized_norm(x["norms"], x["rates"], d_params,
                                        pc.deadline_s)),
    }
    for name, (want, score) in pairs.items():
        got = tsched.get_policy(name)(pc, st_).numpy()
        ties = 0 if score is None else _kth_ties(score, k)
        assert ties == 0 or (got != want).sum() <= 2 * ties, name
        if ties == 0:
            np.testing.assert_array_equal(got, want, err_msg=name)
    m = 256  # the greedies' numpy loops are quadratic: a 256-device cell
    pc_m = tsched.PolicyConfig(n_devices=m, n_scheduled=k, deadline_s=2.0)
    st_m = st_._replace(comm_lat=st_.comm_lat[:m], comp_lat=st_.comp_lat[:m],
                        snr_lin=st_.snr_lin[:m])
    np.testing.assert_array_equal(
        tsched.get_policy("deadline")(pc_m, st_m).numpy(),
        tsched.deadline_greedy(x["comm"][:m], x["comp"][:m], 2.0))
    snr_w = np.asarray(np.random.default_rng(seed).exponential(
        1.0, (m, 20)) * x["snr"][:m, None], np.float32)
    for alpha in (1.0, 0.5):
        want, _ = tsched.age_based_greedy(x["ages"][:m], snr_w, 2e5, 1e6,
                                          20, alpha)
        got = tsched.age_greedy_jax(t(x["ages"][:m]), t(snr_w), 2e5, 1e6,
                                    alpha).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsched.update_ages_jax(t(x["ages"]), t(x["snr"] > 10.0)).numpy(),
        tsched.update_ages(x["ages"], x["snr"] > 10.0))
    for alpha in (1.0, 0.5):
        np.testing.assert_allclose(
            tsched._f_alpha(t(x["ages"] + 1), alpha).numpy(),
            tsched.f_alpha(x["ages"] + 1, alpha), rtol=1e-6)
