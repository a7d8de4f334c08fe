"""The port's privacy registry and field codec against ``repro.core.privacy``
and the JAX engine.

Field elements are int64 tensors holding values in [0, 2^32); the
reference's uint32 words compare to them as int64. Tolerances: ``to_field``
is bitwise at power-of-two clips (0.5 among them: the scale's division is
exact there, while the reference's CPU division is reciprocal-based
elsewhere) and at the field widths where the reference's CPU ``exp2`` is
exact (elsewhere within the reference's own scale error); ``from_field``
within rtol 1e-6; the masks, ``mask_rows`` and the prepass's
``(gsum, cnt)`` bitwise; the rounded field noise within one
unit, at most 1 in 1000 entries off by one (the normals agree to a few
ulps); ``clip_rows``, ``central_noise``, ``rdp_increment`` and
``epsilon_of`` within rtol 1e-6, their guard branches exact.

Engine runs (``make_linear_problem(d=16)``, N = 8, 3 scheduled, 6 rounds,
``privacy_params(clip=0.5, sigma=0.3, field_bits=20)``): participation,
uplink bits, mask bits and delta equal; epsilon within rtol 1e-5 (+inf
equal); loss within rtol 1e-4, latency within rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies

from benchmarks.common import make_linear_problem  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro.core.algorithms import registry as jalg  # noqa: E402
from repro.core.compression import coding as jcoding  # noqa: E402
from repro.core.compression import registry as jcomp  # noqa: E402
from repro.data import make_linear_datagen as jdatagen  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro.fl import server as jserver  # noqa: E402
from repro_torch.convert import (fault_params_from_jax,  # noqa: E402
                                 key_from_jax, privacy_params_from_jax)
from repro_torch.core import privacy as tpriv  # noqa: E402
from repro_torch.core.algorithms import registry as talg  # noqa: E402
from repro_torch.core.compression import coding as tcoding  # noqa: E402
from repro_torch.data import make_linear_datagen as tdatagen  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from repro_torch.fl import server as tserver  # noqa: E402
from test_torch_engine import _loss_t  # noqa: E402
from test_torch_faults import FAULTS, snr_margin_jax  # noqa: E402

PP = jpriv.privacy_params(clip=0.5, sigma=0.3, field_bits=20.0)
TPP = privacy_params_from_jax(PP)
SEED = 7
N, K, ROUNDS, D = 8, 3, 6, 16
POW2_CLIPS = (0.5, 0.25, 1.0, 4.0)
SETTINGS = hypothesis.settings(max_examples=60, deadline=None,
                               derandomize=True)
# float32-exact clip bounds (0.001 is not a float32)
CLIPS = st.floats(2.0 ** -10, 2.0 ** 4, allow_nan=False, width=32)
VALS = st.floats(-1e3, 1e3, allow_nan=False, width=32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _words(x):
    """uint32 words (or int64 field elements) as int64."""
    return np.asarray(x).astype(np.int64)


def _centered(w):
    w = _words(w) & 0xFFFFFFFF
    return np.where(w >= 1 << 31, w - (1 << 32), w)


# ---------------------------------------------------------------------------
# the field codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("clip", POW2_CLIPS)
@pytest.mark.parametrize("fb", [12.0, 17.0, 20.0, 23.0, 24.0])
def test_to_field_and_from_field(clip, fb):
    """Bitwise where the reference's scale is exact. Its CPU ``exp2`` is
    not exact at every integer (2^19 comes out as 524287.78), so at
    field_bits 20 and 24 its scale is a few ulps low and its encodings of
    large values come out lower: there the port, whose scale is exact,
    agrees within that scale error (at most clip times the scale's
    shortfall, plus one unit of rounding)."""
    x = (np.random.default_rng(int(fb)).standard_normal(4000) * clip
         ).astype(np.float32)
    x[:4] = (clip, -clip, 2 * clip, -3 * clip)  # the clamp
    exact = (2.0 ** (fb - 1) - 1.0) / clip
    assert float(tcoding.field_scale(clip, fb)) == exact
    j_exact = float(jcoding.field_scale(clip, fb)) == exact
    assert j_exact == (fb in (12.0, 17.0, 23.0))
    want = _centered(jcoding.to_field(jnp.asarray(x), clip, fb))
    got = tcoding.to_field(_t(x), clip, fb)
    assert got.dtype == torch.int64
    if j_exact:
        np.testing.assert_array_equal(got.numpy(), _words(
            jcoding.to_field(jnp.asarray(x), clip, fb)))
    else:
        # |x| * (exact - reference scale) <= clip * that, plus the rounding
        ds = exact - float(jcoding.field_scale(clip, fb))
        assert np.abs(_centered(got.numpy()) - want).max() <= (
            np.floor(clip * ds) + 1)
    words = np.random.default_rng(1).integers(0, 1 << 32, 4000,
                                              dtype=np.uint64)
    np.testing.assert_allclose(
        tcoding.from_field(_t(words.astype(np.int64)), clip, fb).numpy(),
        np.asarray(jcoding.from_field(jnp.asarray(words.astype(np.uint32)),
                                      clip, fb)), rtol=1e-6)


@hypothesis.given(st.lists(VALS, min_size=1, max_size=64), CLIPS,
                  st.integers(8, 24))
@SETTINGS
def test_field_roundtrip_within_quantization_step(vals, clip, fb):
    """decode(encode(x)) is x clamped to [-clip, clip] within half a step,
    and re-encoding the decode gives the same field elements."""
    x = torch.tensor(vals, dtype=torch.float32)
    q = tcoding.to_field(x, clip, float(fb))
    back = tcoding.from_field(q, clip, float(fb))
    step = 1.0 / float(tcoding.field_scale(clip, float(fb)))
    np.testing.assert_allclose(back.numpy(),
                               np.clip(x.numpy(), -clip, clip),
                               atol=0.5 * step + 1e-6 * clip)
    assert torch.equal(tcoding.to_field(back, clip, float(fb)), q)


@hypothesis.given(st.integers(2, 64), st.integers(8, 16), st.data())
@SETTINGS
def test_field_sum_exact_within_headroom(m, fb, data):
    """A sum mod 2^32 of m encodings decodes to the sum of the decodes
    while m * 2^(fb-1) < 2^31."""
    assert m * (1 << (fb - 1)) < (1 << 31)
    rows = np.asarray(data.draw(st.lists(
        st.lists(st.floats(-1.0, 1.0, width=32), min_size=4, max_size=4),
        min_size=m, max_size=m)), np.float32)
    q = tcoding.to_field(_t(rows), 1.0, float(fb))
    got = tcoding.from_field(q.sum(0) & tcoding.FIELD_MASK, 1.0, float(fb))
    want = tcoding.from_field(q, 1.0, float(fb)).sum(0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# masks, noise, clipping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_mask_rows_and_pairwise_masks_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    ids = np.arange(5, 42)
    d = 33
    want = jpriv.mask_rows(key, jnp.asarray(ids, jnp.int32), d)
    got = tpriv.mask_rows(key_from_jax(key), _t(ids), d)
    np.testing.assert_array_equal(got.numpy(), _words(want))
    gsum = np.random.default_rng(seed).integers(0, 1 << 32, d,
                                                dtype=np.uint64)
    for cnt in (0, 1, 7, 100000):
        jm = jpriv.pairwise_masks(key, jnp.asarray(ids, jnp.int32), d,
                                  jnp.asarray(gsum.astype(np.uint32)),
                                  jnp.int32(cnt))
        tm = tpriv.pairwise_masks(key_from_jax(key), _t(ids), d,
                                  _t(gsum.astype(np.int64)),
                                  torch.tensor(cnt))
        np.testing.assert_array_equal(tm.numpy(), _words(jm))


@pytest.mark.parametrize("chunk", [None, 4, 16])
@pytest.mark.parametrize("part", [None, "some", "none"])
def test_mask_prepass_bitwise(chunk, part):
    n, d = 21, 9
    key = jax.random.PRNGKey(4)
    p = {None: None,
         "some": (np.arange(n) % 3 == 1).astype(np.float32),
         "none": np.zeros(n, np.float32)}[part]
    jg, jc = jserver._mask_prepass(key, n, d,
                                   None if p is None else jnp.asarray(p),
                                   chunk)
    tg, tc = tserver._mask_prepass(key_from_jax(key), n, d,
                                   None if p is None else _t(p), chunk)
    np.testing.assert_array_equal(tg.numpy(), _words(jg))
    assert int(tc) == int(jc)


@pytest.mark.parametrize("surv_ids", [(0, 1, 2, 3, 4, 5, 6, 7), (0, 3, 7),
                                      (2,), (5, 6), ()])
def test_pairwise_masks_cancel_mod_2_32(surv_ids):
    """Masked survivor rows sum to the unmasked sum mod 2^32, for any
    survivor set, the empty one included."""
    n, d = 8, 33
    key = key_from_jax(jax.random.PRNGKey(0))
    part = torch.zeros(n)
    part[list(surv_ids)] = 1.0
    gsum, cnt = tserver._mask_prepass(key, n, d, part, None)
    ids = torch.tensor(surv_ids, dtype=torch.int64)
    masks = tpriv.pairwise_masks(key, ids, d, gsum, cnt)
    assert masks.shape == (len(surv_ids), d)
    assert not (masks.sum(0) & tcoding.FIELD_MASK).any()
    rows = torch.randint(0, 1 << 32, (len(surv_ids), d))
    assert torch.equal((rows + masks).sum(0) & tcoding.FIELD_MASK,
                       rows.sum(0) & tcoding.FIELD_MASK)


def test_field_noise_rows_within_one_unit():
    """At field_bits 17, where the reference's scale is exact."""
    pp = jpriv.privacy_params(clip=0.5, sigma=0.3, field_bits=17.0)
    key = jax.random.PRNGKey(6)
    ids = np.arange(300)
    want = _centered(jpriv.field_noise_rows(pp, key,
                                            jnp.asarray(ids, jnp.int32), 64))
    got = _centered(tpriv.field_noise_rows(privacy_params_from_jax(pp),
                                           key_from_jax(key), _t(ids),
                                           64).numpy())
    diff = np.abs(got - want)
    assert np.abs(want).max() > 1 << 15  # the noise spans many units
    assert diff.max() <= 1 and diff.sum() <= want.size / 1000


def test_field_noise_rows_bitwise_across_thread_counts():
    """The same inputs as above under 1 to 8 intra-op threads: the noise is
    the reference's bit for bit at every count (``random.normal`` is
    XLA's float32 arithmetic step by step, with no libm call whose
    vectorized and scalar paths could differ)."""
    pp = jpriv.privacy_params(clip=0.5, sigma=0.3, field_bits=17.0)
    key = jax.random.PRNGKey(6)
    ids = np.arange(300)
    want = np.asarray(jpriv.field_noise_rows(
        pp, key, jnp.asarray(ids, jnp.int32), 64))
    n = torch.get_num_threads()
    try:
        for threads in range(1, 9):
            torch.set_num_threads(threads)
            got = tpriv.field_noise_rows(privacy_params_from_jax(pp),
                                         key_from_jax(key), _t(ids), 64)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{threads} threads")
    finally:
        torch.set_num_threads(n)


def test_clip_rows_and_central_noise():
    rows = np.random.default_rng(0).standard_normal((50, 40)).astype(
        np.float32)
    rows[:5] *= 0.01  # under the clip: kept as they are
    np.testing.assert_allclose(
        tpriv.clip_rows(TPP, _t(rows)).numpy(),
        np.asarray(jpriv.clip_rows(PP, jnp.asarray(rows))), rtol=1e-6)
    np.testing.assert_array_equal(tpriv.clip_rows(TPP, _t(rows))[:5].numpy(),
                                  rows[:5])
    key = jax.random.PRNGKey(8)
    np.testing.assert_allclose(
        tpriv.central_noise(TPP, key_from_jax(key), 1000).numpy(),
        np.asarray(jpriv.central_noise(PP, key, 1000)), rtol=1e-6,
        atol=1e-7)


# ---------------------------------------------------------------------------
# accountant and pricing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q,z", [(0.0, 1.0), (0.3, 0.0), (0.0, 0.0),
                                 (1.0, 2.0), (1.5, 0.7), (0.05, 1.1),
                                 (0.4, 3.0), (3 / 8, 0.3)])
def test_rdp_increment_and_epsilon(q, z):
    want = np.asarray(jpriv.rdp_increment(jnp.float32(q), jnp.float32(z)))
    got = tpriv.rdp_increment(torch.tensor(q), torch.tensor(z)).numpy()
    if q == 0.0 or z == 0.0 or q >= 1.0:  # the guard branches: exact
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    ledger = np.cumsum([want] * 3, axis=0).astype(np.float32)[-1]
    np.testing.assert_allclose(
        float(tpriv.epsilon_of(_t(ledger))),
        float(jpriv.epsilon_of(jnp.asarray(ledger))), rtol=1e-6)


def test_pricing_matches_reference():
    for name in tpriv.privacy_names() + ("_secagg_unmasked",):
        for d in (17, 4096):
            assert float(tpriv.uplink_bits_jax(name, TPP, d, 7.0)) == float(
                jpriv.uplink_bits_jax(name, PP, d, 7.0))
        for peers in (0, 7, 99999):
            assert float(tpriv.mask_bits_jax(name, peers)) == float(
                jpriv.mask_bits_jax(name, peers))
    assert tpriv.privacy_names() == jpriv.privacy_names()
    for c in ("ALPHAS", "DELTA", "KEY_BITS", "FIELD_COMPATIBLE",
              "PRIVACY_FOLD", "MASK_FOLD", "NOISE_FOLD"):
        assert getattr(tpriv, c) == getattr(jpriv, c)


def test_validate_privacy_config_matches_reference():
    """The same accept / raise set, and the same messages, over every
    (privacy, compression, algorithm) triple."""
    n_raised = 0
    for name in jpriv.privacy_names() + ("_secagg_unmasked", "nope"):
        for comp in ("none",) + jcomp.compressor_names():
            for algo in jalg.algorithm_names():
                outcome = []
                for mod in (jpriv, tpriv):
                    try:
                        mod.validate_privacy_config(name, compression=comp,
                                                    algorithm=algo)
                        outcome.append(None)
                    except ValueError as e:
                        outcome.append(str(e))
                assert outcome[0] == outcome[1], (name, comp, algo)
                n_raised += outcome[0] is not None
    assert n_raised > 0


def test_stack_and_convert_privacy_params():
    grid = [jpriv.privacy_params(clip=c, sigma=s) for c, s in ((0.5, 0.1),
                                                                (2.0, 1.3))]
    jst = jpriv.stack_privacy_params(grid)
    tst = tpriv.stack_privacy_params([privacy_params_from_jax(p)
                                      for p in grid])
    for f in tpriv.PrivacyParams._fields:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)))
    for a, b in zip(tpriv.privacy_params(clip=0.5, sigma=0.3), TPP):
        assert torch.equal(a, b)
    assert tpriv.default_privacy_params() == tpriv.privacy_params()


def test_fl_round_privacy_errors():
    params, _, make_batches, _ = make_linear_problem(d=D)
    batches = {k: _t(v) for k, v in make_batches(0, N).items()}
    p0 = {"w": torch.zeros(D)}
    key = key_from_jax(jax.random.PRNGKey(0))
    state = tserver.init_fl_state(p0, N)
    with pytest.raises(ValueError, match="privacy_key"):
        tserver.fl_round(state, batches, _loss_t, privacy="secagg")
    with pytest.raises(ValueError, match="control-variate"):
        tserver.fl_round(tserver.init_fl_state(p0, N, algo="scaffold"),
                         batches, _loss_t, algo="scaffold", privacy="dp",
                         privacy_key=key)
    with pytest.raises(ValueError, match="staleness_weights"):
        tserver.fl_round(state, batches, _loss_t, privacy="secagg",
                         privacy_key=key, staleness_weights=torch.ones(N))
    with pytest.raises(ValueError, match="masked field sum"):
        tserver.fl_round(tserver.init_fl_state(p0, N, use_ef=True), batches,
                         _loss_t, privacy="secagg", privacy_key=key,
                         compression_name="topk", key=key)


def test_simconfig_validates_privacy():
    with pytest.raises(ValueError, match="sparse"):
        trt.SimConfig(privacy="secagg", compression="topk")
    with pytest.raises(ValueError, match="unknown privacy"):
        trt.SimConfig(privacy="nope")
    with pytest.raises(ValueError, match="PrivacyParams"):
        trt.SimConfig(privacy="dp", privacy_params=PP)
    with pytest.raises(ValueError, match="control"):
        trt.SimConfig(privacy="dp", algorithm="scaffold")
    with pytest.raises(ValueError, match="stale"):
        trt.SimConfig(privacy="secagg_dp", algorithm="fedbuff")
    with pytest.warns(DeprecationWarning):  # mapped first, then validated
        assert trt.SimConfig(privacy="secagg", server="adam").algorithm == (
            "fedadam")


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------
# (privacy, compression, algorithm, faults)
ENGINE_CASES = [("secagg", "none", "fedavg", False),
                ("secagg", "sign", "fedavg", False),
                ("secagg", "qsgd", "fedavg", False),
                ("dp", "topk", "fedavg", False),
                ("secagg_dp", "scaled_sign", "fedavg", False),
                ("dp", "none", "fedbuff", False),
                ("secagg", "none", "fedavg", True)]


def _batches():
    _, _, make_batches, _ = make_linear_problem(d=D)
    return jrt.stack_batches(make_batches, ROUNDS, N)


def _kw(priv, comp, algo, faults):
    return dict(n_devices=N, n_scheduled=K, rounds=ROUNDS, policy="random",
                seed=SEED, privacy=priv, compression=comp, algorithm=algo,
                max_retries=2 if faults else 0)


def _port_run(batches, priv="none", comp="none", algo="fedavg", faults=False,
              **extra):
    kw = dict(_kw(priv, comp, algo, faults), privacy_params=TPP)
    kw.update(extra)
    cfg = trt.SimConfig(algo_params=talg.algo_params(lr=0.1),
                        faults=fault_params_from_jax(FAULTS) if faults
                        else None, **kw)
    return trt.run_simulation_scan(
        cfg, _loss_t, {"w": np.zeros(D, np.float32)},
        {k: np.asarray(v) for k, v in batches.items()}, device="cpu")


@pytest.fixture(scope="module")
def reference_runs():
    params, loss_fn, _, _ = make_linear_problem(d=D)
    batches = _batches()
    runs = {}
    for case in ENGINE_CASES:
        cfg = jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1),
                            privacy_params=PP,
                            faults=FAULTS if case[3] else None, **_kw(*case))
        runs[case] = jrt.run_simulation_scan(cfg, loss_fn, params, batches)
    return batches, runs


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_with_privacy_matches_reference(reference_runs, case):
    batches, runs = reference_runs
    jp, jl = runs[case]
    if case[3]:
        assert snr_margin_jax(SEED, N, ROUNDS, FAULTS, 2) > 1e-5
    tp, tl = _port_run(batches, *case)
    for f in ("participation", "n_survived", "uplink_bits", "mask_bits",
              "delta"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f),
                                      err_msg=f)
    np.testing.assert_array_equal(np.isinf(tl.epsilon), np.isinf(jl.epsilon))
    fin = np.isfinite(jl.epsilon)
    np.testing.assert_allclose(tl.epsilon[fin], jl.epsilon[fin], rtol=1e-5)
    np.testing.assert_allclose(tl.loss, jl.loss, rtol=1e-4)
    np.testing.assert_allclose(tl.latency_s, jl.latency_s, rtol=1e-5)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-4, atol=1e-6)
    if case[0] != "secagg":
        assert np.isfinite(tl.epsilon).all() == (case[0] != "none")
    if case[0] in ("secagg", "secagg_dp"):
        assert (tl.mask_bits > 0).all()


def _same_except_pricing(a, b):
    """Every log field but those the key agreement prices (latency, the
    bottleneck's airtime, uplink and mask bits)."""
    for f in trt._LOG_FIELDS:
        if f not in ("latency_s", "comm_s", "uplink_bits", "mask_bits"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


@pytest.mark.parametrize("comp,chunk,faults", [
    ("none", None, False), ("sign", None, False), ("qsgd", 4, False),
    ("none", 4, True), ("qsgd", None, True)])
def test_secagg_bitwise_equals_unmasked(comp, chunk, faults):
    """The masks cancel: secagg's params and logs are bit for bit those of
    the same pipeline without masks, which pays no key agreement."""
    _, _, make_batches, _ = make_linear_problem(d=D)
    batches = jrt.stack_batches(make_batches, ROUNDS, 10)
    kw = dict(comp=comp, faults=faults, chunk_size=chunk, n_devices=10)
    ap, al = _port_run(batches, "secagg", **kw)
    bp, bl = _port_run(batches, "_secagg_unmasked", **kw)
    assert torch.equal(ap["w"], bp["w"])
    _same_except_pricing(al, bl)
    assert (al.mask_bits > 0).all() and not bl.mask_bits.any()
    if not faults:
        np.testing.assert_array_equal(al.uplink_bits,
                                      bl.uplink_bits + al.mask_bits)
    else:
        assert len(set(al.n_survived.tolist())) > 1


@pytest.mark.parametrize("priv,comp", [("dp", "topk"),
                                       ("secagg_dp", "scaled_sign"),
                                       ("secagg", "qsgd")])
def test_chunked_equals_unchunked_bitwise_with_privacy(priv, comp):
    _, _, make_batches, _ = make_linear_problem(d=D)
    batches = jrt.stack_batches(make_batches, ROUNDS, 10)
    outs = [_port_run(batches, priv, comp, chunk_size=c, n_devices=10)
            for c in (4, None)]
    (cp, cl), (up, ul) = outs
    assert torch.equal(cp["w"], up["w"])
    for f in trt._LOG_FIELDS:
        np.testing.assert_array_equal(getattr(cl, f), getattr(ul, f))


def test_privacy_none_is_bitwise_legacy_stream():
    batches = _batches()
    ap, al = _port_run(batches)
    cfg = trt.SimConfig(algo_params=talg.algo_params(lr=0.1),
                        **_kw("none", "none", "fedavg", False))
    bp, bl = trt.run_simulation_scan(
        cfg, _loss_t, {"w": np.zeros(D, np.float32)},
        {k: np.asarray(v) for k, v in batches.items()}, device="cpu")
    assert torch.equal(ap["w"], bp["w"])
    for f in trt._LOG_FIELDS:
        np.testing.assert_array_equal(getattr(al, f), getattr(bl, f))
    assert np.isinf(al.epsilon).all() and (al.delta == 1.0).all()
    assert not al.mask_bits.any()


def test_all_dropped_round_is_noop_with_secagg():
    """drop_prob = 1: the empty survivor set's masks and field sum decode
    to zero, and the guard keeps the model bitwise."""
    from repro_torch.core import faults as tfaults
    batches = _batches()
    cfg = trt.SimConfig(algo_params=talg.algo_params(lr=0.1),
                        privacy_params=TPP,
                        faults=tfaults.fault_params(drop_prob=1.0),
                        **_kw("secagg", "none", "fedavg", False))
    p0 = {"w": np.linspace(-1, 1, D).astype(np.float32)}
    tp, tl = trt.run_simulation_scan(
        cfg, _loss_t, p0, {k: np.asarray(v) for k, v in batches.items()},
        device="cpu")
    np.testing.assert_array_equal(tp["w"].numpy(), p0["w"])
    assert not tl.n_survived.any() and (tl.mask_bits > 0).all()


@pytest.mark.parametrize("priv,sigma", [("dp", 1.2), ("secagg_dp", 0.3)])
def test_epsilon_monotone_and_delta_fixed(priv, sigma):
    batches = _batches()
    _, tl = _port_run(batches, priv,
                      privacy_params=tpriv.privacy_params(clip=1.0,
                                                          sigma=sigma))
    assert np.isfinite(tl.epsilon).all()
    assert (np.diff(tl.epsilon) >= 0).all()
    assert (tl.delta == np.float32(tpriv.DELTA)).all()
    _, nl = _port_run(batches, "secagg")
    assert np.isinf(nl.epsilon).all() and (nl.delta == 1.0).all()


def test_run_simulation_round_logs_with_privacy():
    params, loss_fn, make_batches, _ = make_linear_problem(d=D)
    kw = _kw("secagg_dp", "none", "fedavg", False)
    jlogs = jrt.run_simulation(
        jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1),
                      privacy_params=PP, **kw), loss_fn, params, make_batches,
        engine="scan")
    tlogs = trt.run_simulation(
        trt.SimConfig(algo_params=talg.algo_params(lr=0.1),
                      privacy_params=TPP, **kw),
        _loss_t, {"w": np.zeros(D, np.float32)}, make_batches, device="cpu")
    for j, t in zip(jlogs, tlogs):
        assert (t.mask_bits, t.delta) == (j.mask_bits, j.delta)
        np.testing.assert_allclose(t.epsilon, j.epsilon, rtol=1e-5)
        np.testing.assert_allclose(t.loss, j.loss, rtol=1e-4)


# ---------------------------------------------------------------------------
# fleet shape: the fused scaled-sign kernel branch (N * D = 2^20) under
# secagg_dp
# ---------------------------------------------------------------------------
def test_kernel_path_with_privacy_matches_reference():
    fleet = dict(n_devices=4096, n_scheduled=64, rounds=2, local_steps=2,
                 policy="random", seed=20, compression="scaled_sign",
                 chunk_size=1024, privacy="secagg_dp")
    params, loss_fn, _, w_star = make_linear_problem(d=256)
    jcfg = jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1),
                         datagen=jdatagen(w_star, batch=2),
                         privacy_params=PP, **fleet)
    jp, jl = jrt.run_simulation_scan(jcfg, loss_fn, params)
    tcfg = trt.SimConfig(algo_params=talg.algo_params(lr=0.1),
                         datagen=tdatagen(np.asarray(w_star), batch=2),
                         privacy_params=TPP, **fleet)
    tp, tl = trt.run_simulation_scan(
        tcfg, _loss_t, {"w": np.zeros(256, np.float32)}, device="cpu")
    for f in ("participation", "uplink_bits", "mask_bits", "delta"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f),
                                      err_msg=f)
    np.testing.assert_allclose(tl.epsilon, jl.epsilon, rtol=1e-5)
    np.testing.assert_allclose(tl.loss, jl.loss, rtol=1e-4)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-4, atol=1e-6)
