"""Per-module parity of the port's core layers against the JAX reference, on
the same numpy inputs and keys.

Tolerances: chunking, the policies' masks, key-driven draws and bit costs
are bitwise. Float paths whose order of summation or transcendental
functions differ (XLA's CPU ``log``/``pow``/division are not PyTorch's) hold
to rtol 1e-5 (elementwise) or 1e-4 (losses after SGD).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import chunking as jchunk  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import scheduling as jsched  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.core.algorithms import registry as jalg  # noqa: E402
from repro.core.compression import coding as jcoding  # noqa: E402
from repro.core.compression import error_feedback as jef  # noqa: E402
from repro.core.compression import registry as jcomp  # noqa: E402
from repro.data import make_linear_datagen as jdatagen  # noqa: E402
from repro_torch.convert import key_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import chunking as tchunk  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import scheduling as tsched  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.core.algorithms import registry as talg  # noqa: E402
from repro_torch.core.compression import coding as tcoding  # noqa: E402
from repro_torch.core.compression import error_feedback as tef  # noqa: E402
from repro_torch.core.compression import registry as tcomp  # noqa: E402
from repro_torch.data import make_linear_datagen as tdatagen  # noqa: E402

EW = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# chunking
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 5, 8, 23])
def test_canonical_sum_bitwise(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    valid = (rng.random(n) < 0.6).astype(np.float32)
    for v in (None, valid):
        want = jchunk.canonical_sum(jnp.asarray(x),
                                    None if v is None else jnp.asarray(v))
        got = tchunk.canonical_sum(torch.from_numpy(x),
                                   None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jchunk.canonical_mean(jnp.asarray(x), jnp.asarray(valid))
    got = tchunk.canonical_mean(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_canonical_sum_chunk_invariance_in_port():
    x = torch.randn(23, 5, generator=torch.Generator().manual_seed(3))
    full = tchunk.canonical_sum(x)
    for chunk in (1, 2, 4, 8, 16):
        m = tchunk.n_blocks(23, chunk)
        pad = torch.cat([x, x.new_zeros(m * chunk - 23, 5)])
        parts = torch.stack([tchunk.canonical_sum(b)
                             for b in pad.reshape(m, chunk, 5)])
        assert torch.equal(tchunk.canonical_sum(parts), full)


def test_chunk_helpers_and_client_keys():
    assert [tchunk.pow2_ceil(n) for n in (1, 3, 8, 9)] == [1, 4, 8, 16]
    assert tchunk.n_blocks(10, 4) == jchunk.n_blocks(10, 4) == 3
    with pytest.raises(ValueError):
        tchunk.n_blocks(10, 3)
    np.testing.assert_array_equal(tchunk.block_ids(2, 4).numpy(),
                                  np.asarray(jchunk.block_ids(2, 4)))
    jk = jax.random.PRNGKey(5)
    ids = np.arange(3, 19, dtype=np.int32)
    np.testing.assert_array_equal(
        tchunk.client_keys(key_from_jax(jk), torch.as_tensor(ids)).numpy(),
        np.asarray(jchunk.client_keys(jk, jnp.asarray(ids))))


# ---------------------------------------------------------------------------
# compression: coding, the nine operators, bits, kernel dispatch, EF
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [1, 7, 32, 1000])
def test_sparse_and_gamma_bits(d):
    for nnz in (0.0, 1.0, 2.5, float(d)):
        assert float(tcoding.sparse_bits_jax(d, nnz)) == float(
            jcoding.sparse_bits_jax(d, nnz))
    gaps = np.array([0, 1, 2, 3, 16, 17, 1000], np.float32)
    assert float(tcoding.elias_gamma_bits_jax(gaps)) == float(
        jcoding.elias_gamma_bits_jax(jnp.asarray(gaps)))


EXACT_OPS = ("none", "sign", "topk", "randk", "rtopk", "ternary")


def test_registries_name_the_reference_entries():
    assert tcomp.compressor_names() == jcomp.compressor_names()
    assert tsched.policy_names() == jsched.policy_names()


@pytest.mark.parametrize("name", jcomp.compressor_names())
def test_compressor_rows_match_reference(name):
    b, d = 6, 40
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, d)).astype(np.float32)
    x[0, :4] = 0.5  # ties in |x|: ranked by index on both sides
    jcp = jcomp.compression_params(k=5.0, levels=16.0, block=12.0)
    tcp = tcomp.compression_params(k=5.0, levels=16.0, block=12.0)
    jkeys = jchunk.client_keys(jax.random.PRNGKey(1), jnp.arange(b))
    want_c, want_b = jax.vmap(jcomp.get_compressor(name),
                              in_axes=(None, 0, 0))(jcp, jkeys, jnp.asarray(x))
    got_c, got_b = tcomp.rows_compressor(name)(tcp, key_from_jax(jkeys),
                                               torch.from_numpy(x))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(
        got_b[0].numpy(), np.asarray(jcomp.uplink_bits_jax(name, jcp, d)))
    assert float(tcomp.uplink_bits_jax(name, tcp, d)) == float(
        jcomp.uplink_bits_jax(name, jcp, d))
    if name in EXACT_OPS:
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    else:
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **EW)
    # the one-message form is row 0 of the batch
    one_c, one_b = tcomp.get_compressor(name)(tcp, key_from_jax(jkeys[0]),
                                              torch.from_numpy(x[0]))
    assert torch.equal(one_c, got_c[0]) and float(one_b) == float(got_b[0])


@pytest.mark.parametrize("name", ["topk", "qsgd", "scaled_sign", "sign"])
def test_kernel_dispatch_threshold(name):
    big = tcomp.KERNEL_DISPATCH_MIN_ELEMS
    assert tcomp.KERNEL_DISPATCH_MIN_ELEMS == jcomp.KERNEL_DISPATCH_MIN_ELEMS
    for total in (big - 1, big):
        assert tcomp.kernel_dispatch(name, total) == jcomp.kernel_dispatch(
            name, total)


@pytest.mark.parametrize("name", ["topk", "qsgd", "scaled_sign"])
def test_kernel_rows_path_matches_reference(name):
    """The kernel-dispatch row path (plain versions on the CPU) against the
    reference's kernel path (its compiled mirror)."""
    b, d = 64, 256
    x = np.random.default_rng(8).standard_normal((b, d)).astype(np.float32)
    jcp = jcomp.compression_params(k=9.0, levels=256.0)
    tcp = tcomp.compression_params(k=9.0, levels=256.0)
    jkeys = jchunk.client_keys(jax.random.PRNGKey(2), jnp.arange(b))
    big = jcomp.KERNEL_DISPATCH_MIN_ELEMS
    want_c, want_b = jcomp.rows_compressor(name, big, kernel_mode="jit")(
        jcp, jkeys, jnp.asarray(x))
    got_c, got_b = tcomp.rows_compressor(name, big)(
        tcp, key_from_jax(jkeys), torch.from_numpy(x))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    if name == "topk":
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    else:
        close = np.isclose(got_c.numpy(), np.asarray(want_c), **EW)
        assert close.mean() > 1 - 1e-3  # QSGD: rare one-step dither flips


def test_sparse_ef_roundtrip_matches_reference():
    rng = np.random.default_rng(9)
    resid = rng.standard_normal((5, 30)).astype(np.float32)
    resid[1, :6] = 0.25  # ties: lower index first, as lax.top_k
    want = jef.sparsify_rows(jnp.asarray(resid), 4)
    got = tef.sparsify_rows(torch.from_numpy(resid), 4)
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(tef.densify_rows(got, 30).numpy(),
                                  np.asarray(jef.densify_rows(want, 30)))
    bf = tef.sparsify_rows(torch.from_numpy(resid), 4, torch.bfloat16)
    assert bf.values.dtype == torch.bfloat16
    init = tef.init_sparse_error(3, 30, 4)
    assert init.values.shape == (3, 4) and not init.values.any()
    with pytest.raises(ValueError):
        tef.init_sparse_error(3, 30, 31)


# ---------------------------------------------------------------------------
# algorithms: sgd_steps and the fedavg triple
# ---------------------------------------------------------------------------
def _linear_loss_j(p, b):
    return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), {}


def _linear_loss_t(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}


def test_sgd_steps_and_fedavg_match_reference():
    rng = np.random.default_rng(10)
    n, h, b, d = 6, 3, 8, 16
    x = rng.standard_normal((n, h, b, d)).astype(np.float32)
    y = rng.standard_normal((n, h, b)).astype(np.float32)
    w0 = {"w": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    jap, tap = jalg.algo_params(lr=0.1), talg.algo_params(lr=0.1)
    ja, ta = jalg.get_algorithm("fedavg"), talg.get_algorithm("fedavg")
    jparams = {"w": jnp.asarray(w0["w"])}
    tparams = params_from_jax(w0)
    jd, _, jl = jax.vmap(lambda bb: ja.client_update(
        _linear_loss_j, jap, jparams, bb, None))(
        {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    td, tl = torch.func.vmap(lambda bb: ta.client_update(
        _linear_loss_t, tap, tparams, bb, None)[::2])(
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(td["w"].numpy(), np.asarray(jd["w"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    mean_j = {"w": jnp.mean(jd["w"], axis=0)}
    mean_t = {"w": td["w"].mean(dim=0)}
    jp, _ = ja.server_update(jap, jparams, mean_j, None, None)
    tp, _ = ta.server_update(tap, tparams, mean_t, None, None)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-4, atol=1e-6)


def test_sgd_steps_momentum_and_extra_grad_match_reference():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 8, 16)).astype(np.float32)
    y = rng.standard_normal((3, 8)).astype(np.float32)
    w0 = (0.1 * rng.standard_normal(16)).astype(np.float32)
    jd, jp, jl = jalg.sgd_steps(
        _linear_loss_j, {"w": jnp.asarray(w0)},
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, 0.05, momentum=0.9,
        extra_grad=lambda p: {"w": 0.01 * p["w"]})
    td, tp, tl = talg.sgd_steps(
        _linear_loss_t, {"w": torch.from_numpy(w0)},
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, 0.05,
        momentum=0.9, extra_grad=lambda p: {"w": 0.01 * p["w"]})
    np.testing.assert_allclose(td["w"].numpy(), np.asarray(jd["w"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)


def test_flat_helpers_and_registry():
    tree = {"b": torch.arange(3.0), "a": torch.ones(2, 2)}
    jtree = {"b": jnp.arange(3.0), "a": jnp.ones((2, 2))}
    vec = talg.flatten_vec(tree)
    np.testing.assert_array_equal(vec.numpy(),
                                  np.asarray(jalg.flatten_vec(jtree)))
    back = talg.unflatten_vec(vec, tree)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    rows = talg.unflatten_rows(torch.stack([vec, 2 * vec]), tree)
    assert rows["a"].shape == (2, 2, 2) and talg.flat_dim(tree) == 7
    assert talg.get_algorithm("scaffold").uses_ctrl  # ported: none raise
    with pytest.raises(ValueError):
        talg.get_algorithm("nope")


# ---------------------------------------------------------------------------
# wireless twins and the downlink fading stream
# ---------------------------------------------------------------------------
def test_wireless_twins_match_reference():
    cfg = jw.WirelessConfig(n_devices=64)
    jcp = jw.channel_params(cfg)
    tcp = tw.channel_params(tw.WirelessConfig(**dataclasses.asdict(cfg)))
    jk = jax.random.PRNGKey(4)
    tk = key_from_jax(jk)
    jd = jw.sample_positions_jax(jk, jcp, 64)
    td = tw.sample_positions_jax(tk, tcp, 64)
    # XLA's CPU sqrt is not correctly rounded: an ulp apart at most
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-7)
    jf = jw.sample_fading_jax(jk, 64)
    tf = tw.sample_fading_jax(tk, 64)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    pairs = [
        (jw.path_gain_jax(jd, jcp), tw.path_gain_jax(td, tcp)),
        (jw.snr_jax(jd, jf, jcp), tw.snr_jax(td, tf, tcp)),
        (jw.downlink_snr_jax(jd, jf, jcp), tw.downlink_snr_jax(td, tf, tcp)),
        (jw.shannon_rate_jax(jw.snr_jax(jd, jf, jcp), 1e6),
         tw.shannon_rate_jax(tw.snr_jax(td, tf, tcp), 1e6)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    rate = np.array([2e6, 0.0, -1.0, 1e-38], np.float32)
    want = np.asarray(jw.comm_latency_jax(1e6, jnp.asarray(rate)))
    got = tw.comm_latency_jax(1e6, torch.from_numpy(rate)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    kt = jax.random.PRNGKey(12)
    assert tfaults.DOWNLINK_FOLD == jfaults.DOWNLINK_FOLD
    np.testing.assert_allclose(
        tfaults.downlink_fading(key_from_jax(kt), 50).numpy(),
        np.asarray(jfaults.downlink_fading(kt, 50)), rtol=1e-6)


# ---------------------------------------------------------------------------
# scheduling: all ten policies, bitwise masks on identical RoundStates
# ---------------------------------------------------------------------------
def _round_state(n, seed, t):
    rng = np.random.default_rng(seed)
    f = {
        "snr_lin": rng.exponential(50.0, n), "avg_snr": rng.exponential(50.0, n),
        "rates": rng.exponential(1e6, n), "comm_lat": rng.exponential(1.0, n),
        "comp_lat": rng.exponential(0.1, n),
        "ages": rng.integers(0, 5, n).astype(np.float64),
        "update_norms": rng.exponential(1.0, n),
    }
    f = {k: v.astype(np.float32) for k, v in f.items()}
    key = jax.random.PRNGKey(seed)
    js = jsched.RoundState(t=jnp.int32(t), key=key,
                           **{k: jnp.asarray(v) for k, v in f.items()})
    ts = tsched.RoundState(t=t, key=key_from_jax(key),
                           **{k: torch.from_numpy(v) for k, v in f.items()})
    return js, ts


@pytest.mark.parametrize("policy", jsched.policy_names())
@pytest.mark.parametrize("n,k", [(40, 8), (7, 3)])
def test_policies_bitwise(policy, n, k):
    kw = dict(n_devices=n, n_scheduled=k, model_bits=2e6, deadline_s=1.5)
    jp, tp = jsched.PolicyConfig(**kw), tsched.PolicyConfig(**kw)
    for seed, t in ((0, 0), (1, 3), (2, 7)):
        js, ts = _round_state(n, seed, t)
        want = np.asarray(jsched.get_policy(policy)(jp, js))
        got = tsched.get_policy(policy)(tp, ts).numpy()
        np.testing.assert_array_equal(got, want)


def test_update_ages_matches_reference():
    ages = np.array([0.0, 3.0, 1.0], np.float32)
    sched = np.array([True, False, True])
    np.testing.assert_array_equal(
        tsched.update_ages_jax(torch.from_numpy(ages),
                               torch.from_numpy(sched)).numpy(),
        np.asarray(jsched.update_ages_jax(jnp.asarray(ages),
                                          jnp.asarray(sched))))


# ---------------------------------------------------------------------------
# on-device data
# ---------------------------------------------------------------------------
def test_linear_datagen_matches_reference():
    w = np.random.default_rng(11).standard_normal(16).astype(np.float32)
    jk = jax.random.PRNGKey(6)
    ids = np.arange(5, 17, dtype=np.int32)
    for seed in (None, 3):
        want = jdatagen(jnp.asarray(w), local_steps=2, batch=4, seed=seed)(
            jk, jnp.asarray(ids))
        got = tdatagen(w, local_steps=2, batch=4, seed=seed)(
            key_from_jax(jk), torch.as_tensor(ids))
        np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["y"].numpy(), np.asarray(want["y"]),
                                   rtol=1e-4, atol=1e-5)
    # row i depends only on (key, ids[i])
    tk = key_from_jax(jk)
    gen = tdatagen(w, local_steps=2, batch=4)
    sub = gen(tk, torch.as_tensor(ids[3:7]))
    assert torch.equal(sub["x"], gen(tk, torch.as_tensor(ids))["x"][3:7])


def test_qsgd_pricing_matches_compiled_reference():
    """QSGD's bits against the reference's compiled program, which takes
    log2 as log times float32(1 / ln 2) and contracts both multiply-adds;
    pricing with plain log2 was an ulp off for about one level in five
    (levels 8 at d = 16, say). Levels where XLA's CPU log itself is an ulp
    off PyTorch's stay out of the comparison."""
    levels = np.arange(1, 257, dtype=np.float32)
    jlog = np.asarray(jax.jit(jnp.log)(jnp.asarray(levels + 1.0)))
    same_log = jlog == torch.log(torch.from_numpy(levels + 1.0)).numpy()
    assert same_log.sum() > 240
    for d in (16, 33, 256):
        price = jax.jit(jax.vmap(lambda lv: jcomp.uplink_bits_jax(
            "qsgd", jcomp.compression_params(levels=1.0)._replace(
                levels=lv), d)))
        want = np.asarray(price(jnp.asarray(levels)))
        got = np.array([float(tcomp.uplink_bits_jax(
            "qsgd", tcomp.compression_params(levels=float(lv)), d))
            for lv in levels], np.float32)
        np.testing.assert_array_equal(got[same_log], want[same_log])


def test_stack_params_and_converters_match_reference():
    from repro.core import privacy as jpriv
    from repro_torch import convert
    from repro_torch.core import privacy as tpriv

    jw_cfgs = [jw.WirelessConfig(n_devices=4, tx_power_dbm=p,
                                 bandwidth_hz=b)
               for p, b in ((10.0, 2e7), (-3.5, 1e7), (23.0, 5e6))]
    tw_cfgs = [tw.WirelessConfig(**vars(c)) for c in jw_cfgs]
    pairs = [
        (jw.stack_channel_params(jw_cfgs), tw.stack_channel_params(tw_cfgs),
         convert.channel_params_from_jax),
        (jcomp.stack_compression_params(
            [jcomp.compression_params(k=k, levels=lv) for k, lv in
             ((2.0, 4.0), (8.5, 256.0))]),
         tcomp.stack_compression_params(
             [tcomp.compression_params(k=k, levels=lv) for k, lv in
              ((2.0, 4.0), (8.5, 256.0))]),
         convert.compression_params_from_jax),
        (jalg.stack_algo_params([jalg.algo_params(lr=lr, momentum=0.5)
                                 for lr in (0.02, 0.1, 0.3)]),
         talg.stack_algo_params([talg.algo_params(lr=lr, momentum=0.5)
                                 for lr in (0.02, 0.1, 0.3)]),
         convert.algo_params_from_jax),
        (jpriv.stack_privacy_params([jpriv.privacy_params(clip=c)
                                     for c in (0.5, 1.5)]),
         tpriv.stack_privacy_params([tpriv.privacy_params(clip=c)
                                     for c in (0.5, 1.5)]),
         convert.privacy_params_from_jax)]
    for jp, tp, conv in pairs:
        assert type(tp)._fields == type(jp)._fields
        for f in type(tp)._fields:
            j, t = np.asarray(getattr(jp, f)), getattr(tp, f)
            assert t.dtype == torch.float32 and t.shape == j.shape
            np.testing.assert_array_equal(t.numpy(), j)
            np.testing.assert_array_equal(getattr(conv(jp), f).numpy(), j)


def test_policy_mixture_and_onehot_match_reference():
    names = ("random", "pf", "age", "deadline", "bn2")
    for bad in (("random", "pf", "random"),):
        with pytest.raises(ValueError, match="duplicate"):
            jsched.get_policy_mixture(bad)
        with pytest.raises(ValueError, match="duplicate"):
            tsched.get_policy_mixture(bad)
    for mod in (jsched, tsched):
        with pytest.raises(ValueError, match="not in enabled set"):
            mod.policy_onehot("latency", names)
    jmix, tmix = (jsched.get_policy_mixture(names),
                  tsched.get_policy_mixture(names))
    n, rng = 12, np.random.default_rng(3)
    f32 = lambda *s: rng.exponential(size=s).astype(np.float32)  # noqa: E731
    fields = dict(snr_lin=f32(n), avg_snr=f32(n), rates=1e6 * f32(n),
                  comm_lat=f32(n), comp_lat=0.1 * f32(n), ages=f32(n),
                  update_norms=f32(n))
    key = jax.random.PRNGKey(5)
    jst = jsched.RoundState(t=1, key=key, **{k: jnp.asarray(v)
                                             for k, v in fields.items()})
    tst = tsched.RoundState(t=1, key=key_from_jax(key),
                            **{k: torch.from_numpy(v)
                               for k, v in fields.items()})
    jcfg = jsched.PolicyConfig(n_devices=n, n_scheduled=4)
    tcfg = tsched.PolicyConfig(n_devices=n, n_scheduled=4)
    for name in names:
        jw_, tw_ = (jsched.policy_onehot(name, names),
                    tsched.policy_onehot(name, names))
        np.testing.assert_array_equal(tw_.numpy(), np.asarray(jw_))
        got = tmix(tcfg, tst, tw_).numpy()
        np.testing.assert_array_equal(got, np.asarray(jmix(jcfg, jst, jw_)))
        np.testing.assert_array_equal(
            got, tsched.get_policy(name)(tcfg, tst).numpy())
