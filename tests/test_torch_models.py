"""The port's configs and dense transformer LM against the JAX package, on
the CPU.

(a) All ten configs field for field, their ``param_count`` /
    ``active_param_count``, their ``reduced()`` variants, ``SHAPES``,
    ``LONG_CONTEXT_WINDOW`` and ``ARCHS``; every family builds and runs.
(b) Layers (rmsnorm, layernorm, RoPE, the three MLPs with their inits,
    embeddings with gemma's scaling, the sinusoidal table, ``dense_init`` and
    ``stacked_init``) and attention (MHA, GQA, MQA, sliding window, softcap,
    query chunks) on the same seeded numpy inputs.
(c) At ``reduced()`` widths of the four dense configs (gemma-2b, minicpm-2b,
    stablelm-12b, llama3-405b): ``init_params`` from the same key, the leaf
    order and the flat (D,) message, and ``lm_loss`` with its gradient
    through ``convert.lm_params_from_jax``.

Tolerances: forward values within rtol 1e-5 (atol 1e-6; the trunk's hidden
states, of order one after two layers of 128-wide sums, atol 1e-5); gradients within
rtol 1e-4 / atol 1e-6; the init bitwise (threefry, and ``normal``'s
``log1p``, FMAs and square root as XLA's CPU computes them); the leaf order
and the flat message of converted params bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs  # noqa: E402
from repro.core.algorithms import registry as jalg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core.algorithms import registry as talg  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch ops of this file on one thread: the test run spreads files over
    several processes on one host, where the LM's many small ops stall on
    oversubscribed intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD = dict(rtol=1e-5, atol=1e-6)
HIDDEN = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
INIT = dict(rtol=0, atol=0)
DENSE = ("gemma-2b", "minicpm-2b", "stablelm-12b", "llama3-405b")
OTHER = tuple(a for a in configs.ARCHS if a not in DENSE)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol):
    torch.testing.assert_close(got, _t(want), **tol)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# (a) configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_config_matches_reference(arch):
    jc, tc = jconfigs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert convert.model_config_from_jax(jc) == tc
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert (tc.d_inner, tc.dt_rank_eff, tc.q_per_kv) == (
        jc.d_inner, jc.dt_rank_eff, jc.q_per_kv)
    jr, tr = jc.reduced(), tc.reduced()
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tr.param_count() == jr.param_count()
    assert tr.active_param_count() == jr.active_param_count()


def test_registry_and_shapes_match_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.LONG_CONTEXT_WINDOW == jconfigs.LONG_CONTEXT_WINDOW
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-2")


@pytest.mark.parametrize("arch", OTHER)
def test_every_family_builds_and_runs(arch):
    """The moe, ssm, hybrid, vlm and audio families build and run (the vlm
    and audio families with their embeddings); ``tests/
    test_torch_train_cli.py`` and ``test_torch_vlm_audio.py`` hold them
    against the reference."""
    cfg = configs.get_config(arch).reduced()
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = torch.ones(
            (1, cfg.n_vision_tokens, cfg.vision_dim))
    if cfg.family == "audio":
        extras["audio_embeds"] = torch.ones(
            (1, cfg.n_audio_frames, cfg.d_model))
    h, aux, _ = ttf.forward_trunk(ttf.init_params(cfg, trandom.PRNGKey(0)),
                                  cfg, tokens, extras)
    assert h.shape == (1, 4, cfg.d_model) and torch.isfinite(h).all()
    assert (float(aux) > 0) == (cfg.family == "moe")
    with pytest.raises(ValueError, match="unknown family"):
        ttf.init_params(dataclasses.replace(cfg, family="cnn"),
                        trandom.PRNGKey(0))


# ---------------------------------------------------------------------------
# (b) layers and attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(norm_type):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 3.0 + 0.5
    p = {"scale": rng.normal(size=48).astype(np.float32)}
    if norm_type == "layernorm":
        p["bias"] = rng.normal(size=48).astype(np.float32)
    want = jlayers.apply_norm(p, jnp.asarray(x), norm_type)
    got = tlayers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x),
                             norm_type)
    _close(got, want, FWD)
    jn = jlayers.init_norm(jax.random.PRNGKey(0), 48, norm_type, jnp.float32)
    tn = tlayers.init_norm(trandom.PRNGKey(0), 48, norm_type, torch.float32)
    assert sorted(tn) == sorted(jn)
    for k in jn:
        assert torch.equal(tn[k], _t(jn[k]))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 40, 3, 32)).astype(np.float32)
    pos = np.arange(40)[None, :]
    _close(tlayers.rope_frequencies(32, theta),
           jlayers.rope_frequencies(32, theta), FWD)
    _close(tlayers.apply_rope(_t(x), _t(pos), theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), FWD)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_decode_rope_matches_compiled_reference(theta):
    # the reference's compiled decode step folds the inverse frequencies
    # (theta ** -e rounded once from float64), up to an ulp from the
    # op-by-op ones; an angle's difference grows with the position
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1, 3, 32)).astype(np.float32)
    freqs = np.asarray(jax.jit(lambda: jlayers.rope_frequencies(32, theta))())
    assert torch.equal(tlayers.rope_frequencies(32, theta, folded=True),
                       _t(freqs))
    rope = jax.jit(lambda x, p: jlayers.apply_rope(x, p, theta))
    for p in (3, 258, 4097, 32767):
        pos = np.full((2, 1), p, np.int32)
        _close(tlayers.apply_rope(_t(x), _t(pos), theta, folded=True),
               rope(x, pos), FWD)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_init_and_apply_match_reference(mlp_type):
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), 32, 96, mlp_type,
                          jnp.float32)
    tp = tlayers.init_mlp(trandom.PRNGKey(3), 32, 96, mlp_type,
                          torch.float32)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        _close(tp[k], jp[k], INIT)
    x = np.random.default_rng(4).normal(size=(2, 7, 32)).astype(np.float32)
    cp = {k: _t(v) for k, v in jp.items()}
    if mlp_type == "gelu":  # nonzero biases
        cp = {k: v + 0.1 if k.startswith("b_") else v for k, v in cp.items()}
        jp = {k: v + 0.1 if k.startswith("b_") else v for k, v in jp.items()}
    _close(tlayers.apply_mlp(cp, _t(x), mlp_type),
           jlayers.apply_mlp(jp, jnp.asarray(x), mlp_type), FWD)


@pytest.mark.parametrize("scale", [False, True])
def test_embedding_matches_reference(scale):
    jt = jlayers.init_embedding(jax.random.PRNGKey(5), 64, 24, jnp.float32)
    tt = tlayers.init_embedding(trandom.PRNGKey(5), 64, 24, torch.float32)
    _close(tt, jt, INIT)
    toks = np.random.default_rng(6).integers(0, 64, size=(3, 9))
    want = jlayers.embed_tokens(jt, jnp.asarray(toks, jnp.int32), scale)
    got = tlayers.embed_tokens(_t(np.asarray(jt)), _t(toks), scale)
    assert torch.equal(got, _t(want))


def test_sinusoidal_and_init_helpers_match_reference():
    _close(tlayers.sinusoidal_positions(50, 16),
           jlayers.sinusoidal_positions(50, 16), FWD)
    _close(tlayers.dense_init(trandom.PRNGKey(7), (12, 5), torch.float32),
           jlayers.dense_init(jax.random.PRNGKey(7), (12, 5), jnp.float32),
           INIT)
    _close(tlayers.dense_init(trandom.PRNGKey(7), (12, 5), torch.float32,
                              scale=0.02),
           jlayers.dense_init(jax.random.PRNGKey(7), (12, 5), jnp.float32,
                              scale=0.02), INIT)
    js = jlayers.stacked_init(
        lambda k: jlayers.init_mlp(k, 8, 16, "swiglu", jnp.float32),
        jax.random.PRNGKey(8), 3)
    ts = tlayers.stacked_init(
        lambda k: tlayers.init_mlp(k, 8, 16, "swiglu", torch.float32),
        trandom.PRNGKey(8), 3)
    for k in js:
        assert ts[k].shape == (3,) + js[k].shape[1:]
        _close(ts[k], js[k], INIT)
    assert tlayers.init_mlp(trandom.PRNGKey(0), 4, 8, "gelu",
                            torch.bfloat16)["w_up"].dtype == torch.bfloat16


# (n_heads, n_kv_heads, window, softcap, q_chunk, seq)
ATTN_CASES = {
    "mha": (4, 4, None, 0.0, 1024, 12),
    "gqa": (4, 2, None, 0.0, 1024, 12),
    "mqa": (4, 1, None, 0.0, 1024, 12),
    "sliding": (4, 2, 5, 0.0, 1024, 12),
    "softcap": (4, 2, None, 30.0, 1024, 12),
    "chunked": (4, 2, 7, 0.0, 4, 12),
    "chunked_ragged": (2, 1, None, 0.0, 8, 12),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_self_attention_matches_reference(case):
    h, kv, window, softcap, q_chunk, s = ATTN_CASES[case]
    d, hd = 32, 16
    jp = jattn.init_attention(jax.random.PRNGKey(9), d, h, kv, hd,
                              jnp.float32)
    tp = tattn.init_attention(trandom.PRNGKey(9), d, h, kv, hd,
                              torch.float32)
    for k in jp:
        _close(tp[k], jp[k], INIT)
    cp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(10).normal(size=(2, s, d)).astype(np.float32)
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=hd, use_rope=True,
              rope_theta=10_000.0, window=window, softcap=softcap,
              q_chunk=q_chunk)
    want = jattn.self_attention(jp, jnp.asarray(x), **kw)
    _close(tattn.self_attention(cp, _t(x), **kw), want, FWD)
    # the core alone, with a query offset, non-causal
    q = np.random.default_rng(11).normal(size=(2, s, h, hd)).astype(
        np.float32)
    k, v = (np.random.default_rng(12 + i).normal(size=(2, s, kv, hd))
            .astype(np.float32) for i in range(2))
    for causal in (True, False):
        ckw = dict(n_kv_heads=kv, causal=causal, window=window,
                   softcap=softcap, q_offset=3, q_chunk=q_chunk)
        _close(tattn.attention_core(_t(q), _t(k), _t(v), **ckw),
               jattn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **ckw), FWD)


# ---------------------------------------------------------------------------
# (c) the dense LM at reduced widths
# ---------------------------------------------------------------------------
def _models(arch, seed=0):
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, convert.lm_params_from_jax(_tree_np(jp))


def _batch(cfg, b=2, s=17, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(2, b, s)).astype(np.int32)
    return {"tokens": toks[0], "labels": toks[1]}


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_matches_reference(arch):
    jcfg, cfg, jp, cp = _models(arch, seed=3)
    tp = ttf.init_params(cfg, trandom.PRNGKey(3))
    assert sorted(tp) == sorted(cp)
    for k in cp:
        assert tp[k].dtype == cp[k].dtype == torch.float32
        _close(tp[k], cp[k], INIT)
    assert tp["blocks/attn/wq"].shape[0] == cfg.n_layers
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("arch", DENSE)
def test_leaf_order_and_flat_message_bitwise(arch):
    jcfg, cfg, jp, cp = _models(arch)
    paths = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(sorted(cp)) == paths
    want = np.asarray(jalg.flatten_vec(jp))
    got = talg.flatten_vec(cp)
    assert got.shape == (jalg.flat_dim(jp),) == (talg.flat_dim(cp),)
    assert torch.equal(got, _t(want))
    back = talg.unflatten_vec(got, cp)
    assert all(torch.equal(back[k], cp[k]) for k in cp)
    assert ttf.nest_params(cp)["blocks"]["attn"]["wq"] is cp["blocks/attn/wq"]
    assert ttf.flatten_params(ttf.nest_params(cp)) == cp


@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_and_gradient_match_reference(arch):
    jcfg, cfg, jp, cp = _models(arch, seed=1)
    batch = _batch(cfg, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jb, remat=False), has_aux=True)(jp)
    tg, (tl, taux) = torch.func.grad_and_value(
        lambda p: ttf.lm_loss(p, cfg, tb), has_aux=True)(cp)
    _close(tl, jl, FWD)
    _close(taux["xent"], jaux["xent"], FWD)
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0
    cg = convert.lm_params_from_jax(_tree_np(jg))
    for k in cg:
        torch.testing.assert_close(tg[k], cg[k], **GRAD)
    # the trunk alone, with attention in query chunks
    jh = jtf.forward_trunk(jp, jcfg, jb["tokens"], q_chunk=4)[0]
    th = ttf.forward_trunk(cp, cfg, tb["tokens"], q_chunk=4)[0]
    _close(th, jh, HIDDEN)
    _close(ttf.unembed(cp, cfg, _t(np.asarray(jh))),
           jtf.unembed(jp, jcfg, jh), FWD)


def test_learned_positions_match_reference():
    """A dense config with a learned position table (the reference's
    ``pos_embed="learned"`` branch of ``init_params`` and ``_embed``)."""
    jcfg = dataclasses.replace(jconfigs.get_config("gemma-2b").reduced(),
                               pos_embed="learned", use_rope=False,
                               max_position=64)
    cfg = convert.model_config_from_jax(jcfg)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    tp = ttf.init_params(cfg, trandom.PRNGKey(2))
    cp = convert.lm_params_from_jax(_tree_np(jp))
    assert sorted(tp) == sorted(cp) and "pos_embed" in tp
    for k in cp:
        _close(tp[k], cp[k], INIT)
    batch = _batch(cfg, seed=5)
    _close(ttf.lm_loss(cp, cfg, {k: _t(v) for k, v in batch.items()})[0],
           jtf.lm_loss(jp, jcfg, {k: jnp.asarray(v)
                                  for k, v in batch.items()})[0], FWD)
