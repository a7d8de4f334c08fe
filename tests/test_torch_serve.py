"""The port's serving path (``transformer.init_decode_cache``, ``prefill``,
``decode_step``, ``launch/steps.py``'s serving steps and ``launch/serve.py``)
against the JAX package, on the CPU, for every config at ``reduced()``.

The reference runs jitted through its own serving steps
(``repro.launch.steps.make_prefill_step`` / ``make_decode_step``), as its
``serve.py`` jits them; the vlm's gates are 0.5 and its vision embeddings,
as whisper's frame embeddings, seeded normal draws (at init the gates are
zero, and the cross layers would compute nothing).

(a) ``init_decode_cache``: structure, shapes, dtypes and zeros, linear,
    sliding (capped at ``LONG_CONTEXT_WINDOW``) and windowed.
(b) ``prefill`` (and ``make_prefill_step``) over a (2, 32) prompt: the
    last token's logits and the cache leaf by leaf; ``_load_prefill`` into
    a 48-position cache.
(c) ``decode_step`` (and ``make_decode_step``) at position 32 from the
    reference's loaded cache and at position 3 from a zero cache: logits and
    the new cache leaf by leaf.
(d) Circular decode past a window of 16 at positions 0, 5, 15, 16 and 50
    (the reference's ``test_long_context_circular_decode`` cell), each side
    carrying its own cache: logits and cache at every position.
(e) ``serve --reduced`` (batch 2, prompt 32, 16 greedy steps) for one
    config of each family against the reference's prefill /
    ``_load_prefill`` / decode loop on the same params and prompts.
(f) The decode functions one by one on seeded inputs: ``conv_step``,
    ``decode_self_attention`` (linear, past the cache's end, circular
    before and after the wrap, softcap, MQA) and ``init_kv_cache``, and
    mamba's and RG-LRU's forward from a given state with its final state,
    their one-token decode steps and their zero states.

Tolerances: logits and caches within rtol 1e-5 / atol 1e-5 (C7: XLA's
``rsqrt`` and row-mean order put ~1e-6 relative error into every RMSNorm;
atol for entries near 0 and the recurrent states); greedy tokens equal at
every step where the reference's top-2 logit gap exceeds 1e-4, and each
test says how many such steps it compared (all of them, so far).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import scan_utils as jscan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import scan_utils as tscan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from test_torch_steps import _np, _one_thread  # noqa: E402,F401
from test_torch_vlm_audio import _extras, _gated  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
GAP = 1e-4
B, PROMPT, GEN = 2, 32, 16
TOTAL = PROMPT + GEN
# one config of each family
FAMILY_ARCHS = ["gemma-2b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
                "recurrentgemma-2b", "llama-3.2-vision-11b", "whisper-base"]
CIRCULAR_ARCHS = ["falcon-mamba-7b", "recurrentgemma-2b", "gemma-2b"]
CIRCULAR_POS, WINDOW = [0, 5, 15, 16, 50], 16


def _leaves(tree, path=""):
    """(path, leaf) pairs of a cache, dict keys sorted as ``jax.tree``
    orders them; lists and tuples by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v,
                                                                f"{path}/{i}")]
    return [(path, tree)]


def _same_tree(got, want):
    """The port's cache has the reference's structure: dicts with the same
    keys, lists as lists, tuples as tuples."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    else:
        assert torch.is_tensor(got)


def _close_tree(got, want, tol=TOL):
    _same_tree(got, want)
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == w.dtype.name, path
        torch.testing.assert_close(g, torch.as_tensor(np.array(w)), **tol,
                                   msg=path)


@dataclasses.dataclass(frozen=True)
class Ref:
    jcfg: object
    cfg: object
    jp: dict
    cp: dict
    prefill: object
    decode: object


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """Both configs, the reference's gated params and the port's copy, the
    reference's jitted serving steps."""
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = convert.model_config_from_jax(jcfg)
    jp = _gated(jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    return Ref(jcfg, cfg, jp, convert.lm_params_from_jax(_np(jp)),
               jax.jit(jsteps.make_prefill_step(jcfg)),
               jax.jit(jsteps.make_decode_step(jcfg, circular=False)))


def _batch(cfg, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32)
    extras = _extras(cfg, B, seed) if cfg.family in ("vlm", "audio") else {}
    return dict(extras, tokens=toks)


@functools.lru_cache(maxsize=None)
def _prefilled(arch):
    """The reference's prefill of ``_batch`` and its loaded decode cache."""
    r = _ref(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(r.cfg).items()}
    logits, pf = r.prefill(r.jp, batch)
    cache = jserve._load_prefill(
        r.jcfg, jtf.init_decode_cache(r.jcfg, B, TOTAL), pf, PROMPT)
    return logits, pf, cache


# ---------------------------------------------------------------------------
# (a) caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_init_decode_cache_matches_reference(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    for length, kw in ((TOTAL, {}), (10_000, dict(sliding=True)),
                       (WINDOW, dict(sliding=True))):
        want = jtf.init_decode_cache(jcfg, 1, length, **kw)
        got = ttf.init_decode_cache(cfg, 1, length, **kw)
        _close_tree(got, want, dict(rtol=0, atol=0))
    if cfg.family in ("dense", "moe"):  # capped at LONG_CONTEXT_WINDOW
        assert got["k"].shape[2] == WINDOW
        assert ttf.init_decode_cache(cfg, 1, 10_000, sliding=True)[
            "k"].shape[2] == configs.LONG_CONTEXT_WINDOW


# ---------------------------------------------------------------------------
# (b) prefill, (c) decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_prefill_and_load_prefill_match_reference(arch):
    r = _ref(arch)
    want_logits, want_pf, want_cache = _prefilled(arch)
    batch = {k: torch.as_tensor(v) for k, v in _batch(r.cfg).items()}
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    logits, pf = ttf.prefill(r.cp, r.cfg, batch["tokens"], extras)
    assert logits.shape == (B, 1, r.cfg.vocab_size)
    torch.testing.assert_close(logits, torch.as_tensor(np.array(
        want_logits)), **TOL)
    _close_tree(pf, want_pf)
    step_logits, step_pf = tsteps.make_prefill_step(r.cfg)(r.cp, batch)
    assert torch.equal(step_logits, logits)
    cache = tserve._load_prefill(
        r.cfg, ttf.init_decode_cache(r.cfg, B, TOTAL), step_pf, PROMPT)
    _close_tree(cache, want_cache)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_decode_step_matches_reference(arch):
    r = _ref(arch)
    _, _, loaded = _prefilled(arch)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, r.cfg.vocab_size, size=(B, 1)).astype(np.int32)
    zero = jtf.init_decode_cache(r.jcfg, B, TOTAL)
    decode = tsteps.make_decode_step(r.cfg, circular=False)
    for pos, jcache in ((PROMPT, loaded), (3, zero)):
        want_logits, want_cache = r.decode(r.jp, jcache, jnp.asarray(tok),
                                           jnp.int32(pos))
        cache = convert.decode_cache_from_jax(_np(jcache))
        before = [t.clone() for _, t in _leaves(cache)]
        logits, new = ttf.decode_step(r.cp, r.cfg, cache,
                                      torch.as_tensor(tok), pos)
        assert logits.shape == (B, 1, r.cfg.vocab_size)
        torch.testing.assert_close(logits, torch.as_tensor(np.array(
            want_logits)), **TOL)
        _close_tree(new, want_cache)
        # the input cache is left as it was
        assert all(torch.equal(a, b) for a, (_, b) in
                   zip(before, _leaves(cache)))
        s_logits, s_new = decode(r.cp, cache, torch.as_tensor(tok), pos)
        assert torch.equal(s_logits, logits)
        _close_tree(s_new, _np(new), dict(rtol=0, atol=0))


# ---------------------------------------------------------------------------
# (d) circular decode past the window
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", CIRCULAR_ARCHS)
def test_circular_decode_matches_reference(arch):
    r = _ref(arch)
    decode = jax.jit(jsteps.make_decode_step(r.jcfg, circular=True))
    jcache = jtf.init_decode_cache(r.jcfg, B, WINDOW, sliding=True)
    cache = ttf.init_decode_cache(r.cfg, B, WINDOW, sliding=True)
    tok = np.ones((B, 1), np.int32)
    for pos in CIRCULAR_POS:
        want_logits, jcache = decode(r.jp, jcache, jnp.asarray(tok),
                                     jnp.int32(pos))
        logits, cache = ttf.decode_step(r.cp, r.cfg, cache,
                                        torch.as_tensor(tok), pos,
                                        circular=True)
        torch.testing.assert_close(logits, torch.as_tensor(np.array(
            want_logits)), **TOL, msg=f"pos {pos}")
        _close_tree(cache, jcache)


# ---------------------------------------------------------------------------
# (e) serve
# ---------------------------------------------------------------------------
def _reference_serve(arch):
    """The reference's ``serve`` loop for ``--reduced --batch 2
    --prompt-len 32 --gen 16 --seed 0``, with its jitted steps: each step's
    logits and token."""
    r = _ref(arch)
    params = jtf.init_params(r.jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, r.cfg.vocab_size,
                                                (B, PROMPT)), jnp.int32)}
    if r.cfg.family == "vlm":
        batch["vision_embeds"] = jnp.zeros(
            (B, r.cfg.n_vision_tokens, r.cfg.vision_dim), jnp.float32)
    if r.cfg.family == "audio":
        batch["audio_embeds"] = jnp.zeros(
            (B, r.cfg.n_audio_frames, r.cfg.d_model), jnp.float32)
    logits, pf = r.prefill(params, batch)
    cache = jserve._load_prefill(
        r.jcfg, jtf.init_decode_cache(r.jcfg, B, TOTAL), pf, PROMPT)
    out = [np.array(logits)]
    for i in range(GEN):
        token = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
        logits, cache = r.decode(params, cache, token[:, None],
                                 jnp.int32(PROMPT + i))
        out.append(np.array(logits))
    return out


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_matches_reference_loop(arch, capsys):
    want = _reference_serve(arch)
    args = tserve.parser().parse_args(
        ["--arch", arch, "--reduced", "--batch", str(B), "--prompt-len",
         str(PROMPT), "--gen", str(GEN), "--seed", "0"])
    got = tserve.serve(args, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith(f"prefill {PROMPT} tokens: ")
    assert f"decoded {GEN} x {B} tokens in " in out
    assert got.tokens.shape == (B, GEN + 1) and len(got.logits) == GEN + 1
    compared = 0
    for step, (g, w) in enumerate(zip(got.logits, want)):
        torch.testing.assert_close(g, torch.as_tensor(w), **TOL,
                                   msg=f"step {step}")
        top2 = np.sort(w[:, -1], axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0] <= GAP).any():
            break  # the greedy choice is within the tolerance: stop here
        assert torch.equal(got.tokens[:, step],
                           torch.as_tensor(w[:, -1].argmax(-1)))
        compared += 1
    assert compared == GEN + 1, f"{arch}: tokens compared at {compared} steps"
    assert torch.isfinite(got.logits[-1]).all()


# ---------------------------------------------------------------------------
# (f) the decode functions one by one
# ---------------------------------------------------------------------------
def _t(a):
    return torch.as_tensor(np.array(a))


def test_conv_step_matches_reference():
    rng = np.random.default_rng(3)
    state, x, w, b = (rng.normal(size=sh).astype(np.float32) for sh in
                      ((2, 3, 8), (2, 8), (4, 8), (8,)))
    for bias in (b, None):
        jst, jy = jscan.conv_step(jnp.asarray(state), jnp.asarray(x),
                                  jnp.asarray(w), None if bias is None
                                  else jnp.asarray(bias))
        tst, ty = tscan.conv_step(_t(state), _t(x), _t(w),
                                  None if bias is None else _t(bias))
        assert torch.equal(tst, _t(jst))
        torch.testing.assert_close(ty, _t(jy), **TOL)


# (n_heads, n_kv_heads, cache slots, position, circular, softcap)
DECODE_ATTN = {"linear": (4, 2, 8, 3, False, 0.0),
               "past_end": (4, 2, 8, 11, False, 0.0),
               "ring": (4, 2, 8, 5, True, 0.0),
               "wrapped": (4, 2, 8, 13, True, 0.0),
               "softcap": (4, 2, 8, 6, False, 30.0),
               "mqa": (4, 1, 8, 2, True, 0.0)}


@pytest.mark.parametrize("case", sorted(DECODE_ATTN))
def test_decode_self_attention_matches_reference(case):
    h, kv, t, pos, circular, softcap = DECODE_ATTN[case]
    d, hd = 32, 16
    jp = jattn.init_attention(jax.random.PRNGKey(5), d, h, kv, hd,
                              jnp.float32)
    cp = {k: _t(v) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 1, d)).astype(np.float32)
    ck, cv = (rng.normal(size=(2, t, kv, hd)).astype(np.float32)
              for _ in range(2))
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=hd, use_rope=True,
              rope_theta=10_000.0, circular=circular, softcap=softcap)
    jout, (jk, jv) = jattn.decode_self_attention(
        jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(pos), **kw)
    tk, tv = _t(ck), _t(cv)
    tout, (nk, nv) = tattn.decode_self_attention(cp, _t(x), tk, tv, pos,
                                                 **kw)
    torch.testing.assert_close(tout, _t(jout), **TOL)
    torch.testing.assert_close(nk, _t(jk), **TOL)
    torch.testing.assert_close(nv, _t(jv), **TOL)
    assert torch.equal(tk, _t(ck))  # a copy was written, not the input
    slot = pos % t if circular else min(pos, t - 1)
    assert not torch.equal(nk[:, slot], tk[:, slot])
    jz = jattn.init_kv_cache(2, t, kv, hd, jnp.float32)
    tz = tattn.init_kv_cache(2, t, kv, hd, torch.float32)
    assert all(torch.equal(a, _t(b)) for a, b in zip(tz, jz))


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_recurrent_state_and_decode_match_reference(kind):
    arch = "falcon-mamba-7b" if kind == "mamba" else "recurrentgemma-2b"
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = convert.model_config_from_jax(jcfg)
    jmod, tmod = (jssm, tssm) if kind == "mamba" else (jrglru, trglru)
    jinit = jssm.init_mamba_block if kind == "mamba" else \
        jrglru.init_rglru_block
    jp = jinit(jax.random.PRNGKey(6), jcfg, jnp.float32)
    cp = {k: _t(v) for k, v in jp.items()}
    width = cfg.d_inner if kind == "mamba" else cfg.lru_width
    jz = getattr(jmod, f"init_{kind}_state")(2, jcfg, jnp.float32)
    tz = getattr(tmod, f"init_{kind}_state")(2, cfg, torch.float32)
    for a, b in zip(tz, jz):
        assert a.dtype == torch.float32 and torch.equal(a, _t(b))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(2, cfg.d_conv - 1, width)).astype(np.float32)
    h = rng.normal(size=tz[1].shape).astype(np.float32)
    fwd = f"{kind}_forward"
    jout, (jconv, jh) = getattr(jmod, fwd)(
        jp, jnp.asarray(x), jcfg, chunk=4,
        state=(jnp.asarray(conv), jnp.asarray(h)), return_state=True)
    tout, (tconv, th) = getattr(tmod, fwd)(
        cp, _t(x), cfg, chunk=4, state=(_t(conv), _t(h)), return_state=True)
    torch.testing.assert_close(tout, _t(jout), **TOL)
    torch.testing.assert_close(tconv, _t(jconv), **TOL)  # its last inputs
    assert tconv.shape == (2, cfg.d_conv - 1, width)
    torch.testing.assert_close(th, _t(jh), **TOL)
    step = f"{kind}_decode_step"
    jout, (jconv, jh) = getattr(jmod, step)(
        jp, jnp.asarray(x[:, :1]), (jnp.asarray(conv), jnp.asarray(h)), jcfg)
    tout, (tconv, th) = getattr(tmod, step)(cp, _t(x[:, :1]),
                                            (_t(conv), _t(h)), cfg)
    torch.testing.assert_close(tout, _t(jout), **TOL)
    torch.testing.assert_close(tconv, _t(jconv), **TOL)
    torch.testing.assert_close(th, _t(jh), **TOL)
