"""The port's vlm (llama-3.2-vision: gated cross-attention layers over vision
embeddings) and audio (whisper: an encoder over frame embeddings, a decoder
with cross-attention) families against the JAX package, on the CPU.

(a) ``init_params`` bitwise and in leaf order, the vlm at ``reduced()``'s
    one superblock and at 4 layers (two superblocks: the doubly stacked
    ``blocks/self/*`` leaves past one), whisper at ``reduced()``.
(b) ``cross_attention`` (query chunks, a ragged chunking), the encoder's
    ``_bidir_attn`` and ``encode_audio`` over a frame count that is not a
    multiple of the query chunk (as whisper's 1500 frames are not), and
    ``sinusoidal_positions`` bitwise.
(c) ``lm_loss`` and its gradient, through autograd with ``remat`` on and
    off: the gates are zero at init and both entry points feed zero
    embeddings, so that the cross layers compute nothing; here both gates
    are 0.5 on both sides and the embeddings seeded normal draws.
(d) ``run_cluster --reduced`` for both families against the reference's
    CLI on the Auto-axis mesh of ``tests/test_torch_steps.py``; the
    federated path (``run_federated``) fails on both families on both
    sides, as the reference's loader batch carries no embeddings.

Tolerances: forward values within rtol 1e-5 (atol 1e-6; hidden states atol
1e-5); gradients within rtol 1e-4 / atol 1e-6; the init and the sinusoidal
table bitwise (the table at whisper's (1500, 512) to one ulp at one entry:
the C library's ``cosf`` takes an FMA variant there); printed losses to
their 4 printed decimals; checkpointed params within a relative L2 error of
1e-3.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core.algorithms import registry as talg  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from test_torch_steps import (  # noqa: E402,F401
    PARAMS_REL_L2, _np, _one_thread, _rel_l2, auto_mesh)

FWD = dict(rtol=1e-5, atol=1e-6)
HIDDEN = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
VLM, AUDIO = "llama-3.2-vision-11b", "whisper-base"
GATE = 0.5
# (arch, n_layers or None for reduced()'s)
MODELS = [(VLM, None), (VLM, 4), (AUDIO, None)]


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol):
    torch.testing.assert_close(got, _t(want), **tol)


def _cfgs(arch, n_layers=None):
    jcfg = jconfigs.get_config(arch).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    return jcfg, convert.model_config_from_jax(jcfg)


def _gated(jp):
    """The reference's params with both gates of every cross layer set."""
    if "cross" not in jp["blocks"]:
        return jp
    cross = dict(jp["blocks"]["cross"])
    for g in ("gate_attn", "gate_mlp"):
        cross[g] = jnp.full_like(cross[g], GATE)
    return dict(jp, blocks=dict(jp["blocks"], cross=cross))


def _extras(cfg, b, seed):
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"vision_embeds": rng.normal(
            size=(b, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)}
    return {"audio_embeds": rng.normal(
        size=(b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)}


# ---------------------------------------------------------------------------
# (a) init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,n_layers", MODELS)
def test_init_params_bitwise_and_leaf_order(arch, n_layers):
    jcfg, cfg = _cfgs(arch, n_layers)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(4))
    tp = ttf.init_params(cfg, trandom.PRNGKey(4))
    paths = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert sorted(tp) == paths
    cp = convert.lm_params_from_jax(_np(jp))
    for k in cp:
        assert tp[k].dtype == cp[k].dtype and torch.equal(tp[k], cp[k]), k
    assert torch.equal(talg.flatten_vec(tp), talg.flatten_vec(cp))
    if cfg.family == "vlm":
        n_super = cfg.n_layers // cfg.cross_attn_every
        assert tp["blocks/self/attn/wq"].shape[:2] == (
            n_super, cfg.cross_attn_every - 1)
        assert tp["blocks/cross/attn/wk"].shape == (
            n_super, cfg.vision_dim, cfg.n_kv_heads * cfg.head_dim)
        assert not tp["blocks/cross/gate_attn"].any()
    else:
        assert tp["encoder/blocks/attn/wq"].shape[0] == cfg.n_encoder_layers
        assert "pos_embed" in tp and "blocks/cross_attn/wk" in tp


# ---------------------------------------------------------------------------
# (b) cross-attention, the encoder, the sinusoidal table
# ---------------------------------------------------------------------------
# (n_heads, n_kv_heads, q_chunk, queries, keys)
CROSS_CASES = {"gqa": (4, 2, 1024, 9, 16), "chunked": (4, 2, 4, 12, 7),
               "ragged": (2, 1, 8, 15, 20)}


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_cross_attention_matches_reference(case):
    h, kv, q_chunk, s, t = CROSS_CASES[case]
    d, d_kv, hd = 32, 24, 16
    jp = jattn.init_attention(jax.random.PRNGKey(6), d, h, kv, hd,
                              jnp.float32, kv_input_dim=d_kv)
    tp = tattn.init_attention(trandom.PRNGKey(6), d, h, kv, hd,
                              torch.float32, kv_input_dim=d_kv)
    for k in jp:
        assert torch.equal(tp[k], _t(jp[k])), k
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    ctx = rng.normal(size=(2, t, d_kv)).astype(np.float32)
    jk, jv = jattn.project_kv(jp, jnp.asarray(ctx), kv, hd)
    tk, tv = tattn.project_kv(tp, _t(ctx), kv, hd)
    _close(tk, jk, FWD)
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=hd, q_chunk=q_chunk)
    _close(tattn.cross_attention(tp, _t(x), _t(jk), _t(jv), **kw),
           jattn.cross_attention(jp, jnp.asarray(x), jk, jv, **kw), FWD)


def test_encoder_matches_reference():
    """``_bidir_attn`` and ``encode_audio`` over 30 frames in query chunks of
    8: the reference scans chunks of 6 (the largest divisor), the port
    loops over them."""
    jcfg, cfg = _cfgs(AUDIO)
    jcfg = dataclasses.replace(jcfg, n_audio_frames=30)
    cfg = dataclasses.replace(cfg, n_audio_frames=30)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(8))
    cp = convert.lm_params_from_jax(_np(jp))
    audio = _extras(cfg, 2, 9)["audio_embeds"]
    jl0 = jax.tree.map(lambda a: a[0], jp["encoder"]["blocks"])
    tl0 = {k.split("/", 2)[2]: v[0] for k, v in cp.items()
           if k.startswith("encoder/blocks/")}
    tl0 = ttf.nest_params(tl0)
    h = np.asarray(jlayers.apply_norm(jl0["norm1"], jnp.asarray(audio),
                                      jcfg.norm_type))
    _close(ttf._bidir_attn(tl0, _t(h), cfg, 8),
           jtf._bidir_attn(jl0, jnp.asarray(h), jcfg, 8), FWD)
    _close(ttf.encode_audio(cp, cfg, _t(audio), q_chunk=8),
           jtf.encode_audio(jp, jcfg, jnp.asarray(audio), q_chunk=8), HIDDEN)


@pytest.mark.parametrize("n_pos,d", [(16, 128), (50, 16), (64, 64),
                                     (1500, 512)])
def test_sinusoidal_positions_bitwise(n_pos, d):
    want = np.asarray(jlayers.sinusoidal_positions(n_pos, d))
    got = tlayers.sinusoidal_positions(n_pos, d).numpy()
    assert got.dtype == want.dtype == np.float32
    off = np.argwhere(got != want)
    if (n_pos, d) != (1500, 512):
        assert off.size == 0
    else:  # whisper's table: one cosf an ulp from the C library's
        assert len(off) <= 1
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


# ---------------------------------------------------------------------------
# (c) loss and gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,n_layers", MODELS)
def test_lm_loss_and_gradient_match_reference(arch, n_layers):
    jcfg, cfg = _cfgs(arch, n_layers)
    jp = _gated(jtf.init_params(jcfg, jax.random.PRNGKey(1)))
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 2, 12)).astype(np.int32)
    batch = dict(_extras(cfg, 2, 3), tokens=toks[0], labels=toks[1])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jb, remat=False), has_aux=True)(jp)
    cg = convert.lm_params_from_jax(_np(jg))
    for remat in (False, True):
        cp = {k: v.requires_grad_() for k, v in
              convert.lm_params_from_jax(_np(jp)).items()}
        tl, taux = ttf.lm_loss(cp, cfg, tb, remat=remat)
        tl.backward()
        _close(tl.detach(), jl, FWD)
        _close(taux["xent"].detach(), jaux["xent"], FWD)
        for k in cg:
            torch.testing.assert_close(cp[k].grad, cg[k], **GRAD)
    if cfg.family == "vlm":  # the gates learn: their gradients are not 0
        assert cg["blocks/cross/gate_attn"].abs().min() > 0


# ---------------------------------------------------------------------------
# (d) the CLIs
# ---------------------------------------------------------------------------
def _losses(out: str):
    import re
    return [float(x) for x in re.findall(r"^step +\d+ +loss ([0-9.]+)", out,
                                         re.M)]


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_run_cluster_matches_reference(arch, tmp_path, monkeypatch, capsys):
    argv = ["--arch", arch, "--reduced", "--cluster", "--steps", "4",
            "--seq-len", "16", "--batch", "8", "--lr", "3e-3",
            "--compression", "int8"]
    monkeypatch.setattr(jtrain, "make_local_mesh", auto_mesh)
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--ckpt-dir", str(tmp_path / "j")])
    jtrain.main()
    want = capsys.readouterr().out
    ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "t")], device="cpu")
    got = capsys.readouterr().out
    assert len(_losses(got)) == 4 and _losses(got) == _losses(want)
    assert got.splitlines()[-1] == want.splitlines()[-1]
    like = jtf.init_params(jconfigs.get_config(arch).reduced(),
                           jax.random.PRNGKey(9))
    mine = convert.lm_params_from_jax(_np(jckpt.load_checkpoint(
        str(tmp_path / "t"), 4, like)))
    ref = convert.lm_params_from_jax(_np(jckpt.load_checkpoint(
        str(tmp_path / "j"), 4, like)))
    assert _rel_l2(mine, ref) < PARAMS_REL_L2


@pytest.mark.parametrize("arch,key", [(VLM, "vision_embeds"),
                                      (AUDIO, "audio_embeds")])
def test_run_federated_fails_on_both_sides(arch, key, monkeypatch):
    argv = ["--arch", arch, "--reduced", "--rounds", "1", "--n-devices", "2",
            "--n-scheduled", "1", "--seq-len", "8", "--batch", "2",
            "--local-steps", "1"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(KeyError, match=key):
        jtrain.main()
    with pytest.raises(KeyError, match=key):
        ttrain.main(argv, device="cpu")
