"""Transformer stacks for all six families: dense, moe, ssm (mamba), hybrid
(RG-LRU + local attention), vlm (gated cross-attention layers over vision
embeddings) and audio (whisper's encoder-decoder). Port of
``repro/models/transformer.py``: init, the training forward and loss,
prefill and one-token decode with KV and recurrent caches.

The port's parameters are a flat dict whose keys are the reference's tree
paths joined with ``/`` (``"blocks/attn/wq"``, ``"embed"``,
``"final_norm/scale"``; a list entry by its index, hybrid's
``"rest/0/rec/w_a"``): sorted, they are in ``jax.tree.leaves`` order,
because ``/`` sorts below every letter, digit and ``_``, so the engine's
flat (D,) message is the reference's coordinate for coordinate. Layers keep
the reference's leading layer axis (``blocks/*`` leaves are ``(L, ...)``;
hybrid's ``blocks/p{i}_{kind}/*`` are ``(L // period, ...)``, one entry per
pattern period; the vlm's ``blocks/self/*`` are ``(L // every, every - 1,
...)`` and ``blocks/cross/*`` ``(L // every, ...)``), and the stacks run
in Python loops where the reference scans.

``remat`` recomputes each layer in the backward (``torch.utils.checkpoint``)
where autograd records the forward, as the reference's ``jax.checkpoint``
of its scan body does; under ``torch.func`` (the federated engine's
per-client grads) the layers run as they are. The numbers are the same
either way. Caches are the reference's pytrees: nested dicts of stacked
tensors and, for hybrid's ``rest``, a list of tuples. A decode step takes
its position as a Python int and returns a new cache, its input untouched.

Over a mesh's ``model`` axis (``models/tp.py``, named by the step builders)
each member computes with its blocks of the leaves the axis splits
(``launch/sharding.py::held_spec``): its q and kv heads, its columns of
the MLP, its channels of the mamba and RG-LRU blocks (``models/ssm.py``,
``models/rglru.py``), its rows of the vocabulary in the embedding, the
unembedding and the cross-entropy (whose max, sum of exps and gold logit
are reduced over ``model``; the (B, chunk, V) logits are never gathered),
and its block of each cache leaf on the dim the cache rule gives it (kv
heads, recurrent channels, or positions, over which decode attention's
softmax is reduced).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as trandom
from repro_torch.configs.base import LONG_CONTEXT_WINDOW, ModelConfig
from repro_torch.launch import sharding as shard_rules
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import tp
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xla_math
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       embed_tokens, init_embedding, init_mlp,
                                       init_norm, sinusoidal_positions,
                                       stacked_init, torch_dtype)

Params = Dict[str, Any]
PyTree = Any


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


def flatten_params(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict (or list) of tensors -> the port's flat ``/``-keyed
    dict; a list entry is keyed by its index (hybrid's ``rest`` has fewer
    entries than a pattern period, so its indices sort in leaf order)."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flatten_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _lists(node):
    """Nodes whose keys are all indices back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def nest_params(params: Params) -> Params:
    """The flat ``/``-keyed dict -> nested dicts (and lists) of the same
    tensors (a nested dict passes through)."""
    out: Params = {}
    for k, v in params.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return _lists(out)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stack, every leaf unbound from its leading axis
    once: the backward of ``unbind`` stacks the layers' gradients in one
    pass, where indexing layer by layer would add each layer's gradient
    into a zero-filled copy of the whole stack."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return tree.unbind(0)


def _stack(layers: list) -> Any:
    """Per-layer cache entries (tensors, or tuples of them) -> one stack a
    leaf, as the reference's scan stacks them."""
    if isinstance(layers[0], tuple):
        return tuple(_stack(list(parts)) for parts in zip(*layers))
    return torch.stack(layers)


# ===========================================================================
# init_params
# ===========================================================================
def _init_attn_layer(key, cfg: ModelConfig, dtype, use_moe: bool = False
                     ) -> Params:
    k1, k2, k3, k4 = trandom.split(key, 4)
    p = {
        "norm1": init_norm(k1, cfg.d_model, cfg.norm_type, dtype),
        "attn": attn.init_attention(k2, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim, dtype),
        "norm2": init_norm(k3, cfg.d_model, cfg.norm_type, dtype),
    }
    if use_moe:
        p["mlp"] = moe_mod.init_moe_block(k4, cfg, dtype)
    else:
        p["mlp"] = init_mlp(k4, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)
    return p


def _init_cross_layer(key, cfg: ModelConfig, dtype) -> Params:
    """Gated cross-attention layer (llama-3.2-vision style); both gates
    start at zero."""
    k1, k2, k3, k4 = trandom.split(key, 4)
    return {
        "norm1": init_norm(k1, cfg.d_model, cfg.norm_type, dtype),
        "attn": attn.init_attention(k2, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim, dtype,
                                    kv_input_dim=cfg.vision_dim),
        "norm2": init_norm(k3, cfg.d_model, cfg.norm_type, dtype),
        "mlp": init_mlp(k4, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype),
        "gate_attn": torch.zeros((), dtype=dtype, device=key.device),
        "gate_mlp": torch.zeros((), dtype=dtype, device=key.device),
    }


def _init_mamba_layer(key, cfg: ModelConfig, dtype) -> Params:
    k1, k2 = trandom.split(key)
    return {"norm": init_norm(k1, cfg.d_model, cfg.norm_type, dtype),
            "mamba": ssm_mod.init_mamba_block(k2, cfg, dtype)}


def _init_rglru_layer(key, cfg: ModelConfig, dtype) -> Params:
    k1, k2, k3, k4 = trandom.split(key, 4)
    return {"norm1": init_norm(k1, cfg.d_model, cfg.norm_type, dtype),
            "rec": rglru_mod.init_rglru_block(k2, cfg, dtype),
            "norm2": init_norm(k3, cfg.d_model, cfg.norm_type, dtype),
            "mlp": init_mlp(k4, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)}


def _init_dec_layer(key, cfg: ModelConfig, dtype) -> Params:
    """Whisper decoder layer: self-attn + cross-attn + mlp."""
    k1, k2, k3, k4, k5, k6 = trandom.split(key, 6)
    return {
        "norm1": init_norm(k1, cfg.d_model, cfg.norm_type, dtype),
        "self_attn": attn.init_attention(k2, cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim, dtype),
        "norm2": init_norm(k3, cfg.d_model, cfg.norm_type, dtype),
        "cross_attn": attn.init_attention(k4, cfg.d_model, cfg.n_heads,
                                          cfg.n_kv_heads, cfg.head_dim,
                                          dtype),
        "norm3": init_norm(k5, cfg.d_model, cfg.norm_type, dtype),
        "mlp": init_mlp(k6, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype),
    }


def init_params(cfg: ModelConfig, key: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's ``init_params`` from the same threefry key, on the
    key's device: the same draws in the same order, one leaf at a time."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    keys = trandom.split(key, 8)
    params: Params = {
        "embed": init_embedding(keys[0], cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(keys[1], cfg.d_model, cfg.norm_type, dtype)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(keys[2], (cfg.d_model, cfg.vocab_size),
                                       dtype)
    if cfg.pos_embed == "learned":
        params["pos_embed"] = dense_init(keys[3], (cfg.max_position,
                                                   cfg.d_model),
                                         dtype, scale=0.02)
    fam = cfg.family
    if fam in ("dense", "moe"):
        params["blocks"] = stacked_init(
            lambda k: _init_attn_layer(k, cfg, dtype, fam == "moe"),
            keys[4], cfg.n_layers)
    elif fam == "ssm":
        params["blocks"] = stacked_init(
            lambda k: _init_mamba_layer(k, cfg, dtype), keys[4], cfg.n_layers)
    elif fam == "hybrid":  # one stack per pattern position, the rest listed
        pat = cfg.block_pattern
        n_super, rem = divmod(cfg.n_layers, len(pat))
        init = {"rglru": _init_rglru_layer, "attn": _init_attn_layer}
        params["blocks"] = {
            f"p{i}_{kind}": stacked_init(
                lambda k, kind=kind: init[kind](k, cfg, dtype),
                trandom.fold_in(keys[4], i), n_super)
            for i, kind in enumerate(pat)}
        params["rest"] = [init[pat[j]](trandom.fold_in(keys[5], j), cfg,
                                       dtype) for j in range(rem)]
    elif fam == "vlm":
        n_self_per = cfg.cross_attn_every - 1
        n_super = cfg.n_layers // cfg.cross_attn_every
        params["blocks"] = {
            "self": stacked_init(
                lambda k: stacked_init(
                    lambda kk: _init_attn_layer(kk, cfg, dtype), k,
                    n_self_per), keys[4], n_super),
            "cross": stacked_init(
                lambda k: _init_cross_layer(k, cfg, dtype), keys[5], n_super),
        }
    else:  # audio
        params["encoder"] = {
            "blocks": stacked_init(
                lambda k: _init_attn_layer(k, cfg, dtype), keys[4],
                cfg.n_encoder_layers),
            "final_norm": init_norm(keys[6], cfg.d_model, cfg.norm_type,
                                    dtype),
        }
        params["blocks"] = stacked_init(
            lambda k: _init_dec_layer(k, cfg, dtype), keys[5], cfg.n_layers)
    return flatten_params(params)


# ===========================================================================
# Blocks (one layer each)
# ===========================================================================
def _attn_block_fwd(p: Params, x, cfg: ModelConfig, *, window,
                    q_chunk: int = 1024, causal: bool = True,
                    return_kv: bool = False):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    if causal:
        res = attn.self_attention(
            p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, use_rope=cfg.use_rope,
            rope_theta=cfg.rope_theta, window=window,
            softcap=cfg.logit_softcap, q_chunk=q_chunk, return_kv=return_kv)
    else:
        res = _bidir_attn(p, h, cfg, q_chunk)
    if return_kv:
        res, kv = res
    x = x + res
    h2 = apply_norm(p["norm2"], x, cfg.norm_type)
    if cfg.family == "moe" and "router" in p["mlp"]:
        out, aux = moe_mod.moe_forward(p["mlp"], h2, cfg)
    else:
        out = apply_mlp(p["mlp"], h2, cfg.mlp_type, cfg.d_ff)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv:
        return x + out, aux, kv
    return x + out, aux


def _bidir_attn(p: Params, h, cfg: ModelConfig, q_chunk: int):
    """Whisper encoder: bidirectional self-attention (no mask, no rope)."""
    pa, nh = p["attn"], cfg.n_heads
    h = attn.enter(pa, h, nh, cfg.head_dim)
    q = attn.project_q(pa, h, nh, cfg.head_dim)
    k, v = attn.project_kv(pa, h, cfg.n_kv_heads, cfg.head_dim, nh)
    k, v = attn.local_kv(k, v, q.shape[2], nh, cfg.n_kv_heads)
    out = attn.attention_core(q, k, v, n_kv_heads=k.shape[2],
                              causal=False, q_chunk=q_chunk)
    return attn.project_out(pa, out, nh)


def _attn_block_decode(p: Params, x, ck, cv, pos: int, cfg: ModelConfig, *,
                       circular: bool, cache_len: Optional[int] = None):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    res, (ck, cv) = attn.decode_self_attention(
        p["attn"], h, ck, cv, pos, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        use_rope=cfg.use_rope, rope_theta=cfg.rope_theta, circular=circular,
        softcap=cfg.logit_softcap, cache_len=cache_len)
    x = x + res
    h2 = apply_norm(p["norm2"], x, cfg.norm_type)
    if cfg.family == "moe" and "router" in p["mlp"]:
        out, _ = moe_mod.moe_forward(p["mlp"], h2, cfg)
    else:
        out = apply_mlp(p["mlp"], h2, cfg.mlp_type, cfg.d_ff)
    return x + out, ck, cv


def _gate(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A cross layer's gate, ``tanh`` as the reference's XLA computes it."""
    return xla_math.tanh(g.to(torch.float32)).to(like.dtype)


def _cross_block_fwd(p: Params, x, vis_k, vis_v, cfg: ModelConfig,
                     q_chunk: int = 1024):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    res = attn.cross_attention(p["attn"], h, vis_k, vis_v,
                               n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                               head_dim=cfg.head_dim, q_chunk=q_chunk)
    x = x + _gate(p["gate_attn"], x) * res
    h2 = apply_norm(p["norm2"], x, cfg.norm_type)
    out = apply_mlp(p["mlp"], h2, cfg.mlp_type, cfg.d_ff)
    return x + _gate(p["gate_mlp"], x) * out


def _cross_layer_fwd(p: Params, x, vis, cfg: ModelConfig,
                     q_chunk: int = 1024):
    """A vlm superblock's cross layer: the vision k/v, then the block;
    returns (x, (k, v))."""
    vk, vv = attn.project_kv(
        p["attn"], attn.enter(p["attn"], vis, cfg.n_heads, cfg.head_dim),
        cfg.n_kv_heads, cfg.head_dim, cfg.n_heads)
    return _cross_block_fwd(p, x, vk, vv, cfg, q_chunk=q_chunk), (vk, vv)


def _rglru_block_fwd(p: Params, x, cfg: ModelConfig, *, state=None,
                     return_state: bool = False):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    res = rglru_mod.rglru_forward(p["rec"], h, cfg, state=state,
                                  return_state=return_state)
    if return_state:
        res, st = res
    x = x + res
    h2 = apply_norm(p["norm2"], x, cfg.norm_type)
    x = x + apply_mlp(p["mlp"], h2, cfg.mlp_type, cfg.d_ff)
    return (x, st) if return_state else x


def _rglru_block_decode(p: Params, x, state, cfg: ModelConfig):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    res, state = rglru_mod.rglru_decode_step(p["rec"], h, state, cfg)
    x = x + res
    h2 = apply_norm(p["norm2"], x, cfg.norm_type)
    return x + apply_mlp(p["mlp"], h2, cfg.mlp_type, cfg.d_ff), state


def _mamba_block_fwd(p: Params, x, cfg: ModelConfig, *, state=None,
                     return_state: bool = False):
    h = apply_norm(p["norm"], x, cfg.norm_type)
    res = ssm_mod.mamba_forward(p["mamba"], h, cfg, state=state,
                                return_state=return_state)
    if return_state:
        return x + res[0], res[1]
    return x + res


def _dec_layer_fwd(p: Params, x, enc_k, enc_v, cfg: ModelConfig, *,
                   q_chunk: int = 1024, return_kv: bool = False):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    res = attn.self_attention(
        p["self_attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, use_rope=cfg.use_rope,
        rope_theta=cfg.rope_theta, q_chunk=q_chunk, return_kv=return_kv)
    if return_kv:
        res, kv = res
    x = x + res
    h2 = apply_norm(p["norm2"], x, cfg.norm_type)
    x = x + attn.cross_attention(p["cross_attn"], h2, enc_k, enc_v,
                                 n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads,
                                 head_dim=cfg.head_dim, q_chunk=q_chunk)
    h3 = apply_norm(p["norm3"], x, cfg.norm_type)
    x = x + apply_mlp(p["mlp"], h3, cfg.mlp_type, cfg.d_ff)
    return (x, kv) if return_kv else x


def _audio_layer_fwd(p: Params, x, enc_h, cfg: ModelConfig, *,
                     q_chunk: int = 1024, return_kv: bool = False):
    """A whisper decoder layer over its own k/v of the encoder's output;
    with ``return_kv`` returns (x, (self k, v), (encoder k, v))."""
    pc = p["cross_attn"]
    ek, ev = attn.project_kv(pc, attn.enter(pc, enc_h, cfg.n_heads,
                                            cfg.head_dim),
                             cfg.n_kv_heads, cfg.head_dim, cfg.n_heads)
    out = _dec_layer_fwd(p, x, ek, ev, cfg, q_chunk=q_chunk,
                         return_kv=return_kv)
    return (*out, (ek, ev)) if return_kv else out


# ===========================================================================
# Embedding / unembedding
# ===========================================================================
def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           pos_offset: int = 0):
    x = embed_tokens(params["embed"], tokens, scale_by_dim=cfg.tie_embeddings,
                     vocab=cfg.vocab_size)
    if cfg.pos_embed == "learned":
        table = params["pos_embed"]
        idx = (pos_offset + torch.arange(tokens.shape[1],
                                         device=tokens.device)
               ) % table.shape[0]
        x = x + table[idx][None, :, :]
    return x


def unembed(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    params = nest_params(params)
    """Logits over this member's block of the vocabulary (all of it where
    the table is whole)."""
    h = apply_norm(params["final_norm"], h, cfg.norm_type)
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if table.shape[-1] != cfg.vocab_size:
        h = tp.copy_to(h)
    return h @ table


# ===========================================================================
# Forward (train / prefill trunk) and loss
# ===========================================================================
# the key prefixes of the leaves the trunks run a layer at a time: the
# stacks (``blocks/...``, the audio encoder's) and hybrid's ``rest`` layers
LAYER_KEYS = ("blocks/", "encoder/blocks/", "rest/")


def _layer(fn: Callable, remat: bool, gather: Optional[Callable] = None,
           path: str = "", depth: int = 1) -> Callable:
    """``fn`` over one layer, recomputed in the backward instead of keeping
    its activations where ``remat`` asks for it and autograd (not a
    ``torch.func`` transform) records the forward. With ``gather`` (the
    fsdp step's, ``launch/steps.py``) the layer's params come in as this
    member's blocks of the stack at ``path`` (``depth`` stacked dims cut
    off), and ``gather(fn, path, depth, recomputed)`` gathers them whole
    inside the function that is recomputed, so that the backward gathers
    them again and never keeps them."""
    recomputed = (remat and torch.is_grad_enabled()
                  and not torch._C._are_functorch_transforms_active())
    if gather is not None:
        fn = gather(fn, path, depth, recomputed)
    if not recomputed:
        return fn
    # no layer draws random numbers, so the RNG state (a device-to-host copy
    # a layer) need not be saved for the recomputation
    return lambda *a, **kw: checkpoint(fn, *a, use_reentrant=False,
                                       preserve_rng_state=False, **kw)


def forward_trunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  extras: Optional[Dict[str, torch.Tensor]] = None, *,
                  collect_cache: bool = False, remat: bool = True,
                  q_chunk: int = 1024, gather: Optional[Callable] = None):
    """Embedding + all blocks; returns (hidden (B,S,d), aux, cache|None).
    ``extras`` holds the vlm's ``vision_embeds`` (B, n_vis, vision_dim) or
    the audio family's ``audio_embeds`` (B, frames, d_model).
    ``collect_cache`` also returns the prefill cache (remat off, as the
    reference turns it off); ``remat`` recomputes each layer in the
    backward; ``gather`` (``_layer``) gathers each layer's params from the
    member's blocks of the stacks (and of hybrid's ``rest`` layers)."""
    _check_family(cfg)
    extras = extras or {}
    params = nest_params(params)
    x = _embed(params, cfg, tokens)
    window = cfg.sliding_window if cfg.attn_type == "sliding" else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks, fam = params["blocks"], cfg.family
    remat = remat and not collect_cache
    kw = dict(window=window, q_chunk=q_chunk, return_kv=collect_cache)
    cache = None
    if fam in ("dense", "moe"):
        attn_fwd = _layer(_attn_block_fwd, remat, gather, "blocks")
        kvs = []
        for p_l in _unstack(blocks, cfg.n_layers):
            x, a, *kv = attn_fwd(p_l, x, cfg, **kw)
            aux = aux + a
            kvs += kv
        if collect_cache:
            cache = dict(zip(("k", "v"), _stack(kvs)))  # (L,B,S,K,hd)
    elif fam == "ssm":
        mamba_fwd = _layer(_mamba_block_fwd, remat, gather, "blocks")
        sts = []
        for p_l in _unstack(blocks, cfg.n_layers):
            if collect_cache:
                x, st = mamba_fwd(p_l, x, cfg, return_state=True)
                sts.append(st)
            else:
                x = mamba_fwd(p_l, x, cfg)
        if collect_cache:
            cache = dict(zip(("conv", "ssm"), _stack(sts)))  # (L,B,...)
    elif fam == "hybrid":  # the pattern periods, then the remainder
        x, cache = _hybrid_trunk(params, cfg, x, remat, collect_cache, kw,
                                 gather)
    elif fam == "vlm":
        x, cache = _vlm_trunk(blocks, cfg, x, extras, remat, collect_cache,
                              kw, gather)
    else:  # audio
        enc_h = encode_audio(params, cfg, extras["audio_embeds"],
                             q_chunk=q_chunk, gather=gather)
        layer_fwd = _layer(_audio_layer_fwd, remat, gather, "blocks")
        outs = []
        for p_l in _unstack(blocks, cfg.n_layers):
            out = layer_fwd(p_l, x, enc_h, cfg, q_chunk=q_chunk,
                            return_kv=collect_cache)
            if collect_cache:
                x, kv, ekv = out
                outs.append((*kv, *ekv))
            else:
                x = out
        if collect_cache:
            cache = dict(zip(("k", "v", "cross_k", "cross_v"), _stack(outs)))
    return x, aux, cache


def _hybrid_trunk(params: Params, cfg: ModelConfig, x, remat: bool,
                  collect_cache: bool, kw: dict, gather=None):
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    stacks = [_unstack(params["blocks"][f"p{i}_{kind}"], n_super)
              for i, kind in enumerate(pat)]

    def layer(kind, p_l, x, path, depth=1):
        """-> (x, the layer's cache entry as a tuple, or None)."""
        if kind == "rglru":
            rglru_fwd = _layer(_rglru_block_fwd, remat, gather, path, depth)
            if collect_cache:
                return rglru_fwd(p_l, x, cfg, return_state=True)
            return rglru_fwd(p_l, x, cfg), None
        attn_fwd = _layer(_attn_block_fwd, remat, gather, path, depth)
        x, _, *kv = attn_fwd(p_l, x, cfg, **kw)
        return x, (tuple(kv[0]) if kv else None)

    sup = {}
    for n in range(n_super):
        for i, kind in enumerate(pat):
            x, st = layer(kind, stacks[i][n], x, f"blocks/p{i}_{kind}")
            if collect_cache:
                names = ("conv", "h") if kind == "rglru" else ("k", "v")
                for name, t in zip(names, st):
                    sup.setdefault(f"p{i}_{name}", []).append(t)
    rest = []
    for j, p_l in enumerate(params.get("rest", [])):
        x, st = layer("rglru" if "rec" in p_l else "attn", p_l, x,
                      f"rest/{j}", 0)
        rest.append(st)
    if not collect_cache:
        return x, None
    return x, {"super": {k: torch.stack(v) for k, v in sup.items()},
               "rest": rest}


def _vlm_trunk(blocks: Params, cfg: ModelConfig, x, extras: dict,
               remat: bool, collect_cache: bool, kw: dict, gather=None):
    """Each superblock: its self layers, then the cross layer over its own
    k/v of the vision embeddings."""
    vis = extras["vision_embeds"].to(x.dtype)  # (B, n_vis, vision_dim)
    n_super = cfg.n_layers // cfg.cross_attn_every
    attn_fwd = _layer(_attn_block_fwd, remat, gather, "blocks/self", 2)
    cross_fwd = _layer(_cross_layer_fwd, remat, gather, "blocks/cross")
    self_kv, cross_kv = [], []
    for p_self, p_cross in zip(_unstack(blocks["self"], n_super),
                               _unstack(blocks["cross"], n_super)):
        kvs = []
        for p_l in _unstack(p_self, cfg.cross_attn_every - 1):
            x, _, *kv = attn_fwd(p_l, x, cfg, **kw)
            kvs += kv
        x, vkv = cross_fwd(p_cross, x, vis, cfg, q_chunk=kw["q_chunk"])
        if collect_cache:
            self_kv.append(_stack(kvs))
            cross_kv.append(vkv)
    if not collect_cache:
        return x, None
    (k, v), (ck, cv) = _stack(self_kv), _stack(cross_kv)
    return x, {"k": k, "v": v, "cross_k": ck, "cross_v": cv}


def encode_audio(params: Params, cfg: ModelConfig, audio_embeds,
                 q_chunk: int = 1024, gather: Optional[Callable] = None):
    """Whisper encoder over stub frame embeddings (B, frames, d); its
    layers are not recomputed (``gather``: ``forward_trunk``'s)."""
    params = nest_params(params)
    x = audio_embeds.to(torch_dtype(cfg.dtype))
    pos = sinusoidal_positions(x.shape[1], cfg.d_model,
                               device=x.device).to(x.dtype)
    x = x + pos[None]
    layer_fwd = _layer(_attn_block_fwd, False, gather, "encoder/blocks")
    for p_l in _unstack(params["encoder"]["blocks"], cfg.n_encoder_layers):
        x, _ = layer_fwd(p_l, x, cfg, window=None, q_chunk=q_chunk,
                         causal=False)
    return apply_norm(params["encoder"]["final_norm"], x, cfg.norm_type)


def chunked_xent(params: Params, cfg: ModelConfig, h: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy, (B,S,V) logits one sequence chunk at a
    time; over this member's block of the vocabulary where it splits
    (``_split_lse_gold``)."""
    b, s, _ = h.shape
    if s % chunk or s <= chunk:
        chunk = s
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        logits = unembed(params, cfg, h[:, c0:c0 + chunk]).to(torch.float32)
        lab = labels[:, c0:c0 + chunk].long()
        if logits.shape[-1] != cfg.vocab_size:
            lse, gold = _split_lse_gold(logits, lab)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        tot = tot + (lse - gold).sum()
    return tot / (b * s)


def _split_lse_gold(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp, gold logit) over the whole vocabulary from each member's
    block of the logits: the max over ``model`` (detached, a shift), the
    sum of exps over ``model``, and the gold logit from the member that
    holds it, summed over ``model``."""
    v = logits.shape[-1]
    shift = tp.max_over(logits.amax(dim=-1))
    lse = torch.log(tp.sum_over(
        torch.exp(logits - shift[..., None]).sum(dim=-1))) + shift
    local = labels - tp.index() * v
    mine = (local >= 0) & (local < v)
    gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    gold = tp.sum_over(torch.where(mine, gold, torch.zeros_like(gold)))
    return lse, gold


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = True, gather: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full forward + loss. batch: tokens, labels (+ vision/audio extras);
    ``gather``: ``forward_trunk``'s."""
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    h, aux, _ = forward_trunk(params, cfg, batch["tokens"], extras,
                              remat=remat, gather=gather)
    xent = chunked_xent(params, cfg, h, batch["labels"])
    loss = xent + cfg.router_aux_weight * aux
    return loss, {"xent": xent, "aux": aux}


# ===========================================================================
# Prefill / decode
# ===========================================================================
def init_decode_cache(cfg: ModelConfig, batch: int, length: int, *,
                      sliding: bool = False, device=None,
                      mesh=None) -> PyTree:
    """Zeroed cache pytree for decode, on ``device``. ``length`` = context
    size; ``sliding`` caps attention caches at LONG_CONTEXT_WINDOW (ring
    buffers), and a sliding-attention config at its window. On ``mesh``
    (a global batch of ``batch`` rows), this member's block of every leaf
    under the cache rule (``launch/sharding.py::cache_shardings``): its
    rows over the data axes, and over ``model`` its kv heads, its channels
    of the recurrent states or its block of the positions, wherever the
    rule puts ``model``."""
    if mesh is None:
        return _decode_cache(cfg, batch, length, sliding, device)
    glob = _decode_cache(cfg, batch, length, sliding, "meta")
    return _blocks(glob, shard_rules.cache_shardings(cfg, glob, mesh, batch),
                   mesh, device)


def _blocks(glob, specs, mesh, device):
    """Zeroed blocks under ``specs`` of the leaves of ``glob``, a cache
    pytree of meta tensors."""
    if isinstance(glob, dict):
        return {k: _blocks(v, specs[k], mesh, device) for k, v in glob.items()}
    if isinstance(glob, (list, tuple)):
        return type(glob)(_blocks(g, sp, mesh, device)
                          for g, sp in zip(glob, specs))
    return torch.zeros(shard_rules.shard_shape(glob.shape, specs, mesh),
                       dtype=glob.dtype, device=device)


def _decode_cache(cfg: ModelConfig, batch: int, length: int, sliding: bool,
                  device) -> PyTree:
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    t_attn = min(length, LONG_CONTEXT_WINDOW) if sliding else length
    if cfg.attn_type == "sliding":
        t_attn = min(t_attn, cfg.sliding_window)
    fam = cfg.family
    n_kv, di, w = cfg.n_kv_heads, cfg.d_inner, cfg.lru_width

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def kv(*lead):
        shape = (*lead, batch, t_attn, n_kv, cfg.head_dim)
        return zeros(*shape), zeros(*shape)

    if fam in ("dense", "moe"):
        return dict(zip(("k", "v"), kv(cfg.n_layers)))
    if fam == "ssm":
        return {"conv": zeros(cfg.n_layers, batch, cfg.d_conv - 1, di),
                "ssm": zeros(cfg.n_layers, batch, di, cfg.ssm_state,
                             dt=torch.float32)}
    if fam == "hybrid":
        pat = cfg.block_pattern
        n_super, rem = divmod(cfg.n_layers, len(pat))
        sup = {}
        for i, kind in enumerate(pat):
            if kind == "rglru":
                sup[f"p{i}_conv"] = zeros(n_super, batch, cfg.d_conv - 1, w)
                sup[f"p{i}_h"] = zeros(n_super, batch, w, dt=torch.float32)
            else:
                sup[f"p{i}_k"], sup[f"p{i}_v"] = kv(n_super)
        rest = [(zeros(batch, cfg.d_conv - 1, w),
                 zeros(batch, w, dt=torch.float32))
                if pat[j] == "rglru" else kv() for j in range(rem)]
        return {"super": sup, "rest": rest}
    if fam == "vlm":
        n_super = cfg.n_layers // cfg.cross_attn_every
        k, v = kv(n_super, cfg.cross_attn_every - 1)
        cross = (n_super, batch, cfg.n_vision_tokens, n_kv, cfg.head_dim)
        return {"k": k, "v": v, "cross_k": zeros(*cross),
                "cross_v": zeros(*cross)}
    k, v = kv(cfg.n_layers)  # audio
    cross = (cfg.n_layers, batch, cfg.n_audio_frames, n_kv, cfg.head_dim)
    return {"k": k, "v": v, "cross_k": zeros(*cross),
            "cross_v": zeros(*cross)}


def attention_cache_len(cache: PyTree) -> Optional[int]:
    """The positions T of a whole decode cache's self-attention caches
    (every one of a config has the same), None where it has none."""
    if "k" in cache:
        return cache["k"].shape[-3]
    keys = [k for k in cache.get("super", {}) if k.endswith("_k")]
    kvs = [c for c in cache.get("rest", []) if c[0].dim() == 4]
    if keys:
        return cache["super"][keys[0]].shape[-3]
    return kvs[0][0].shape[-3] if kvs else None


def decode_step(params: Params, cfg: ModelConfig, cache: PyTree,
                token: torch.Tensor, pos: int, *, circular: bool = False,
                cache_len: Optional[int] = None):
    """One decode step. token: (B,1) integers; pos: the absolute position,
    a Python int. Returns (logits (B,1,V), new cache); ``cache`` is left as
    it was. ``cache_len``: the positions T of the whole self-attention
    caches, where a member holds a block of them
    (``attention.decode_self_attention``)."""
    _check_family(cfg)
    pos = int(pos)
    params = nest_params(params)
    x = _embed(params, cfg, token, pos_offset=pos)
    fam, blocks = cfg.family, params["blocks"]
    # attention caches are circular when they are ring buffers (sliding
    # decode or architecturally local attention)
    circ = circular or cfg.attn_type == "sliding"

    if fam in ("dense", "moe"):
        kvs = []
        for p_l, ck, cv in zip(_unstack(blocks, cfg.n_layers), cache["k"],
                               cache["v"]):
            x, ck, cv = _attn_block_decode(p_l, x, ck, cv, pos, cfg,
                                           circular=circ,
                                           cache_len=cache_len)
            kvs.append((ck, cv))
        cache = dict(zip(("k", "v"), _stack(kvs)))
    elif fam == "ssm":
        sts = []
        for p_l, cs, hs in zip(_unstack(blocks, cfg.n_layers),
                               cache["conv"], cache["ssm"]):
            h = apply_norm(p_l["norm"], x, cfg.norm_type)
            res, st = ssm_mod.mamba_decode_step(p_l["mamba"], h, (cs, hs),
                                                cfg)
            x = x + res
            sts.append(st)
        cache = dict(zip(("conv", "ssm"), _stack(sts)))
    elif fam == "hybrid":
        x, cache = _hybrid_decode(blocks, params.get("rest", []), cfg, cache,
                                  x, pos, cache_len)
    elif fam == "vlm":
        n_super = cfg.n_layers // cfg.cross_attn_every
        sup_kvs = []
        for n, (p_self, pc) in enumerate(zip(
                _unstack(blocks["self"], n_super),
                _unstack(blocks["cross"], n_super))):
            kvs = []
            for p_l, ck, cv in zip(_unstack(p_self, cfg.cross_attn_every - 1),
                                   cache["k"][n], cache["v"][n]):
                x, ck, cv = _attn_block_decode(p_l, x, ck, cv, pos, cfg,
                                               circular=circ,
                                               cache_len=cache_len)
                kvs.append((ck, cv))
            sup_kvs.append(_stack(kvs))
            x = _cross_block_fwd(pc, x, cache["cross_k"][n],
                                 cache["cross_v"][n], cfg)
        ks, vs = _stack(sup_kvs)
        cache = dict(cache, k=ks, v=vs)
    else:  # audio
        kvs = []
        for i, p_l in enumerate(_unstack(blocks, cfg.n_layers)):
            h = apply_norm(p_l["norm1"], x, cfg.norm_type)
            res, kv = attn.decode_self_attention(
                p_l["self_attn"], h, cache["k"][i], cache["v"][i], pos,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, use_rope=cfg.use_rope,
                rope_theta=cfg.rope_theta, circular=circ,
                cache_len=cache_len)
            kvs.append(kv)
            x = x + res
            h2 = apply_norm(p_l["norm2"], x, cfg.norm_type)
            x = x + attn.cross_attention(
                p_l["cross_attn"], h2, cache["cross_k"][i],
                cache["cross_v"][i], n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim)
            h3 = apply_norm(p_l["norm3"], x, cfg.norm_type)
            x = x + apply_mlp(p_l["mlp"], h3, cfg.mlp_type, cfg.d_ff)
        ks, vs = _stack(kvs)
        cache = dict(cache, k=ks, v=vs)
    return unembed(params, cfg, x), cache


def _hybrid_decode(blocks: Params, rest_params: list, cfg: ModelConfig,
                   cache: PyTree, x, pos: int, cache_len: Optional[int]):
    """Hybrid decode: its local attention caches are always ring buffers."""
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    stacks = [_unstack(blocks[f"p{i}_{kind}"], n_super)
              for i, kind in enumerate(pat)]
    c, sup = cache["super"], {}
    for n in range(n_super):
        for i, kind in enumerate(pat):
            names = ("conv", "h") if kind == "rglru" else ("k", "v")
            st = tuple(c[f"p{i}_{name}"][n] for name in names)
            if kind == "rglru":
                x, st = _rglru_block_decode(stacks[i][n], x, st, cfg)
            else:
                x, *st = _attn_block_decode(stacks[i][n], x, *st, pos, cfg,
                                            circular=True,
                                            cache_len=cache_len)
            for name, t in zip(names, st):
                sup.setdefault(f"p{i}_{name}", []).append(t)
    rest = []
    for p_l, c_l in zip(rest_params, cache["rest"]):
        if "rec" in p_l:
            x, st = _rglru_block_decode(p_l, x, c_l, cfg)
        else:
            x, *st = _attn_block_decode(p_l, x, *c_l, pos, cfg,
                                        circular=True, cache_len=cache_len)
        rest.append(tuple(st))
    return x, {"super": {k: torch.stack(sup[k]) for k in c}, "rest": rest}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extras: Optional[Dict[str, torch.Tensor]] = None, *,
            q_chunk: int = 1024):
    """Prefill: the full forward; returns (last-token logits (B,1,V), the
    populated cache). For attention families the per-layer (k, v) of the
    forward is the cache; recurrent families carry their final state."""
    h, _, cache = forward_trunk(params, cfg, tokens, extras,
                                collect_cache=True, remat=False,
                                q_chunk=q_chunk)
    return unembed(params, cfg, h[:, -1:, :]), cache
