"""Decoder-only transformer LMs: the dense, moe, ssm (mamba) and hybrid
(RG-LRU + local attention) families. Port of the training path of
``repro/models/transformer.py``.

The port's parameters are a flat dict whose keys are the reference's tree
paths joined with ``/`` (``"blocks/attn/wq"``, ``"embed"``,
``"final_norm/scale"``; a list entry by its index, hybrid's
``"rest/0/rec/w_a"``): sorted, they are in ``jax.tree.leaves`` order,
because ``/`` sorts below every letter, digit and ``_``, so the engine's
flat (D,) message is the reference's coordinate for coordinate. Layers keep
the reference's leading layer axis (``blocks/*`` leaves are ``(L, ...)``;
hybrid's ``blocks/p{i}_{kind}/*`` are ``(L // period, ...)``, one entry per
pattern period), and ``forward_trunk`` runs them in a Python loop where the
reference scans.

The vlm and audio families (fed vision or audio embeddings, which only the
cluster trainer makes), prefill and decode raise or are absent (ROADMAP
queue A). ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``) where autograd records the forward, as the
reference's ``jax.checkpoint`` of its scan body does; under ``torch.func``
(the federated engine's per-client grads) the layers run as they are. The
numbers are the same either way.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as trandom
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       embed_tokens, init_embedding, init_mlp,
                                       init_norm, stacked_init, torch_dtype)

Params = Dict[str, Any]


FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the port "
            f"runs the {', '.join(FAMILIES)} families (ROADMAP queue A)")


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
    else:  # hybrid: one stack per pattern position, the remainder listed
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
    return flatten_params(params)


# ===========================================================================
# Blocks, embedding, unembedding
# ===========================================================================
def _attn_block_fwd(p: Params, x, cfg: ModelConfig, *, window,
                    q_chunk: int = 1024):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    x = x + attn.self_attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, use_rope=cfg.use_rope,
        rope_theta=cfg.rope_theta, window=window, softcap=cfg.logit_softcap,
        q_chunk=q_chunk)
    h2 = apply_norm(p["norm2"], x, cfg.norm_type)
    if cfg.family == "moe" and "router" in p["mlp"]:
        out, aux = moe_mod.moe_forward(p["mlp"], h2, cfg)
    else:
        out = apply_mlp(p["mlp"], h2, cfg.mlp_type)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


def _rglru_block_fwd(p: Params, x, cfg: ModelConfig):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    x = x + rglru_mod.rglru_forward(p["rec"], h, cfg)
    h2 = apply_norm(p["norm2"], x, cfg.norm_type)
    return x + apply_mlp(p["mlp"], h2, cfg.mlp_type)


def _mamba_block_fwd(p: Params, x, cfg: ModelConfig):
    h = apply_norm(p["norm"], x, cfg.norm_type)
    return x + ssm_mod.mamba_forward(p["mamba"], h, cfg)


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor):
    x = embed_tokens(params["embed"], tokens, scale_by_dim=cfg.tie_embeddings)
    if cfg.pos_embed == "learned":
        table = params["pos_embed"]
        idx = torch.arange(tokens.shape[1],
                           device=tokens.device) % table.shape[0]
        x = x + table[idx][None, :, :]
    return x


def unembed(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    params = nest_params(params)
    h = apply_norm(params["final_norm"], h, cfg.norm_type)
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ table


# ===========================================================================
# Forward (train trunk) and loss
# ===========================================================================
def _remat(fn: Callable, remat: bool) -> Callable:
    """``fn``, recomputed in the backward instead of keeping its
    activations where ``remat`` asks for it and autograd (not a
    ``torch.func`` transform) records the forward."""
    if not (remat and torch.is_grad_enabled()
            and not torch._C._are_functorch_transforms_active()):
        return fn
    # no layer draws random numbers, so the RNG state (a device-to-host copy
    # a layer) need not be saved for the recomputation
    return lambda *a, **kw: checkpoint(fn, *a, use_reentrant=False,
                                       preserve_rng_state=False, **kw)


def forward_trunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  extras: Optional[Dict[str, torch.Tensor]] = None, *,
                  remat: bool = True, q_chunk: int = 1024):
    """Embedding + all blocks; returns (hidden (B,S,d), aux, None).
    ``extras`` is accepted for the reference's signature; ``remat``
    recomputes each layer in the backward."""
    del extras
    _check_family(cfg)
    params = nest_params(params)
    x = _embed(params, cfg, tokens)
    window = cfg.sliding_window if cfg.attn_type == "sliding" else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks, fam = params["blocks"], cfg.family
    attn_fwd = _remat(_attn_block_fwd, remat)
    if fam in ("dense", "moe"):
        for p_l in _unstack(blocks, cfg.n_layers):
            x, a = attn_fwd(p_l, x, cfg, window=window, q_chunk=q_chunk)
            aux = aux + a
    elif fam == "ssm":
        mamba_fwd = _remat(_mamba_block_fwd, remat)
        for p_l in _unstack(blocks, cfg.n_layers):
            x = mamba_fwd(p_l, x, cfg)
    else:  # hybrid: the pattern periods, then the remainder
        n_super = cfg.n_layers // len(cfg.block_pattern)
        stacks = [_unstack(blocks[f"p{i}_{kind}"], n_super)
                  for i, kind in enumerate(cfg.block_pattern)]
        layers = [(kind, stacks[i][n]) for n in range(n_super)
                  for i, kind in enumerate(cfg.block_pattern)]
        layers += [("rglru" if "rec" in p_l else "attn", p_l)
                   for p_l in params.get("rest", [])]
        rglru_fwd = _remat(_rglru_block_fwd, remat)
        for kind, p_l in layers:
            if kind == "rglru":
                x = rglru_fwd(p_l, x, cfg)
            else:
                x, _ = attn_fwd(p_l, x, cfg, window=window, q_chunk=q_chunk)
    return x, aux, None


def chunked_xent(params: Params, cfg: ModelConfig, h: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy, (B,S,V) logits one sequence chunk at a
    time."""
    b, s, _ = h.shape
    if s % chunk or s <= chunk:
        chunk = s
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        logits = unembed(params, cfg, h[:, c0:c0 + chunk]).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, c0:c0 + chunk, None].long())[..., 0]
        tot = tot + (lse - gold).sum()
    return tot / (b * s)


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full forward + loss. batch: tokens, labels."""
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    h, aux, _ = forward_trunk(params, cfg, batch["tokens"], extras,
                              remat=remat)
    xent = chunked_xent(params, cfg, h, batch["labels"])
    loss = xent + cfg.router_aux_weight * aux
    return loss, {"xent": xent, "aux": aux}
