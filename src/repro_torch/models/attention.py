"""Attention: GQA/MQA self-attention (full, sliding window,
query-chunked), decode with KV caches (linear or circular sliding-window),
and cross-attention. Port of ``repro/models/attention.py``.

Written with matmuls (``einsum``) and ``softmax`` as the reference writes it,
so that the port computes what the reference computes, under ``torch.func``
too; no fused attention. Long sequences are computed in query chunks, so
the live score buffer is O(q_chunk * seq), not O(seq^2).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import random as trandom
from repro_torch.models.layers import apply_rope, dense_init

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def init_attention(key, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype,
                   kv_input_dim: Optional[int] = None) -> Params:
    """q/k/v/o projections. ``kv_input_dim`` overrides the k/v input width
    (cross-attention over vision/encoder states)."""
    kq, kk, kv, ko = trandom.split(key, 4)
    d_kv_in = kv_input_dim if kv_input_dim is not None else d_model
    return {
        "wq": dense_init(kq, (d_model, n_heads * head_dim), dtype),
        "wk": dense_init(kk, (d_kv_in, n_kv_heads * head_dim), dtype),
        "wv": dense_init(kv, (d_kv_in, n_kv_heads * head_dim), dtype),
        "wo": dense_init(ko, (n_heads * head_dim, d_model), dtype),
    }


def project_q(p: Params, x: torch.Tensor, n_heads: int,
              head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return (x @ p["wq"]).reshape(b, s, n_heads, head_dim)


def project_kv(p: Params, x: torch.Tensor, n_kv_heads: int, head_dim: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    k = (x @ p["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, s, n_kv_heads, head_dim)
    return k, v


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                  causal: bool, window: Optional[int],
                  softcap: float) -> torch.Tensor:
    """One attention block. q: (B,C,K,G,hd); k,v: (B,T,K,hd).
    q_pos: (C,), k_pos: (T,) absolute positions. Returns (B,C,K,G,hd)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bckgh,btkh->bkgct", q, k).to(torch.float32) * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > (q_pos[:, None] - window))
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgct,btkh->bckgh", probs, v)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   n_kv_heads: int, causal: bool = True,
                   window: Optional[int] = None, softcap: float = 0.0,
                   q_offset: int = 0, q_chunk: int = 1024) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,K,hd). Chunked over queries when S >
    q_chunk: a Python loop over the chunks in place of ``lax.scan``."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    g = h // n_kv_heads
    qg = q.reshape(b, s, n_kv_heads, g, hd)
    k_pos = torch.arange(t, device=q.device)
    kw = dict(causal=causal, window=window, softcap=softcap)

    if s <= q_chunk:
        q_pos = q_offset + torch.arange(s, device=q.device)
        return _block_attend(qg, k, v, q_pos, k_pos, **kw).reshape(
            b, s, h, hd)

    if s % q_chunk != 0:  # e.g. whisper's 1500 frames: largest fitting divisor
        q_chunk = max(c for c in range(1, q_chunk + 1) if s % c == 0)
    outs = []
    for i in range(s // q_chunk):
        q_pos = q_offset + i * q_chunk + torch.arange(q_chunk,
                                                      device=q.device)
        outs.append(_block_attend(qg[:, i * q_chunk:(i + 1) * q_chunk], k, v,
                                  q_pos, k_pos, **kw))
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


def self_attention(p: Params, x: torch.Tensor, *, n_heads: int,
                   n_kv_heads: int, head_dim: int, use_rope: bool,
                   rope_theta: float, window: Optional[int] = None,
                   softcap: float = 0.0, q_chunk: int = 1024,
                   return_kv: bool = False):
    """Training / prefill self-attention. x: (B,S,d). ``return_kv`` also
    returns the (k, v) it attended to, k after RoPE: the prefill cache."""
    b, s, _ = x.shape
    q = project_q(p, x, n_heads, head_dim)
    k, v = project_kv(p, x, n_kv_heads, head_dim)
    if use_rope:
        pos = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    out = attention_core(q, k, v, n_kv_heads=n_kv_heads, causal=True,
                         window=window, softcap=softcap, q_chunk=q_chunk)
    out = out.reshape(b, s, n_heads * head_dim) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def decode_self_attention(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos: int, *, n_heads: int,
                          n_kv_heads: int, head_dim: int, use_rope: bool,
                          rope_theta: float, circular: bool = False,
                          softcap: float = 0.0):
    """One decode step. x: (B,1,d); cache_{k,v}: (B,T,K,hd); pos: the new
    token's absolute position, a Python int (so that a step makes no
    device-to-host copy).

    ``circular=True`` treats the cache as a ring buffer of size T (sliding
    window): keys are stored with RoPE already applied at their absolute
    position, so attention is order-invariant over slots. The new (k, v)
    goes to slot ``pos % T`` (circular) or ``min(pos, T - 1)`` of a copy of
    the cache. Returns (out (B,1,d), (cache_k, cache_v)).
    """
    pos = int(pos)
    b, t = x.shape[0], cache_k.shape[1]
    q = project_q(p, x, n_heads, head_dim)
    k_new, v_new = project_kv(p, x, n_kv_heads, head_dim)
    if use_rope:
        pos_arr = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos_arr, rope_theta)
        k_new = apply_rope(k_new, pos_arr, rope_theta)

    slot = pos % t if circular else min(pos, t - 1)
    cache_k, cache_v = cache_k.clone(), cache_v.clone()
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)

    slots = torch.arange(t, device=x.device)
    # slot j holds a valid key iff the ring has wrapped or j <= pos
    k_valid = (slots <= pos) | (circular and pos >= t)

    g = n_heads // n_kv_heads
    qg = q.reshape(b, 1, n_kv_heads, g, head_dim)
    scale = head_dim ** -0.5
    scores = torch.einsum("bckgh,btkh->bkgct", qg,
                          cache_k).to(torch.float32) * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(k_valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgct,btkh->bckgh", probs, cache_v)
    out = out.reshape(b, 1, n_heads * head_dim) @ p["wo"]
    return out, (cache_k, cache_v)


def cross_attention(p: Params, x: torch.Tensor, kv_k: torch.Tensor,
                    kv_v: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                    head_dim: int, q_chunk: int = 1024) -> torch.Tensor:
    """Cross-attention over precomputed k/v (vision patches / encoder
    frames). No causal mask, no RoPE (absolute context set)."""
    b, s, _ = x.shape
    q = project_q(p, x, n_heads, head_dim)
    out = attention_core(q, kv_k, kv_v, n_kv_heads=n_kv_heads, causal=False,
                         q_chunk=q_chunk)
    return out.reshape(b, s, n_heads * head_dim) @ p["wo"]


def init_kv_cache(batch: int, length: int, n_kv_heads: int, head_dim: int,
                  dtype, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (batch, length, n_kv_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
