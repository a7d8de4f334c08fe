"""Attention: GQA/MQA self-attention (full, sliding window,
query-chunked), decode with KV caches (linear or circular sliding-window),
and cross-attention. Port of ``repro/models/attention.py``.

Written with matmuls (``einsum``) and ``softmax`` as the reference writes it,
so that the port computes what the reference computes, under ``torch.func``
too; no fused attention. Long sequences are computed in query chunks, so
the live score buffer is O(q_chunk * seq), not O(seq^2).

Over a mesh's ``model`` axis (``models/tp.py``) a member holds its block
of the q heads where ``n_heads`` splits (``wq`` by column, ``wo`` by row)
and of the kv heads where ``n_kv_heads`` does (``wk`` / ``wv`` and the
caches); every count of heads is read off the member's blocks. The input
enters at ``enter`` and ``wo``'s partial outputs are summed over
``model``. Global q head i attends with kv head ``i // (n_heads //
n_kv_heads)``: where the q heads split and the kv heads do not, each
member takes the kv heads of its own q heads (``local_kv``), whole groups
or, where its q heads cut a group, one kv head a q head; and the whole
``wk`` / ``wv`` enter through ``tp.copy_to``, since their gradient on a
member comes from its q heads only. Where the cache rule puts ``model`` on
a decode cache's positions (``launch/sharding.py::cache_shardings``: the
kv heads do not divide and T equals a split feature width), a member holds
its block of the positions and attends over it for every q head, the
softmax reduced over ``model`` (``_attend_block``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import random as trandom
from repro_torch.models import tp
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


def split_q(p: Params, n_heads: int, head_dim: int) -> bool:
    """Whether ``p`` holds this member's block of the q heads."""
    return p["wq"].shape[-1] != n_heads * head_dim


def enter(p: Params, x: torch.Tensor, n_heads: int,
          head_dim: int) -> torch.Tensor:
    """``x`` entering the attention of ``p``: ``tp.copy_to`` where the q
    heads split, else as it is."""
    return tp.copy_to(x) if split_q(p, n_heads, head_dim) else x


def project_q(p: Params, x: torch.Tensor, n_heads: int,
              head_dim: int) -> torch.Tensor:
    """(B, S, heads, hd): this member's q heads (``n_heads`` is the
    config's; the member's count is ``wq``'s)."""
    b, s, _ = x.shape
    return (x @ p["wq"]).reshape(b, s, p["wq"].shape[-1] // head_dim,
                                 head_dim)


def project_kv(p: Params, x: torch.Tensor, n_kv_heads: int, head_dim: int,
               n_heads: int | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This member's k and v heads (all of them where they do not split;
    ``wk`` / ``wv`` then enter through ``tp.copy_to`` where the q heads,
    given by ``n_heads``, split)."""
    b, s, _ = x.shape
    wk, wv = p["wk"], p["wv"]
    hk = wk.shape[-1] // head_dim
    if (n_heads is not None and hk == n_kv_heads
            and split_q(p, n_heads, head_dim)):
        wk, wv = tp.copy_to(wk), tp.copy_to(wv)
    k = (x @ wk).reshape(b, s, hk, head_dim)
    v = (x @ wv).reshape(b, s, hk, head_dim)
    return k, v


def local_kv(k: torch.Tensor, v: torch.Tensor, hq: int, n_heads: int,
             n_kv_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kv heads (dim 2 of k, v: (B, T, K, hd)) that this member's
    ``hq`` q heads attend with: k and v as they are where the q heads are
    whole or the kv heads split with them; else the kv heads of its global
    q heads, as whole groups where every kv head serves the same number of
    them, else one kv head a q head."""
    if hq == n_heads or k.shape[2] != n_kv_heads:
        return k, v
    g = n_heads // n_kv_heads
    first = tp.index() * hq
    ids = [(first + j) // g for j in range(hq)]
    lo, hi = ids[0], ids[-1] + 1
    if all(ids.count(i) * (hi - lo) == hq for i in range(lo, hi)):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.tensor(ids, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def project_out(p: Params, out: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, heads, hd) -> (B, S, d) through ``wo``; the members' partial
    outputs summed over ``model`` where they hold a block of the heads."""
    b, s, h, hd = out.shape
    y = out.reshape(b, s, h * hd) @ p["wo"]
    return tp.sum_over(y) if h != n_heads else y


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
    x = enter(p, x, n_heads, head_dim)
    q = project_q(p, x, n_heads, head_dim)
    k, v = project_kv(p, x, n_kv_heads, head_dim, n_heads)
    if use_rope:
        pos = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    ka, va = local_kv(k, v, q.shape[2], n_heads, n_kv_heads)
    out = attention_core(q, ka, va, n_kv_heads=ka.shape[2], causal=True,
                         window=window, softcap=softcap, q_chunk=q_chunk)
    out = project_out(p, out, n_heads)
    if return_kv:
        return out, (k, v)
    return out


def decode_self_attention(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos: int, *, n_heads: int,
                          n_kv_heads: int, head_dim: int, use_rope: bool,
                          rope_theta: float, circular: bool = False,
                          softcap: float = 0.0,
                          cache_len: Optional[int] = None):
    """One decode step. x: (B,1,d); cache_{k,v}: (B,T,K,hd); pos: the new
    token's absolute position, a Python int (so that a step makes no
    device-to-host copy).

    ``circular=True`` treats the cache as a ring buffer of size T (sliding
    window): keys are stored with RoPE already applied at their absolute
    position, so attention is order-invariant over slots. The new (k, v)
    goes to slot ``pos % T`` (circular) or ``min(pos, T - 1)`` of a copy of
    the cache. Returns (out (B,1,d), (cache_k, cache_v)).

    ``cache_len``: the whole cache's T where it is longer than this
    member's: the member holds positions ``[r T / m, (r + 1) T / m)`` of
    it (``_attend_block``); None or the member's T: the whole cache.
    """
    pos = int(pos)
    b, t = x.shape[0], cache_k.shape[1]
    total = t if cache_len is None else int(cache_len)
    if total != t and t * tp.n() != total:
        raise ValueError(f"a block of {t} positions of a cache of {total} "
                         f"over {tp.n()} members")
    lo = tp.index() * t if total != t else 0
    x = enter(p, x, n_heads, head_dim)
    q = project_q(p, x, n_heads, head_dim)
    k_new, v_new = project_kv(p, x, n_kv_heads, head_dim, n_heads)
    if use_rope:    # the frequencies the reference's decode step folds
        pos_arr = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos_arr, rope_theta, folded=True)
        k_new = apply_rope(k_new, pos_arr, rope_theta, folded=True)

    slot = pos % total if circular else min(pos, total - 1)
    cache_k, cache_v = cache_k.clone(), cache_v.clone()
    if lo <= slot < lo + t:     # the member whose block holds the slot
        cache_k[:, slot - lo] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, slot - lo] = v_new[:, 0].to(cache_v.dtype)

    slots = lo + torch.arange(t, device=x.device)
    # slot j holds a valid key iff the ring has wrapped or j <= pos
    k_valid = (slots <= pos) | (circular and pos >= total)

    hq = q.shape[2]
    if total != t:
        out = _attend_block(q, cache_k, cache_v, k_valid, n_heads, softcap)
        return project_out(p, out, n_heads), (cache_k, cache_v)
    ka, va = local_kv(cache_k, cache_v, hq, n_heads, n_kv_heads)
    hk = ka.shape[2]
    qg = q.reshape(b, 1, hk, hq // hk, head_dim)
    scale = head_dim ** -0.5
    scores = torch.einsum("bckgh,btkh->bkgct", qg,
                          ka).to(torch.float32) * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(k_valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(va.dtype)
    out = torch.einsum("bkgct,btkh->bckgh", probs, va)
    out = project_out(p, out.reshape(b, 1, hq, head_dim), n_heads)
    return out, (cache_k, cache_v)


def _attend_block(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  k_valid: torch.Tensor, n_heads: int,
                  softcap: float) -> torch.Tensor:
    """Decode attention over this member's block of a cache's positions
    (ck, cv: (B, T/m, K, hd), every kv head; k_valid: (T/m,)) for its q
    heads q: (B, 1, hq, hd). Every member scores all ``n_heads`` q heads
    (q gathered over ``model`` where it holds a block of them) against its
    positions; the softmax's shift is the max over ``model`` of the
    members' maxima, its sum of exps and the partial ``probs @ V``
    (float32) are summed over ``model``, as ``transformer._split_lse_gold``
    reduces the cross-entropy. A member whose positions are all past
    ``pos`` adds exact zeros: exp(NEG_INF - shift) is 0. Returns this
    member's q heads' rows, (B, 1, hq, hd)."""
    b, _, hq, hd = q.shape
    if hq != n_heads:
        q = tp.gather_from(q.reshape(b, 1, hq * hd)).reshape(b, 1, n_heads,
                                                              hd)
    k = ck.shape[2]
    qg = q.reshape(b, 1, k, n_heads // k, hd)
    scores = torch.einsum("bckgh,btkh->bkgct", qg,
                          ck).to(torch.float32) * hd ** -0.5
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(k_valid, scores, NEG_INF)
    shift = tp.max_over(scores.amax(dim=-1, keepdim=True))
    exps = torch.exp(scores - shift)
    probs = (exps / tp.sum_over(exps.sum(dim=-1, keepdim=True))).to(cv.dtype)
    out = tp.sum_over(torch.einsum("bkgct,btkh->bckgh",
                                   probs.to(torch.float32),
                                   cv.to(torch.float32))).to(cv.dtype)
    out = out.reshape(b, 1, n_heads, hd)
    if hq != n_heads:
        out = out[:, :, tp.index() * hq:(tp.index() + 1) * hq]
    return out


def cross_attention(p: Params, x: torch.Tensor, kv_k: torch.Tensor,
                    kv_v: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                    head_dim: int, q_chunk: int = 1024) -> torch.Tensor:
    """Cross-attention over precomputed k/v (vision patches / encoder
    frames; this member's kv heads, ``project_kv``). No causal mask, no
    RoPE (absolute context set)."""
    q = project_q(p, enter(p, x, n_heads, head_dim), n_heads, head_dim)
    ka, va = local_kv(kv_k, kv_v, q.shape[2], n_heads, n_kv_heads)
    out = attention_core(q, ka, va, n_kv_heads=ka.shape[2], causal=False,
                         q_chunk=q_chunk)
    return project_out(p, out, n_heads)


def init_kv_cache(batch: int, length: int, n_kv_heads: int, head_dim: int,
                  dtype, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (batch, length, n_kv_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
