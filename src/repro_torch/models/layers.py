"""Shared layer primitives: norms, RoPE, MLPs, embeddings, inits. Port of
``repro/models/layers.py``.

Conventions
-----------
* Init functions take a threefry key (``repro_torch.random``, the
  reference's generator bit for bit) and return a nested dict of tensors on
  the key's device, drawing what the reference draws from the same keys in
  the same order. Layer stacks have a leading layer axis: ``stacked_init``
  splits the key ``n`` ways and writes each layer's draw into the stack, one
  leaf at a time, where the reference ``vmap``s the per-layer init.
* Apply functions take the same nested dicts; model matmuls are plain ``@``
  in the parameters' dtype, norms and RoPE compute in float32.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch.core.wireless import _cos_sin
from repro_torch.models import tp, xla_math

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name -> the torch dtype."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(key, d: int, norm_type: str, dtype) -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=key.device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=key.device)
    return p


def apply_norm(p: Params, x: torch.Tensor, norm_type: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def rope_frequencies(head_dim: int, theta: float, device=None,
                     folded: bool = False) -> torch.Tensor:
    """The (head_dim / 2,) inverse frequencies, made once per head_dim,
    theta and device (a decode step would otherwise copy theta to the card
    and wait for it twice a layer); callers only read it. As the
    reference's op-by-op program and its compiled train and prefill steps
    compute them (a float32 pow, then a division); ``folded``: as its
    compiled decode step folds them, ``theta ** -e`` rounded once from
    float64 (the two are up to an ulp apart, and an angle's difference
    grows with the position)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    if folded:      # on the host: its float64 pow is correctly rounded
        theta64 = torch.tensor(theta, dtype=torch.float32).double()
        return (1.0 / theta64 ** exps.cpu().double()).float().to(device)
    return 1.0 / (torch.tensor(theta, dtype=torch.float32,
                               device=device) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, folded: bool = False) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers;
    ``folded``: the decode step's frequencies (``rope_frequencies``)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device,
                             folded)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / gated MLPs
# ---------------------------------------------------------------------------
def init_mlp(key, d: int, d_ff: int, mlp_type: str, dtype) -> Params:
    k1, k2, k3 = trandom.split(key, 3)
    if mlp_type in ("swiglu", "geglu"):
        return {"w_gate": dense_init(k1, (d, d_ff), dtype),
                "w_up": dense_init(k2, (d, d_ff), dtype),
                "w_down": dense_init(k3, (d_ff, d), dtype)}
    return {"w_up": dense_init(k1, (d, d_ff), dtype),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=key.device),
            "w_down": dense_init(k2, (d_ff, d), dtype),
            "b_down": torch.zeros((d,), dtype=dtype, device=key.device)}


def _gelu(v: torch.Tensor) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")


def apply_mlp(p: Params, x: torch.Tensor, mlp_type: str,
              d_ff: int | None = None) -> torch.Tensor:
    """The MLP of ``p``; where ``p`` holds this member's block of the
    ``d_ff`` hidden units (``w_gate`` / ``w_up`` / ``b_up`` by column,
    ``w_down`` by row: ``models/tp.py``), the members' partial outputs are
    summed over ``model`` and ``b_down``, whole, is added once after."""
    split = d_ff is not None and p["w_down"].shape[-2] != d_ff
    if split:
        x = tp.copy_to(x)
    if mlp_type in ("swiglu", "geglu"):
        act = F.silu if mlp_type == "swiglu" else _gelu
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
        out = h @ p["w_down"]
        return tp.sum_over(out) if split else out
    h = _gelu(x @ p["w_up"] + p["b_up"])
    out = h @ p["w_down"]
    return (tp.sum_over(out) if split else out) + p["b_down"]


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------
def init_embedding(key, vocab: int, d: int, dtype) -> torch.Tensor:
    return dense_init(key, (vocab, d), dtype, scale=d ** -0.5)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 scale_by_dim: bool = False,
                 vocab: int | None = None) -> torch.Tensor:
    """The rows of ``tokens``; where ``table`` holds this member's block of
    the ``vocab`` rows, each member looks up the tokens in its block (zeros
    elsewhere) and the rows are summed over ``model``."""
    if vocab is not None and table.shape[0] != vocab:
        rows = table.shape[0]
        local = tokens.long() - tp.index() * rows
        mine = (local >= 0) & (local < rows)
        out = table[local.clamp(0, rows - 1)]
        out = tp.sum_over(torch.where(mine[..., None], out,
                                      out.new_zeros(())))
    else:
        out = table[tokens.long()]
    if scale_by_dim:  # gemma-style embedding scaling, in the table's dtype
        out = out * torch.tensor(out.shape[-1] ** 0.5, dtype=out.dtype,
                                 device=out.device)
    return out


def sinusoidal_positions(n_pos: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal table (float32), bitwise the reference's
    CPU table: XLA's ``log`` and ``exp``, a true division, and the C
    library's ``sinf`` / ``cosf``."""
    half = d // 2
    log_base = xla_math.log(torch.tensor(10_000.0, device=device))
    freq = xla_math.exp(-log_base * torch.arange(
        half, dtype=torch.float32, device=device) / (half - 1))
    args = torch.arange(n_pos, dtype=torch.float32,
                        device=device)[:, None] * freq[None, :]
    cos, sin = _cos_sin(args)
    return torch.cat([sin, cos], dim=-1)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------
def _stack_into(out, tree, i: int, n: int):
    """Write ``tree`` (a nested dict of tensors) as layer ``i`` of the
    stacked ``out`` (allocated at ``i == 0``); returns ``out``."""
    if isinstance(tree, dict):
        out = {} if out is None else out
        for k, v in tree.items():
            out[k] = _stack_into(out.get(k), v, i, n)
        return out
    if out is None:
        out = torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype,
                          device=tree.device)
    out[i] = tree
    return out


def stacked_init(init_fn: Callable, key, n: int):
    """``init_fn`` over ``n`` split keys -> a leading stack dim. Layer by
    layer into the stack, so one layer's draws are alive at a time."""
    keys = trandom.split(key, n)
    out = None
    for i in range(n):
        out = _stack_into(out, init_fn(keys[i]), i, n)
    return out


def dense_init(key, shape, dtype, scale: float | None = None):
    scale = shape[0] ** -0.5 if scale is None else scale
    return (trandom.normal(key, shape) * scale).to(dtype)
