"""Mamba-1 selective SSM block (falcon-mamba-7b): the training forward.
Port of ``repro/models/ssm.py``.

State-space recurrence (per channel c, state n):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = <C_t, h_t> + D * x_t
with input-dependent (selective) dt, B, C. ``mamba_forward`` also takes an
incoming state and returns the final one (prefill), and
``mamba_decode_step`` advances the state by one token (decode).

Over a mesh's ``model`` axis (``models/tp.py``) a member may hold its block
of the ``d_inner`` channels (``split``): its columns of each half of
``in_proj`` (``x``'s, then ``z``'s: ``launch/sharding.py::HALVES``), of
``dt_proj``, the conv and the per-channel leaves, its rows of ``x_proj``
and ``out_proj``. The block enters at ``tp.copy_to``; ``x_proj``'s partial
product ``proj``, which every channel reads, is summed over ``model`` and
enters the block again (its cotangent, partial on each member, summed);
``out_proj``'s partial outputs are summed. The scan, the conv and the
states run on the member's channels as they are.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch.configs.base import ModelConfig
from repro_torch.models import tp, xla_math
from repro_torch.models.layers import dense_init
from repro_torch.models.scan_utils import (causal_depthwise_conv,
                                           chunked_linear_recurrence,
                                           conv_step)

Params = Dict[str, torch.Tensor]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    past its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba_block(key, cfg: ModelConfig, dtype) -> Params:
    d, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_eff
    dev = key.device
    keys = trandom.split(key, 6)
    # S4D-real initialization for A, its log as the reference's CPU takes it
    a_log = xla_math.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=dev))
    return {
        "in_proj": dense_init(keys[0], (d, 2 * di), dtype),
        "conv_w": dense_init(keys[1], (cfg.d_conv, di), dtype,
                             scale=cfg.d_conv ** -0.5),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(keys[2], (di, dtr + 2 * n), dtype),
        "dt_proj": dense_init(keys[3], (dtr, di), dtype, scale=dtr ** -0.5),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=dev),
        "A_log": a_log[None, :].expand(di, n).to(dtype).contiguous(),
        "D": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(keys[4], (di, d), dtype),
    }


def split(p: Params, cfg: ModelConfig) -> bool:
    """Whether ``p`` holds this member's block of the ``d_inner``
    channels."""
    return p["in_proj"].shape[-1] != 2 * cfg.d_inner


def _project(p: Params, xc: torch.Tensor, split_: bool) -> torch.Tensor:
    """``xc @ x_proj`` (dt_rank + 2n wide): on a block of the channels, the
    members' partial products summed over ``model``, entering the block
    again through ``tp.copy_to``."""
    proj = xc @ p["x_proj"].to(xc.dtype)
    return tp.copy_to(tp.sum_over(proj)) if split_ else proj


def _selective_terms(p: Params, xc: torch.Tensor, cfg: ModelConfig,
                     split_: bool = False):
    """Input-dependent dt/B/C from the conv'd activation xc (B,S,di),
    float32 (the weights promoted to it, as the reference promotes)."""
    n, dtr = cfg.ssm_state, cfg.dt_rank_eff
    proj = _project(p, xc, split_)  # (B,S,dtr+2n)
    dt_in, b_in, c_in = torch.split(proj, [dtr, n, n], dim=-1)
    dt = softplus(dt_in @ p["dt_proj"].to(xc.dtype)
                  + p["dt_bias"].to(torch.float32))  # (B,S,di)
    a = -torch.exp(p["A_log"].to(torch.float32))  # (di,n)
    a_bar = torch.exp(dt[..., None] * a)  # (B,S,di,n)
    bx = (dt * xc)[..., None] * b_in[..., None, :]  # (B,S,di,n)
    return a_bar, bx, c_in


def mamba_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  chunk: int = 256, state: Optional[Tuple] = None,
                  return_state: bool = False):
    """x: (B,S,d) -> (B,S,d). ``state`` = (conv_state, ssm_state): the
    recurrence starts from its ``ssm_state`` (the conv starts from zeros, as
    the reference's does); ``return_state`` also returns the final state,
    the conv's last ``d_conv - 1`` inputs and h."""
    bsz = x.shape[0]
    split_ = split(p, cfg)
    if split_:
        x = tp.copy_to(x)
    xz = x @ p["in_proj"]
    x_ssm, z = xz.chunk(2, dim=-1)
    xc = causal_depthwise_conv(x_ssm, p["conv_w"], p["conv_b"])
    xc = F.silu(xc).to(torch.float32)
    a_bar, bx, c_in = _selective_terms(p, xc, cfg, split_)
    h0 = (state[1] if state is not None else
          torch.zeros((bsz, x_ssm.shape[-1], cfg.ssm_state),
                      dtype=torch.float32, device=x.device))
    h_all, h_last = chunked_linear_recurrence(a_bar, bx, h0, chunk=chunk)
    y = torch.einsum("bsdn,bsn->bsd", h_all, c_in.to(torch.float32))
    y = y + p["D"].to(torch.float32) * xc
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    out = y @ p["out_proj"]
    if split_:
        out = tp.sum_over(out)
    if return_state:
        return out, (x_ssm[:, -(cfg.d_conv - 1):, :], h_last)
    return out


def mamba_decode_step(p: Params, x: torch.Tensor, state: Tuple,
                      cfg: ModelConfig):
    """x: (B,1,d); state = (conv_state (B,K-1,di), ssm_state (B,di,n)).
    Returns (out (B,1,d), new state). One token's ``a_bar`` and ``bx`` in
    the reference's order of operations (not through ``_selective_terms``)."""
    conv_state, h = state
    n, dtr = cfg.ssm_state, cfg.dt_rank_eff
    split_ = split(p, cfg)
    if split_:
        x = tp.copy_to(x)
    xz = x[:, 0] @ p["in_proj"]
    x_ssm, z = xz.chunk(2, dim=-1)  # (B,di)
    conv_state, xc = conv_step(conv_state.to(x_ssm.dtype), x_ssm,
                               p["conv_w"], p["conv_b"])
    xc = F.silu(xc).to(torch.float32)  # (B,di)
    proj = _project(p, xc, split_)
    dt_in, b_in, c_in = torch.split(proj, [dtr, n, n], dim=-1)
    dt = softplus(dt_in @ p["dt_proj"].to(xc.dtype)
                  + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["A_log"].to(torch.float32))
    a_bar = torch.exp(dt[..., None] * a)  # (B,di,n)
    bx = (dt * xc)[..., None] * b_in[:, None, :]  # (B,di,n)
    h = a_bar * h + bx
    y = torch.einsum("bdn,bn->bd", h, c_in) + p["D"].to(torch.float32) * xc
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    out = y @ p["out_proj"]
    if split_:
        out = tp.sum_over(out)
    return out[:, None, :], (conv_state, h)


def init_mamba_state(batch: int, cfg: ModelConfig, dtype, device=None
                     ) -> Tuple:
    conv_state = torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                             dtype=dtype, device=device)
    ssm_state = torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                            dtype=torch.float32, device=device)
    return conv_state, ssm_state
