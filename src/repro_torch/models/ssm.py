"""Mamba-1 selective SSM block (falcon-mamba-7b): the training forward.
Port of ``repro/models/ssm.py``.

State-space recurrence (per channel c, state n):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = <C_t, h_t> + D * x_t
with input-dependent (selective) dt, B, C. The prefill state and the
one-token decode step serve inference and are not ported here.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch.configs.base import ModelConfig
from repro_torch.models import xla_math
from repro_torch.models.layers import dense_init
from repro_torch.models.scan_utils import (causal_depthwise_conv,
                                           chunked_linear_recurrence)

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


def _selective_terms(p: Params, xc: torch.Tensor, cfg: ModelConfig):
    """Input-dependent dt/B/C from the conv'd activation xc (B,S,di),
    float32 (the weights promoted to it, as the reference promotes)."""
    n, dtr = cfg.ssm_state, cfg.dt_rank_eff
    proj = xc @ p["x_proj"].to(xc.dtype)  # (B,S,dtr+2n)
    dt_in, b_in, c_in = torch.split(proj, [dtr, n, n], dim=-1)
    dt = softplus(dt_in @ p["dt_proj"].to(xc.dtype)
                  + p["dt_bias"].to(torch.float32))  # (B,S,di)
    a = -torch.exp(p["A_log"].to(torch.float32))  # (di,n)
    a_bar = torch.exp(dt[..., None] * a)  # (B,S,di,n)
    bx = (dt * xc)[..., None] * b_in[..., None, :]  # (B,S,di,n)
    return a_bar, bx, c_in


def mamba_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  chunk: int = 256) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d), from a zero state."""
    bsz = x.shape[0]
    xz = x @ p["in_proj"]
    x_ssm, z = xz.chunk(2, dim=-1)
    xc = causal_depthwise_conv(x_ssm, p["conv_w"], p["conv_b"])
    xc = F.silu(xc).to(torch.float32)
    a_bar, bx, c_in = _selective_terms(p, xc, cfg)
    h0 = torch.zeros((bsz, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                     device=x.device)
    h_all, _ = chunked_linear_recurrence(a_bar, bx, h0, chunk=chunk)
    y = torch.einsum("bsdn,bsn->bsd", h_all, c_in.to(torch.float32))
    y = y + p["D"].to(torch.float32) * xc
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    return y @ p["out_proj"]
