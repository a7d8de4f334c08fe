"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): the
training forward. Port of ``repro/models/rglru.py``.

Recurrent block: x -> {linear -> conv1d -> RG-LRU} * {linear -> GeLU} -> linear.
RG-LRU:
    r_t = sigmoid(x_t W_a + b_a)              (recurrence gate)
    i_t = sigmoid(x_t W_x + b_x)              (input gate)
    log a_t = -c * softplus(Lambda) * r_t     (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
Computed with the shared chunked scan. ``rglru_forward`` also takes an
incoming state and returns the final one (prefill), and
``rglru_decode_step`` advances the state by one token (decode).

Over a mesh's ``model`` axis (``models/tp.py``) a member may hold its block
of the ``lru_width`` channels (``split``): its columns of ``in_x``,
``in_gate``, ``w_a`` and ``w_i``, its channels of the conv, ``b_a``,
``b_i`` and ``Lambda``, its rows of ``out_proj``. The block enters at
``tp.copy_to``; the gates' products need every channel of ``xc``, which
``tp.gather_from`` joins once for both; ``out_proj``'s partial outputs are
summed over ``model``.
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
from repro_torch.models.ssm import softplus

Params = Dict[str, torch.Tensor]

RGLRU_C = 8.0


def init_rglru_block(key, cfg: ModelConfig, dtype) -> Params:
    d, w = cfg.d_model, cfg.lru_width
    dev = key.device
    keys = trandom.split(key, 7)
    # Lambda init so that a ~ Uniform(0.9, 0.999)^c at r=1, in the
    # reference's CPU arithmetic
    lam = xla_math.log(xla_math.expm1(
        -xla_math.log(xla_math.linspace(0.9, 0.999, w, device=dev))
        / RGLRU_C))
    return {
        "in_x": dense_init(keys[0], (d, w), dtype),
        "in_gate": dense_init(keys[1], (d, w), dtype),
        "conv_w": dense_init(keys[2], (cfg.d_conv, w), dtype,
                             scale=cfg.d_conv ** -0.5),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "w_a": dense_init(keys[3], (w, w), dtype),
        "b_a": torch.zeros((w,), dtype=dtype, device=dev),
        "w_i": dense_init(keys[4], (w, w), dtype),
        "b_i": torch.zeros((w,), dtype=dtype, device=dev),
        "Lambda": lam.to(dtype),
        "out_proj": dense_init(keys[5], (w, d), dtype),
    }


def split(p: Params, cfg: ModelConfig) -> bool:
    """Whether ``p`` holds this member's block of the ``lru_width``
    channels."""
    return p["in_x"].shape[-1] != cfg.lru_width


def _gates(p: Params, xc: torch.Tensor, split_: bool = False):
    """(a, its input term) on ``xc``'s channels; the gates' products read
    every channel (``xc`` gathered whole over ``model`` where split)."""
    xw = tp.gather_from(xc) if split_ else xc
    r = torch.sigmoid((xw @ p["w_a"] + p["b_a"]).to(torch.float32))
    i = torch.sigmoid((xw @ p["w_i"] + p["b_i"]).to(torch.float32))
    log_a = -RGLRU_C * softplus(p["Lambda"].to(torch.float32)) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * i * xc.to(torch.float32)


def rglru_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  chunk: int = 256, state: Optional[Tuple] = None,
                  return_state: bool = False):
    """x: (B,S,d) -> (B,S,d). ``state`` = (conv_state, h): the recurrence
    starts from its h (the conv from zeros, as the reference's does);
    ``return_state`` also returns the final state, the conv's last
    ``d_conv - 1`` inputs and h."""
    split_ = split(p, cfg)
    if split_:
        x = tp.copy_to(x)
    gate = F.gelu((x @ p["in_gate"]).to(torch.float32), approximate="tanh")
    xb = x @ p["in_x"]
    xc = causal_depthwise_conv(xb, p["conv_w"], p["conv_b"])
    a, b = _gates(p, xc, split_)
    h0 = (state[1] if state is not None else
          torch.zeros((x.shape[0], xb.shape[-1]), dtype=torch.float32,
                      device=x.device))
    h_all, h_last = chunked_linear_recurrence(a, b, h0, chunk=chunk)
    y = (h_all * gate).to(x.dtype)
    out = y @ p["out_proj"]
    if split_:
        out = tp.sum_over(out)
    if return_state:
        return out, (xb[:, -(cfg.d_conv - 1):, :], h_last)
    return out


def rglru_decode_step(p: Params, x: torch.Tensor, state: Tuple,
                      cfg: ModelConfig):
    """x: (B,1,d); state = (conv_state (B,K-1,w), h (B,w)). Returns
    (out (B,1,d), new state)."""
    conv_state, h = state
    split_ = split(p, cfg)
    x0 = tp.copy_to(x[:, 0]) if split_ else x[:, 0]
    gate = F.gelu((x0 @ p["in_gate"]).to(torch.float32), approximate="tanh")
    xb = x0 @ p["in_x"]
    conv_state, xc = conv_step(conv_state.to(xb.dtype), xb, p["conv_w"],
                               p["conv_b"])
    a, b = _gates(p, xc, split_)
    h = a * h + b
    y = (h * gate).to(x.dtype)
    out = y @ p["out_proj"]
    if split_:
        out = tp.sum_over(out)
    return out[:, None, :], (conv_state, h)


def init_rglru_state(batch: int, cfg: ModelConfig, dtype, device=None
                     ) -> Tuple:
    conv_state = torch.zeros((batch, cfg.d_conv - 1, cfg.lru_width),
                             dtype=dtype, device=device)
    h = torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                    device=device)
    return conv_state, h
