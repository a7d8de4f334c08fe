"""Consensus and aggregation strategies (paper §I.A, §II.C-D), port of
``repro/core/aggregation.py``.

Every function takes *stacked client* parameter dicts: each leaf carries a
leading client axis ``(N, ...)``, the layout the engine's client pass
produces. The server steps (SlowMo, Adam, Yogi) take an already-aggregated
mean delta, and their hyperparameters may be float32 scalar tensors.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def _wmean(stacked: Params, weights: Optional[torch.Tensor]) -> Params:
    if weights is None:
        return {k: x.mean(dim=0) for k, x in stacked.items()}
    w = weights / weights.sum()
    return {k: (x * w.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
                ).sum(dim=0) for k, x in stacked.items()}


def average_gradients(grads: Params,
                      weights: Optional[torch.Tensor] = None) -> Params:
    """PSSGD (Alg. 1) / FedSGD: the (weighted) mean gradient."""
    return _wmean(grads, weights)


def fedavg(client_models: Params,
           participation: Optional[torch.Tensor] = None) -> Params:
    """FedAvg (Alg. 7): mean over the participating clients only (eq. 36);
    ``participation`` is an (N,) 0/1 mask."""
    return _wmean(client_models, participation)


def signsgd_majority_vote(sign_grads: Params) -> Params:
    """SignSGD with majority vote (Alg. 5): ``sign(sum_n sign(g_n))``."""
    return {k: torch.sign(torch.sign(s).sum(dim=0))
            for k, s in sign_grads.items()}


# ---------------------------------------------------------------------------
# SlowMo (Alg. 8): server momentum over the pseudo-gradient
# ---------------------------------------------------------------------------
class SlowMoState(NamedTuple):
    momentum: Params


def init_slowmo(params: Params) -> SlowMoState:
    return SlowMoState({k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()})


def slowmo_step(params: Params, mean_delta: Params, state: SlowMoState, *,
                inner_lr, alpha=1.0, beta=0.5) -> Tuple[Params, SlowMoState]:
    """``m <- beta m + g`` with the pseudo-gradient ``g = -mean_delta /
    inner_lr``, then ``theta <- theta - alpha inner_lr m`` (Alg. 8 lines
    13-16)."""
    m = {k: beta * state.momentum[k]
         + (-mean_delta[k].to(torch.float32) / inner_lr) for k in params}
    new_params = {k: (p.to(torch.float32) - alpha * inner_lr * m[k])
                  .to(p.dtype) for k, p in params.items()}
    return new_params, SlowMoState(m)


def slowmo(params: Params, client_deltas: Params, state: SlowMoState, *,
           inner_lr: float, alpha: float = 1.0, beta: float = 0.5,
           participation: Optional[torch.Tensor] = None
           ) -> Tuple[Params, SlowMoState]:
    """Stacked-client form of :func:`slowmo_step`."""
    return slowmo_step(params, _wmean(client_deltas, participation), state,
                       inner_lr=inner_lr, alpha=alpha, beta=beta)


# ---------------------------------------------------------------------------
# Adaptive server optimizers (FedAdam / FedYogi, Reddi et al. [56])
# ---------------------------------------------------------------------------
class ServerOptState(NamedTuple):
    m: Params
    v: Params
    step: torch.Tensor  # int32 scalar


def init_server_opt(params: Params) -> ServerOptState:
    dev = next(iter(params.values())).device
    return ServerOptState(
        {k: torch.zeros_like(p, dtype=torch.float32)
         for k, p in params.items()},
        {k: torch.zeros_like(p, dtype=torch.float32)
         for k, p in params.items()},
        torch.zeros((), dtype=torch.int32, device=dev))


def fedadam_step(params: Params, mean_delta: Params, state: ServerOptState,
                 *, server_lr=1e-2, beta1=0.9, beta2=0.99, eps=1e-3,
                 yogi: bool = False) -> Tuple[Params, ServerOptState]:
    """Server Adam (or Yogi) on the pseudo-gradient ``-mean_delta``."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1 - beta1 ** t
    bc2 = 1 - beta2 ** t
    m, v, new_params = {}, {}, {}
    for k, p in params.items():
        g = -mean_delta[k].to(torch.float32)
        m[k] = beta1 * state.m[k] + (1 - beta1) * g
        if yogi:
            v[k] = state.v[k] - (1 - beta2) * torch.sign(
                state.v[k] - g * g) * g * g
        else:
            v[k] = beta2 * state.v[k] + (1 - beta2) * g * g
        new_params[k] = (p.to(torch.float32) - server_lr * (m[k] / bc1)
                         / (torch.sqrt(v[k] / bc2) + eps)).to(p.dtype)
    return new_params, ServerOptState(m, v, step)


def fedadam(params: Params, client_deltas: Params, state: ServerOptState, *,
            server_lr: float = 1e-2, beta1: float = 0.9, beta2: float = 0.99,
            eps: float = 1e-3, participation: Optional[torch.Tensor] = None,
            yogi: bool = False) -> Tuple[Params, ServerOptState]:
    """Stacked-client form of :func:`fedadam_step`."""
    return fedadam_step(params, _wmean(client_deltas, participation), state,
                        server_lr=server_lr, beta1=beta1, beta2=beta2,
                        eps=eps, yogi=yogi)
