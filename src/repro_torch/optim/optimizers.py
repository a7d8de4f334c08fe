"""SGD, momentum SGD and AdamW on the port's flat ``/``-keyed param dicts,
the port of ``repro/optim/optimizers.py``.

Every update upcasts to float32 and casts back to the param's (or the
moment's) dtype, so the moments may be kept in bf16 (``state_dtype``).
``OptState.step`` is an int32 scalar counting updates (the local-SGD step
advances it once per micro-step). The updates are pure: they return new
dicts and leave their arguments as they were.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

Params = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor
    m: Optional[Params]  # first moment / velocity (None for plain sgd)
    v: Optional[Params]  # second moment (adam only)


def _dtype(d) -> torch.dtype:
    return getattr(torch, d) if isinstance(d, str) else d


def init_opt_state(params: Params, kind: str = "adamw",
                   state_dtype=torch.float32) -> OptState:
    sdtype = _dtype(state_dtype)

    def zeros():
        return {k: torch.zeros(p.shape, dtype=sdtype, device=p.device)
                for k, p in params.items()}
    device = next(iter(params.values())).device if params else None
    step = torch.zeros((), dtype=torch.int32, device=device)
    if kind == "sgd":
        return OptState(step, None, None)
    if kind == "momentum":
        return OptState(step, zeros(), None)
    if kind == "adamw":
        return OptState(step, zeros(), zeros())
    raise ValueError(kind)


def sgd(params: Params, grads: Params, state: OptState, lr
        ) -> tuple[Params, OptState]:
    new = {k: (p.float() - lr * grads[k].float()).to(p.dtype)
           for k, p in params.items()}
    return new, OptState(state.step + 1, None, None)


def momentum_sgd(params: Params, grads: Params, state: OptState, lr,
                 beta: float = 0.9) -> tuple[Params, OptState]:
    m = {k: (beta * m0.float() + grads[k].float()).to(m0.dtype)
         for k, m0 in state.m.items()}
    new = {k: (p.float() - lr * m[k].float()).to(p.dtype)
           for k, p in params.items()}
    return new, OptState(state.step + 1, m, None)


def adamw(params: Params, grads: Params, state: OptState, lr,
          beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> tuple[Params, OptState]:
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - beta1 ** t
    bc2 = 1.0 - beta2 ** t
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        gf = grads[k].float()
        m0, v0 = state.m[k], state.v[k]
        m = beta1 * m0.float() + (1 - beta1) * gf
        v = beta2 * v0.float() + (1 - beta2) * gf * gf
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        pf = p.float()
        pf = pf - lr * (u + weight_decay * pf)
        new_p[k], new_m[k], new_v[k] = (pf.to(p.dtype), m.to(m0.dtype),
                                        v.to(v0.dtype))
    return new_p, OptState(step, new_m, new_v)


def apply_updates(kind: str):
    return {"sgd": sgd, "momentum": momentum_sgd, "adamw": adamw}[kind]
