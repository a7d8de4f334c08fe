"""Client-side local computation (paper §II.C, Alg. 6/7 device side), port
of ``repro/fl/client.py``.

``local_sgd`` is the reference client update: H local SGD steps through
``core.algorithms.registry.sgd_steps``, the same loop every registry
algorithm builds its client update from. Model-agnostic: works with any
``loss_fn(params, batch) -> (loss, metrics)`` over dicts of tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.algorithms.registry import sgd_steps

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Any]]


def local_sgd(loss_fn: LossFn, params: Params, batches: Dict[str, torch.Tensor],
              lr, momentum=0.0) -> Tuple[Params, Params, torch.Tensor]:
    """H local steps (eqs. 32-35). ``batches`` leaves have leading dim H.

    Returns (delta = theta_H - theta_0, final params, mean loss).
    """
    return sgd_steps(loss_fn, params, batches, lr, momentum)


def make_client_step(loss_fn: LossFn, lr, momentum=0.0):
    """``local_sgd`` over the leading client axis of ``batches``
    (``torch.func.vmap``); params are shared by all clients (Alg. 7 line
    4). Returns f(params, stacked_batches) -> (stacked deltas, losses)."""
    def one(params, batches):
        delta, _, loss = local_sgd(loss_fn, params, batches, lr, momentum)
        return delta, loss
    return torch.func.vmap(one, in_dims=(None, 0))


def compute_gradient(loss_fn: LossFn, params: Params,
                     batch: Dict[str, torch.Tensor]) -> Tuple[Params, torch.Tensor]:
    """Single-step client (PSSGD / FedSGD): (gradient, loss)."""
    g, (loss, _) = torch.func.grad_and_value(loss_fn, has_aux=True)(params,
                                                                     batch)
    return g, loss
