"""Distributed-optimization algorithm registry (paper §II-III), port of
``repro/core/algorithms/registry.py``.

The algorithm *name* selects an :class:`Algorithm` triple
``(client_update, server_update, init_algo_state)``; every hyperparameter is
a float32 scalar tensor in :class:`AlgoParams`. Parameters are plain
dictionaries of tensors; their flat message layout concatenates the leaves in
sorted key order, as ``jax.tree.leaves`` orders a dict.

This slice ports ``fedavg`` (H local SGD steps, server averaging, Alg. 7).
The reference's other seven algorithms are known names that raise
``NotImplementedError`` until they are ported.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


class AlgoParams(NamedTuple):
    """Algorithm hyperparameters as float32 scalar tensors (the fields of the
    reference, whatever an algorithm reads)."""
    lr: torch.Tensor
    momentum: torch.Tensor
    prox_mu: torch.Tensor
    server_lr: torch.Tensor
    slowmo_beta: torch.Tensor
    beta1: torch.Tensor
    beta2: torch.Tensor
    eps: torch.Tensor
    staleness_pow: torch.Tensor
    buffer_goal: torch.Tensor

    def to(self, device) -> "AlgoParams":
        return AlgoParams(*(f.to(device) for f in self))


def algo_params(lr: float = 0.05, momentum: float = 0.9,
                prox_mu: float = 0.01, server_lr: float = 1.0,
                slowmo_beta: float = 0.5, beta1: float = 0.9,
                beta2: float = 0.99, eps: float = 1e-3,
                staleness_pow: float = 0.5, buffer_goal: float = 1.0,
                device=None) -> AlgoParams:
    return AlgoParams(*(torch.tensor(float(v), dtype=torch.float32,
                                     device=device) for v in (
        lr, momentum, prox_mu, server_lr, slowmo_beta, beta1, beta2, eps,
        staleness_pow, buffer_goal)))


def default_algo_params(device=None) -> AlgoParams:
    return algo_params(device=device)


# ---------------------------------------------------------------------------
# Flat message-space helpers
# ---------------------------------------------------------------------------
def leaves(tree: Params) -> List[torch.Tensor]:
    """Leaves in ``jax.tree.leaves`` order for a flat dict: sorted keys."""
    return [tree[k] for k in sorted(tree)]


def flat_dim(tree: Params) -> int:
    """Total message dimension of a parameter/delta dict."""
    return sum(leaf.numel() for leaf in tree.values())


def flatten_vec(tree: Params) -> torch.Tensor:
    """Dict -> one flat (D,) float32 message vector."""
    return torch.cat([leaf.to(torch.float32).reshape(-1)
                      for leaf in leaves(tree)])


def unflatten_vec(vec: torch.Tensor, template: Params) -> Params:
    """(D,) message vector -> float32 dict shaped like ``template``."""
    out, off = {}, 0
    for k in sorted(template):
        size = template[k].numel()
        out[k] = vec[off:off + size].reshape(template[k].shape)
        off += size
    return out


def unflatten_rows(mat: torch.Tensor, template: Params) -> Params:
    """(N, D) message matrix -> dict of float32 leaves with a leading client
    axis, shapes ``(N,) + template_leaf.shape``."""
    out, off = {}, 0
    for k in sorted(template):
        size = template[k].numel()
        out[k] = mat[:, off:off + size].reshape(
            (mat.shape[0],) + tuple(template[k].shape))
        off += size
    return out


# ---------------------------------------------------------------------------
# Local SGD loop (behind every client update)
# ---------------------------------------------------------------------------
def sgd_steps(loss_fn, params: Params, batches: Params, lr, momentum=0.0,
              extra_grad: Optional[Callable[[Params], Params]] = None
              ) -> Tuple[Params, Params, torch.Tensor]:
    """H local (momentum-)SGD steps of one client (eqs. 32-35).

    ``loss_fn(params, batch) -> (loss, aux)``; ``batches`` leaves have a
    leading dim H. ``extra_grad(p)`` (optional) is added to the gradient each
    step. Returns (delta = theta_H - theta_0, final params, mean loss). Runs
    under ``torch.func.vmap`` over clients (``fl_round``), so it is written
    with ``torch.func.grad_and_value`` and no in-place updates.
    """
    vg_fn = torch.func.grad_and_value(lambda p, b: loss_fn(p, b)[0])
    vel = {k: torch.zeros_like(v, dtype=torch.float32)
           for k, v in params.items()}
    h = next(iter(batches.values())).shape[0]
    p, losses = params, []
    for step in range(h):
        g, loss = vg_fn(p, {k: v[step] for k, v in batches.items()})
        if extra_grad is not None:
            extra = extra_grad(p)
            g = {k: g[k].to(torch.float32) + extra[k] for k in g}
        vel = {k: momentum * vel[k] + g[k].to(torch.float32) for k in vel}
        p = {k: (p[k].to(torch.float32) - lr * vel[k]).to(p[k].dtype)
             for k in p}
        losses.append(loss)
    delta = {k: p[k].to(torch.float32) - params[k].to(torch.float32)
             for k in p}
    return delta, p, torch.stack(losses).mean()


# ---------------------------------------------------------------------------
# Client and server updates
# ---------------------------------------------------------------------------
def _client_sgd(loss_fn, ap: AlgoParams, params, batches, ctrl):
    delta, _, loss = sgd_steps(loss_fn, params, batches, ap.lr)
    return delta, None, loss


def _server_avg(ap: AlgoParams, params, mean_delta, state, ctrl_aux):
    new_params = {k: (p.to(torch.float32) + ap.server_lr * mean_delta[k])
                  .to(p.dtype) for k, p in params.items()}
    return new_params, state


def _init_none(params):
    return None


class Algorithm(NamedTuple):
    """The registry triple plus ``uplink_factor``, the message-sized
    payloads a client uplinks per round (priced by the engine)."""
    name: str
    client_update: Callable
    server_update: Callable
    init_algo_state: Callable
    uplink_factor: float = 1.0


_REGISTRY: Dict[str, Algorithm] = {
    "fedavg": Algorithm("fedavg", _client_sgd, _server_avg, _init_none),
}
# algorithms of the reference that later slices of the port add
_NOT_YET_PORTED = ("fedavg_m", "fedprox", "scaffold", "slowmo", "fedadam",
                   "fedyogi", "fedbuff")


def get_algorithm(name) -> Algorithm:
    """Registry lookup: name -> :class:`Algorithm` (an :class:`Algorithm`
    passes through unchanged)."""
    if isinstance(name, Algorithm):
        return name
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported to PyTorch yet; "
            f"ported: {sorted(_REGISTRY)}")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; "
                         f"known: {sorted(_REGISTRY)}") from None
