"""Distributed-optimization algorithm registry (paper §II-III), port of
``repro/core/algorithms/registry.py``.

The algorithm *name* selects an :class:`Algorithm` triple
``(client_update, server_update, init_algo_state)``; every hyperparameter is
a float32 scalar tensor in :class:`AlgoParams`. Parameters are plain
dictionaries of tensors; their flat message layout concatenates the leaves in
sorted key order, as ``jax.tree.leaves`` orders a dict.

Algorithms
----------
``fedavg``     H local SGD steps, server averaging (Alg. 7).
``fedavg_m``   FedAvg with client-side momentum (``momentum``).
``fedprox``    proximal local steps ``g + prox_mu * (w - w_global)``.
``scaffold``   control-variate-corrected local steps ``g + c - c_i``; the
               per-client ``c_i`` are a flat (N, D) matrix the engine
               carries (``FLState.ctrl``), the server ``c`` a flat (D,)
               vector in the algorithm state; the ctrl delta is a second
               uplink message.
``slowmo``     server momentum over the pseudo-gradient (Alg. 8).
``fedadam``    server Adam on the pseudo-gradient.
``fedyogi``    server Yogi.
``fedbuff``    buffered server updates of staleness-discounted messages;
               ``buffer_goal=1`` with ``staleness_pow=0`` is bitwise fedavg.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import aggregation as agg

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


def stack_algo_params(ps) -> AlgoParams:
    """Stack params along a leading variant axis."""
    ps = list(ps)
    return AlgoParams(*(torch.stack([getattr(p, f) for p in ps])
                        for f in AlgoParams._fields))


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
# Client updates, one client (``fl_round`` vmaps over the client axis):
# (loss_fn, ap, params, batches, ctrl) -> (delta, ctrl_delta, loss), where
# ``ctrl`` is None or a ``(c_i, c)`` pair of float32 dicts for
# control-variate algorithms (which return the uplinked ctrl_delta)
# ---------------------------------------------------------------------------
def _client_sgd(loss_fn, ap: AlgoParams, params, batches, ctrl):
    delta, _, loss = sgd_steps(loss_fn, params, batches, ap.lr)
    return delta, None, loss


def _client_sgd_momentum(loss_fn, ap: AlgoParams, params, batches, ctrl):
    delta, _, loss = sgd_steps(loss_fn, params, batches, ap.lr,
                               momentum=ap.momentum)
    return delta, None, loss


def _client_prox(loss_fn, ap: AlgoParams, params, batches, ctrl):
    w0 = {k: p.to(torch.float32) for k, p in params.items()}

    def prox_grad(p):
        return {k: ap.prox_mu * (p[k].to(torch.float32) - w0[k]) for k in p}

    delta, _, loss = sgd_steps(loss_fn, params, batches, ap.lr,
                               extra_grad=prox_grad)
    return delta, None, loss


def _client_scaffold(loss_fn, ap: AlgoParams, params, batches, ctrl):
    c_i, c = ctrl
    correction = {k: c[k] - c_i[k] for k in c}
    delta, _, loss = sgd_steps(loss_fn, params, batches, ap.lr,
                               extra_grad=lambda p: correction)
    # option-II control update: c_i+ = c_i - c + (w0 - wH) / (H lr), so the
    # uplinked ctrl_delta = c_i+ - c_i = -c - delta / (H lr)
    h = next(iter(batches.values())).shape[0]
    ctrl_delta = {k: -c[k] - delta[k] / (h * ap.lr) for k in c}
    return delta, ctrl_delta, loss


# ---------------------------------------------------------------------------
# Server updates: (ap, params, mean_delta, state, ctrl_aux) -> (new_params,
# new_state). ``ctrl_aux`` is None, or (mean_ctrl_delta (D,), participating
# fraction |S|/N) for control-variate algorithms.
# ---------------------------------------------------------------------------
def _server_avg(ap: AlgoParams, params, mean_delta, state, ctrl_aux):
    new_params = {k: (p.to(torch.float32) + ap.server_lr * mean_delta[k])
                  .to(p.dtype) for k, p in params.items()}
    return new_params, state


def _server_scaffold(ap: AlgoParams, params, mean_delta, state, ctrl_aux):
    new_params, _ = _server_avg(ap, params, mean_delta, None, None)
    mean_ctrl_delta, part_frac = ctrl_aux
    return new_params, state + part_frac * mean_ctrl_delta


def _server_slowmo(ap: AlgoParams, params, mean_delta, state, ctrl_aux):
    return agg.slowmo_step(params, mean_delta, state, inner_lr=ap.lr,
                           alpha=ap.server_lr, beta=ap.slowmo_beta)


def _server_adam(ap: AlgoParams, params, mean_delta, state, ctrl_aux):
    return agg.fedadam_step(params, mean_delta, state, server_lr=ap.server_lr,
                            beta1=ap.beta1, beta2=ap.beta2, eps=ap.eps)


def _server_yogi(ap: AlgoParams, params, mean_delta, state, ctrl_aux):
    return agg.fedadam_step(params, mean_delta, state, server_lr=ap.server_lr,
                            beta1=ap.beta1, beta2=ap.beta2, eps=ap.eps,
                            yogi=True)


def _server_fedbuff(ap: AlgoParams, params, mean_delta, state, ctrl_aux):
    """Buffered server update (FedBuff, Nguyen et al. 2022): the round's
    (already staleness-discounted) mean delta accumulates into a flat (D,)
    buffer, applied as ``server_lr * buffer`` once ``buffer_goal`` rounds
    have contributed, then reset. With ``buffer_goal == 1`` and
    ``staleness_pow == 0`` this is bitwise fedavg: the buffer holds exactly
    one round's mean delta, and flattening and unflattening float32 is the
    identity."""
    buf, cnt = state
    buf = buf + flatten_vec(mean_delta)
    cnt = cnt + 1.0
    apply = cnt >= ap.buffer_goal
    upd = unflatten_vec(buf, params)
    new_params = {k: torch.where(
        apply, (p.to(torch.float32) + ap.server_lr * upd[k]).to(p.dtype), p)
        for k, p in params.items()}
    buf = torch.where(apply, torch.zeros_like(buf), buf)
    cnt = torch.where(apply, torch.zeros_like(cnt), cnt)
    return new_params, (buf, cnt)


def _device(params):
    return next(iter(params.values())).device


def _init_none(params):
    return None


def _init_fedbuff(params):
    return (torch.zeros(flat_dim(params), dtype=torch.float32,
                        device=_device(params)),
            torch.zeros((), dtype=torch.float32, device=_device(params)))


def _init_scaffold(params):
    return torch.zeros(flat_dim(params), dtype=torch.float32,
                       device=_device(params))


class Algorithm(NamedTuple):
    """The registry triple plus the static facts the engine needs:
    ``uses_ctrl`` allocates the flat (N, D) control-variate matrix,
    ``uplink_factor`` is how many message-sized payloads a client uplinks
    per round (2 for SCAFFOLD: delta + ctrl delta), and ``uses_staleness``
    discounts each client's message by ``(1 + staleness)^-staleness_pow``
    (fedbuff)."""
    name: str
    client_update: Callable
    server_update: Callable
    init_algo_state: Callable
    uses_ctrl: bool = False
    uplink_factor: float = 1.0
    uses_staleness: bool = False


_REGISTRY: Dict[str, Algorithm] = {
    "fedavg": Algorithm("fedavg", _client_sgd, _server_avg, _init_none),
    "fedavg_m": Algorithm("fedavg_m", _client_sgd_momentum, _server_avg,
                          _init_none),
    "fedprox": Algorithm("fedprox", _client_prox, _server_avg, _init_none),
    "scaffold": Algorithm("scaffold", _client_scaffold, _server_scaffold,
                          _init_scaffold, uses_ctrl=True, uplink_factor=2.0),
    "slowmo": Algorithm("slowmo", _client_sgd, _server_slowmo,
                        agg.init_slowmo),
    "fedadam": Algorithm("fedadam", _client_sgd, _server_adam,
                         agg.init_server_opt),
    "fedyogi": Algorithm("fedyogi", _client_sgd, _server_yogi,
                         agg.init_server_opt),
    "fedbuff": Algorithm("fedbuff", _client_sgd, _server_fedbuff,
                         _init_fedbuff, uses_staleness=True),
}

# deprecated SimConfig.server / fl_round(server=) spellings -> registry names
SERVER_ALIASES: Dict[str, str] = {
    "avg": "fedavg", "slowmo": "slowmo", "adam": "fedadam", "yogi": "fedyogi",
}


def get_algorithm(name) -> Algorithm:
    """Registry lookup: name -> :class:`Algorithm` (an :class:`Algorithm`
    passes through unchanged)."""
    if isinstance(name, Algorithm):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; "
                         f"known: {sorted(_REGISTRY)}") from None


def algorithm_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def from_server_name(server: str) -> str:
    """Map a deprecated ``server=`` spelling onto its registry name."""
    try:
        return SERVER_ALIASES[server]
    except KeyError:
        raise ValueError(f"unknown server {server!r}; "
                         f"known: {sorted(SERVER_ALIASES)}") from None
