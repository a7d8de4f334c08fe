"""Train steps on one card (PSSGD / local SGD / FSDP), the port of
``repro/launch/steps.py``'s ``TrainPolicy``, ``make_init_fn`` and
``make_train_step``.

* ``pssgd``    -- Alg. 1: the gradient, all-reduced over the data axis with
  a compressed wire format and client-side EF (``core/collectives.py``),
  then the optimizer;
* ``localsgd`` -- Alg. 6/7: params carry a client axis (one replica per
  data shard), H local steps over micro-batches between compressed
  delta-consensus rounds;
* ``fsdp``     -- the gradient as it is, then the optimizer.

The reference maps the step over its mesh with ``shard_map``; on one card
the map is a plain call and every ``pmean`` is over one member (the
identity), but the compressed all-reduce still quantizes twice. Gradients
come from autograd on the flat param dict, the layers rematerialized when
``policy.remat`` asks (``transformer.forward_trunk``). The serving steps
(``make_prefill_step``, ``make_decode_step``) wrap ``transformer.prefill``
and ``decode_step``.

A step takes its state over, as the reference's jitted step is handed a
state it then drops: it replaces the state's params, moments and EF leaf
by leaf, in the dicts it was given, so that each leaf's old values are
freed as its new ones are made. Keep a ``copy_state`` to reuse a state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import hierarchical_allreduce
from repro_torch.launch.mesh import LocalMesh, data_axes, n_data_shards
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import (OptState, apply_updates,
                                          init_opt_state)
from repro_torch.optim.schedules import get_schedule

State = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainPolicy:
    mode: str = "pssgd"           # pssgd | localsgd | fsdp
    compression: str = "none"     # none | bf16 | int8 | sign
    error_feedback: bool = False
    local_steps: int = 1          # H (localsgd)
    sync_pods: bool = True        # reduce over the pod axis this step
    pod_sync_dense: bool = True   # pod sync uses dense bf16 (fast fronthaul)
    optimizer: str = "adamw"
    opt_state_dtype: str = "float32"
    remat: bool = True
    lr: float = 3e-4
    total_steps: int = 10_000

    def tag(self) -> str:
        ef = "+ef" if self.error_feedback else ""
        h = f"+H{self.local_steps}" if self.mode == "localsgd" else ""
        return f"{self.mode}/{self.compression}{ef}{h}"


def _use_ef(policy: TrainPolicy) -> bool:
    return policy.error_feedback and policy.compression != "none"


def _stack(tree, n: int):
    if tree is None:
        return None
    return {k: x[None].expand((n,) + x.shape) for k, x in tree.items()}


def copy_state(state: State) -> State:
    """A state whose dicts a step may replace leaves in without touching
    ``state`` (the leaves themselves are shared: steps never write them)."""
    opt = state["opt"]
    out = dict(state, params=dict(state["params"]),
               opt=OptState(opt.step, *(None if t is None else dict(t)
                                        for t in (opt.m, opt.v))))
    if "ef" in state:
        out["ef"] = dict(state["ef"])
    return out


# ===========================================================================
# State construction
# ===========================================================================
def make_init_fn(cfg: ModelConfig, policy: TrainPolicy, mesh: LocalMesh):
    """Returns init(key) -> the state dict, on the key's device: params,
    ``OptState``, the step and, with EF on a compressed wire, one float32
    error leaf a data shard."""
    n_dp = n_data_shards(mesh)

    def init(key: torch.Tensor) -> State:
        params = tf.init_params(cfg, key)
        if policy.mode == "localsgd":
            opt = init_opt_state(params, policy.optimizer,
                                 policy.opt_state_dtype)
            params = _stack(params, n_dp)
            opt = OptState(opt.step, _stack(opt.m, n_dp), _stack(opt.v, n_dp))
            base = {k: p[0] for k, p in params.items()}
        else:
            opt = init_opt_state(params, policy.optimizer,
                                 policy.opt_state_dtype)
            base = params
        state = {"params": params, "opt": opt,
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=key.device)}
        if _use_ef(policy):
            state["ef"] = {k: torch.zeros((n_dp,) + p.shape,
                                          dtype=torch.float32,
                                          device=p.device)
                           for k, p in base.items()}
        return state
    return init


# ===========================================================================
# Train steps
# ===========================================================================
def make_train_step(cfg: ModelConfig, policy: TrainPolicy, mesh: LocalMesh):
    if policy.mode == "fsdp":
        return _make_fsdp_step(cfg, policy)
    if policy.mode == "localsgd":
        return _make_localsgd_step(cfg, policy, mesh)
    return _make_pssgd_step(cfg, policy, mesh)


def _value_and_grad(cfg: ModelConfig, policy: TrainPolicy, params, batch):
    """The loss (detached) and its gradient a leaf, by autograd."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss, _ = tf.lm_loss(leaves, cfg, batch, remat=policy.remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _reduction_axes(mesh: LocalMesh, policy: TrainPolicy) -> tuple:
    dp = data_axes(mesh)
    if not policy.sync_pods:
        dp = tuple(a for a in dp if a != "pod")
    return dp


def _update(opt_fn, params, grads, opt: OptState, lr, k: str) -> OptState:
    """One leaf's optimizer update, written into ``params`` and the
    moments' dicts; returns the counted state."""
    new_p, new = opt_fn({k: params[k]}, {k: grads.pop(k)},
                        OptState(opt.step, *(None if t is None else {k: t[k]}
                                             for t in (opt.m, opt.v))), lr)
    params[k] = new_p[k]
    for old, t in zip((opt.m, opt.v), (new.m, new.v)):
        if t is not None:
            old[k] = t[k]
    return new


def _apply(opt_fn, params, grads, opt: OptState, lr) -> OptState:
    """The optimizer over every leaf, in place of the old leaves."""
    new = opt
    for k in list(params):
        new = _update(opt_fn, params, grads, opt, lr, k)
    return OptState(new.step, opt.m, opt.v)


def _make_pssgd_step(cfg: ModelConfig, policy: TrainPolicy,
                     mesh: LocalMesh):
    red = _reduction_axes(mesh, policy)
    sizes = dict(mesh.shape)
    schedule = get_schedule(cfg.lr_schedule, policy.lr, policy.total_steps)
    opt_fn = apply_updates(policy.optimizer)
    use_ef = _use_ef(policy)

    def train_step(state: State, batch):
        params, opt = state["params"], state["opt"]
        loss, grads = _value_and_grad(cfg, policy, params, batch)
        lr = schedule(state["step"])
        ef = state.get("ef")
        new = opt
        for k in list(params):
            e = ef[k][0] if use_ef else None
            g, e = hierarchical_allreduce(
                {k: grads.pop(k)}, red, policy.compression,
                {k: e} if use_ef else None, sizes=sizes)
            if use_ef:
                ef[k] = e[k][None]
            new = _update(opt_fn, params, g, opt, lr, k)
        new_state = dict(state, opt=OptState(new.step, opt.m, opt.v),
                         step=state["step"] + 1)
        return new_state, {"loss": loss}

    return train_step


def _make_localsgd_step(cfg: ModelConfig, policy: TrainPolicy,
                        mesh: LocalMesh):
    red = _reduction_axes(mesh, policy)
    intra = tuple(a for a in red if a != "pod") or red
    sizes = dict(mesh.shape)
    schedule = get_schedule(cfg.lr_schedule, policy.lr, policy.total_steps)
    opt_fn = apply_updates(policy.optimizer)
    h = policy.local_steps
    use_ef = _use_ef(policy)

    def train_step(state: State, batch):
        params, opt = state["params"], state["opt"]
        p0 = {k: x[0] for k, x in params.items()}
        lr = schedule(state["step"])
        # H local steps over micro-batch slices (Alg. 7 lines 5-7), the
        # outer step's learning rate for all of them
        bsz = next(iter(batch.values())).shape[0]
        micro = {k: x.reshape((h, bsz // h) + x.shape[1:])
                 for k, x in batch.items()}
        p = dict(p0)
        o = OptState(opt.step, *(None if t is None else
                                 {k: x[0] for k, x in t.items()}
                                 for t in (opt.m, opt.v)))
        losses = []
        for i in range(h):
            loss, g = _value_and_grad(cfg, policy, p,
                                      {k: x[i] for k, x in micro.items()})
            o = _apply(opt_fn, p, g, o, lr)
            losses.append(loss)
        # compressed delta-consensus over the intra axes (Alg. 6 lines 8-14)
        ef = state.get("ef")
        for k in list(params):
            delta = p.pop(k).float() - p0[k].float()
            e = ef[k][0] if use_ef else None
            d, e = hierarchical_allreduce(
                {k: delta}, intra, policy.compression,
                {k: e} if use_ef else None, sizes=sizes)
            if use_ef:
                ef[k] = e[k][None]
            params[k] = (p0[k].float() + d[k]).to(p0[k].dtype)[None]
        for old, t in zip((opt.m, opt.v), (o.m, o.v)):
            if t is not None:
                for k in t:
                    old[k] = t[k][None]
        loss = torch.mean(torch.stack(losses))
        new_state = dict(state, opt=OptState(o.step, opt.m, opt.v),
                         step=state["step"] + 1)
        return new_state, {"loss": loss}

    return train_step


def _make_fsdp_step(cfg: ModelConfig, policy: TrainPolicy):
    schedule = get_schedule(cfg.lr_schedule, policy.lr, policy.total_steps)
    opt_fn = apply_updates(policy.optimizer)

    def train_step(state: State, batch):
        params = state["params"]
        loss, grads = _value_and_grad(cfg, policy, params, batch)
        opt = _apply(opt_fn, params, grads, state["opt"],
                     schedule(state["step"]))
        return dict(state, opt=opt, step=state["step"] + 1), {"loss": loss}

    return train_step


# ===========================================================================
# Serving steps
# ===========================================================================
def make_prefill_step(cfg: ModelConfig, q_chunk: int = 1024):
    """(params, batch) -> (last-token logits, cache); ``batch`` holds the
    tokens and any vision / audio embeddings."""
    def prefill_step(params, batch):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        return tf.prefill(params, cfg, batch["tokens"], extras,
                          q_chunk=q_chunk)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, circular: bool):
    """(params, cache, token, pos) -> (logits, new cache); ``pos`` a Python
    int."""
    def decode_step(params, cache, token, pos):
        return tf.decode_step(params, cfg, cache, token, pos,
                              circular=circular)
    return decode_step
