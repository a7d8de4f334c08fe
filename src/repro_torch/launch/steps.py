"""Train steps (PSSGD / local SGD / FSDP) on a mesh of members, the port
of ``repro/launch/steps.py``'s ``TrainPolicy``, ``make_init_fn``,
``state_shardings`` and ``make_train_step``.

* ``pssgd``    -- Alg. 1: each member's gradient of its rows of the batch,
  all-reduced over the data axes with a compressed wire format and
  client-side EF (``core/collectives.py``), then the optimizer;
* ``localsgd`` -- Alg. 6/7: one replica a data member, H local steps over
  micro-batches between compressed delta-consensus rounds over the intra
  axes, then the dense bf16 pod sync of Alg. 9 when the mesh has ``pod``;
* ``fsdp``     -- params and moments at rest split over the data axes
  (``state_shardings``): a step gathers each layer's leaves where the
  layer runs and again where the backward recomputes it (or reads a saved
  leaf), reduce-scatters each layer's gradient to the owned block (the
  mean over members) as the backward makes it, gathers the embedding,
  unembedding and other top-level leaves once for the step, and updates
  only the owned blocks. MoE layers route the step's global batch as one
  capacity group, as the reference's jitted step does
  (``models/moe.py::routed_over``).

The reference maps the step over its mesh with ``shard_map``; here each
member is a process (``launch/mesh.py``) that keeps its block of every
state leaf, as ``state_shardings`` places it, and receives its rows of the
batch (``P(dp)``). The ``model`` axis splits every leaf the rules split
(``held_specs``; mamba's ``in_proj`` by halves, ``sharding.HALVES``): the
layers compute with their blocks, Megatron-style (``models/tp.py``, named
by the step builders: attention, MLP, vocabulary, the mamba and RG-LRU
blocks with their recurrent states), and the expert stacks go through
``models/moe.py::moe_forward_ep``; that gives the numbers of the
reference's XLA-managed tensor parallelism up to the order of the sums
over ``model``. A leaf split over ``model`` is gathered
for a compressed all-reduce, whose scales and ``min_size`` cut cover the
whole leaf, and cut again; the plain float32 mean is elementwise and
reduces the member's block as it is. On one member every ``pmean`` is the
identity, but the compressed all-reduce still quantizes twice. Gradients
come from autograd on the flat param dict, the layers rematerialized when
``policy.remat`` asks (``transformer.forward_trunk``). The serving steps
(``make_prefill_step``, ``make_decode_step``) wrap ``transformer.prefill``
and ``decode_step``; on a mesh whose data axes split the batch, their MoE
layers route the global batch as one capacity group, as the reference's
jitted serving steps do.

A step takes its state over, as the reference's jitted step is handed a
state it then drops: it replaces the state's params, moments and EF leaf
by leaf, in the dicts it was given, so that each leaf's old values are
freed as its new ones are made. Keep a ``copy_state`` to reuse a state.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch

from repro_torch import random as trandom
from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import (hierarchical_allreduce, pmean,
                                          reduce_scatter_sum)
from repro_torch.launch import sharding as shard_rules
from repro_torch.launch.mesh import Mesh, data_axes, n_data_shards
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.tp import set_model_mesh
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


def param_shapes(cfg: ModelConfig) -> Dict:
    """The params' full shapes and dtypes, as meta tensors (no draw is
    computed; worked out once a config)."""
    return dict(_param_shapes(cfg))


@functools.lru_cache(maxsize=16)
def _param_shapes(cfg: ModelConfig) -> Dict:
    return tf.init_params(cfg, trandom.PRNGKey(0, "meta"))


# ===========================================================================
# Shardings
# ===========================================================================
def state_shardings(cfg: ModelConfig, policy: TrainPolicy, mesh: Mesh,
                    state: State) -> State:
    """The reference's spec of every leaf of a state of full shapes
    (anything with ``.shape``): params and moments by the rules (stacked
    over the data axes in localsgd, split over them in fsdp), the step
    replicated, the EF's leading client axis over the data axes."""
    dp = shard_rules.data_entry(mesh)

    def params_sh(tree):
        if policy.mode == "localsgd":
            return shard_rules.stacked_client_shardings(cfg, tree, mesh)
        return shard_rules.param_shardings(cfg, tree, mesh,
                                           fsdp=(policy.mode == "fsdp"))

    opt = state["opt"]
    out: State = {"params": params_sh(state["params"])}
    out["opt"] = OptState((), *(params_sh(t) if t is not None else None
                                for t in (opt.m, opt.v)))
    out["step"] = ()
    if "ef" in state:
        out["ef"] = {k: (dp,) + shard_rules.param_spec(
            k, tuple(x.shape)[1:], cfg, mesh, fsdp=False)
            for k, x in state["ef"].items()}
    return out


def full_state(cfg: ModelConfig, policy: TrainPolicy, mesh: Mesh,
               params: Dict) -> State:
    """A state of the reference's full shapes and dtypes (meta tensors)
    from params of full shapes: the client-stacked params and moments of
    localsgd, the int32 step, the ``(n_dp, ...)`` float32 EF."""
    meta = {k: torch.empty(p.shape, dtype=p.dtype, device="meta")
            for k, p in params.items()}
    n_dp = n_data_shards(mesh)
    opt = init_opt_state(meta, policy.optimizer, policy.opt_state_dtype)
    if policy.mode == "localsgd":
        state = {"params": _stack(meta, n_dp),
                 "opt": OptState(opt.step, _stack(opt.m, n_dp),
                                 _stack(opt.v, n_dp))}
    else:
        state = {"params": meta, "opt": opt}
    state["step"] = torch.empty((), dtype=torch.int32, device="meta")
    if _use_ef(policy):
        state["ef"] = _stack({k: torch.empty(p.shape, device="meta")
                              for k, p in meta.items()}, n_dp)
    return state


def held_specs(cfg: ModelConfig, policy: TrainPolicy, mesh: Mesh) -> State:
    """The spec of every leaf of a member's state, as ``state_shardings``
    places the reference's (mamba's ``in_proj`` by halves:
    ``sharding.held_spec``)."""
    state = full_state(cfg, policy, mesh, param_shapes(cfg))
    specs = state_shardings(cfg, policy, mesh, state)

    def held(tree, shapes):
        if tree is None:
            return None
        return {k: shard_rules.held_spec(spec, k, shapes[k].shape, mesh)
                for k, spec in tree.items()}
    opt = state["opt"]
    out = {"params": held(specs["params"], state["params"]),
           "opt": OptState((), held(specs["opt"].m, opt.m),
                           held(specs["opt"].v, opt.v)),
           "step": ()}
    if "ef" in specs:
        out["ef"] = held(specs["ef"], state["ef"])
    return out


def _map_state(state: State, specs: State, fn) -> State:
    """``fn(leaf, spec)`` over every leaf of a state."""
    def tree(t, sp):
        return None if t is None else {k: fn(x, sp[k]) for k, x in t.items()}
    opt = state["opt"]
    out = dict(state, params=tree(state["params"], specs["params"]),
               opt=OptState(fn(opt.step, ()), tree(opt.m, specs["opt"].m),
                            tree(opt.v, specs["opt"].v)),
               step=fn(state["step"], ()))
    if "ef" in state:
        out["ef"] = tree(state["ef"], specs["ef"])
    return out


def shard_state(cfg: ModelConfig, policy: TrainPolicy, mesh: Mesh,
                state: State) -> State:
    """This member's state from a state in the reference's layout (e.g.
    ``convert.train_state_from_jax``)."""
    specs = held_specs(cfg, policy, mesh)
    return _map_state(state, specs,
                      lambda x, sp: shard_rules.shard(x, sp, mesh))


def gather_params(cfg: ModelConfig, policy: TrainPolicy, mesh: Mesh,
                  params: Dict) -> Dict:
    """The whole params in the reference's layout (client-stacked in
    localsgd) from every member's (every member must call it)."""
    specs = held_specs(cfg, policy, mesh)["params"]
    return {k: shard_rules.gather(x, specs[k], mesh)
            for k, x in params.items()}


def gather_state(cfg: ModelConfig, policy: TrainPolicy, mesh: Mesh,
                 state: State) -> State:
    """The whole state in the reference's layout from every member's (every
    member must call it and receives it)."""
    specs = held_specs(cfg, policy, mesh)
    return _map_state(state, specs,
                      lambda x, sp: shard_rules.gather(x, sp, mesh))


# ===========================================================================
# State construction
# ===========================================================================
def make_init_fn(cfg: ModelConfig, policy: TrainPolicy, mesh: Mesh):
    """Returns init(key) -> this member's state, on the key's device: its
    block of every leaf (``held_specs``), cut leaf by leaf from the same
    seeded draw on every member: params, ``OptState``, the step and, with
    EF on a compressed wire, the member's float32 error row (``ef[i]`` of
    the reference's ``(n_dp, ...)`` leaf)."""
    specs = held_specs(cfg, policy, mesh)
    stacked = policy.mode == "localsgd"

    def init(key: torch.Tensor) -> State:
        params = tf.init_params(cfg, key)
        full = {k: tuple(p.shape) for k, p in params.items()}
        for k in list(params):
            sp = specs["params"][k]
            params[k] = shard_rules.shard(params[k], sp[1:] if stacked
                                          else sp, mesh)
        opt = init_opt_state(params, policy.optimizer,
                             policy.opt_state_dtype)
        base = params
        if stacked:
            params = _stack(params, 1)
            opt = OptState(opt.step, _stack(opt.m, 1), _stack(opt.v, 1))
        state = {"params": params, "opt": opt,
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=key.device)}
        if _use_ef(policy):
            state["ef"] = {k: torch.zeros(
                (1,) + shard_rules.shard_shape(full[k], specs["ef"][k][1:],
                                               mesh),
                dtype=torch.float32, device=p.device)
                for k, p in base.items()}
        return state
    return init


# ===========================================================================
# Train steps
# ===========================================================================
def make_train_step(cfg: ModelConfig, policy: TrainPolicy, mesh: Mesh):
    set_model_mesh(mesh)
    if policy.mode == "fsdp":
        return _make_fsdp_step(cfg, policy, mesh)
    if policy.mode == "localsgd":
        return _make_localsgd_step(cfg, policy, mesh)
    return _make_pssgd_step(cfg, policy, mesh)


def _value_and_grad(cfg: ModelConfig, policy: TrainPolicy, params, batch,
                    gather=None):
    """The loss (detached) and its gradient a leaf, by autograd; ``gather``
    (``_LayerGather``) makes each layer's params from the leaves it is
    handed (``transformer._layer``)."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss, _ = tf.lm_loss(leaves, cfg, batch, remat=policy.remat,
                         gather=gather)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _reduction_axes(mesh: Mesh, policy: TrainPolicy) -> tuple:
    dp = data_axes(mesh)
    if not policy.sync_pods:
        dp = tuple(a for a in dp if a != "pod")
    return dp


def local_batch(batch: Dict, mesh: Mesh, *, divisible: bool = True) -> Dict:
    """This member's rows of the global batch, as ``P(dp)`` hands them out
    (the whole batch where it does not divide, unless ``divisible``)."""
    specs = shard_rules.batch_shardings(batch, mesh)
    n = n_data_shards(mesh)
    if divisible and n > 1 and any(s[:1] == (None,) for s in specs.values()):
        raise ValueError(f"a batch of {next(iter(batch.values())).shape[0]} "
                         f"rows does not split over {n} data members")
    return {k: shard_rules.shard(x, specs[k], mesh) for k, x in batch.items()}


def _allreduce_leaf(k, g, e, axes, policy, mesh, mspec):
    """The compressed all-reduce of one leaf over ``axes``: a leaf split
    over ``model`` is gathered whole first (in the reference's layout,
    ``sharding.gather``), so that the scales and the ``min_size`` cut
    cover the leaf, and cut again after; the plain float32 mean gives the
    same bits on the block."""
    split = (policy.compression != "none"
             and any(a is not None for a in mspec))
    if split:
        g = shard_rules.gather(g, mspec, mesh)
        e = None if e is None else shard_rules.gather(e, mspec, mesh)
    out, e = hierarchical_allreduce({k: g}, axes, policy.compression,
                                    None if e is None else {k: e},
                                    mesh=mesh)
    out = out[k]
    e = None if e is None else e[k]
    if split:
        out = shard_rules.shard(out, mspec, mesh)
        e = None if e is None else shard_rules.shard(e, mspec, mesh)
    return out, e


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


def _model_split(specs: Dict[str, tuple]) -> Dict[str, tuple]:
    """Each leaf's split over ``model`` alone."""
    return {k: tuple(a if a == "model" else None for a in sp)
            for k, sp in specs.items()}


def _make_pssgd_step(cfg: ModelConfig, policy: TrainPolicy, mesh: Mesh):
    dp = data_axes(mesh)
    red = _reduction_axes(mesh, policy)
    schedule = get_schedule(cfg.lr_schedule, policy.lr, policy.total_steps)
    opt_fn = apply_updates(policy.optimizer)
    use_ef = _use_ef(policy)
    mspecs = _model_split(held_specs(cfg, policy, mesh)["params"])

    def train_step(state: State, batch):
        params, opt = state["params"], state["opt"]
        loss, grads = _value_and_grad(cfg, policy, params,
                                      local_batch(batch, mesh))
        lr = schedule(state["step"])
        ef = state.get("ef")
        new = opt
        for k in list(params):
            g, e = _allreduce_leaf(k, grads.pop(k),
                                   ef[k][0] if use_ef else None, red,
                                   policy, mesh, mspecs[k])
            if use_ef:
                ef[k] = e[None]
            new = _update(opt_fn, params, {k: g}, opt, lr, k)
        new_state = dict(state, opt=OptState(new.step, opt.m, opt.v),
                         step=state["step"] + 1)
        return new_state, {"loss": pmean(loss, mesh, dp)}

    return train_step


def _make_localsgd_step(cfg: ModelConfig, policy: TrainPolicy, mesh: Mesh):
    dp = data_axes(mesh)
    red = _reduction_axes(mesh, policy)
    intra = tuple(a for a in red if a != "pod") or red
    schedule = get_schedule(cfg.lr_schedule, policy.lr, policy.total_steps)
    opt_fn = apply_updates(policy.optimizer)
    h = policy.local_steps
    use_ef = _use_ef(policy)
    mspecs = _model_split({k: sp[1:] for k, sp in
                           held_specs(cfg, policy, mesh)["params"].items()})

    def train_step(state: State, batch):
        params, opt = state["params"], state["opt"]
        p0 = {k: x[0] for k, x in params.items()}
        lr = schedule(state["step"])
        # H local steps over micro-batch slices of this member's rows (Alg.
        # 7 lines 5-7), the outer step's learning rate for all of them
        batch = local_batch(batch, mesh)
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
        pod_sync = policy.sync_pods and "pod" in dp
        for k in list(params):
            delta = p.pop(k).float() - p0[k].float()
            d, e = _allreduce_leaf(k, delta, ef[k][0] if use_ef else None,
                                   intra, policy, mesh, mspecs[k])
            if use_ef:
                ef[k] = e[None]
            new = (p0[k].float() + d).to(p0[k].dtype)
            if pod_sync:
                # inter-cluster averaging (Alg. 9 line 13): dense bf16
                new = pmean(new.to(torch.bfloat16), mesh, "pod").to(
                    p0[k].dtype)
            params[k] = new[None]
        for old, t in zip((opt.m, opt.v), (o.m, o.v)):
            if t is not None:
                for k in t:
                    old[k] = t[k][None]
        loss = pmean(torch.mean(torch.stack(losses)), mesh, dp)
        new_state = dict(state, opt=OptState(o.step, opt.m, opt.v),
                         step=state["step"] + 1)
        return new_state, {"loss": loss}

    return train_step


def _reduce_scatter_mean(g: torch.Tensor, spec: tuple, mesh: Mesh,
                         axes: tuple) -> torch.Tensor:
    """This member's block of the mean over ``axes`` of the full leaf
    ``g``, split along the dim ``spec`` puts on ``axes``: the blocks go
    out by an all-to-all and are summed one member after another."""
    dim = spec.index(axes)
    n = mesh.n(axes)
    parts = torch.stack(torch.chunk(g, n, dim=dim))   # (n, block...)
    s = reduce_scatter_sum(
        parts.reshape(n * parts.shape[1], *parts.shape[2:]), mesh, axes)
    return (s / n).to(g.dtype).reshape(parts.shape[1:])


class _GatherOverData(torch.autograd.Function):
    """Forward: a leaf whole from the members' blocks over the data axes
    (``sharding.gather``); backward: this member's block of the mean of
    the cotangent over them (``_reduce_scatter_mean``)."""

    @staticmethod
    def forward(ctx, block, spec, mesh, axes):
        ctx.spec, ctx.mesh, ctx.axes = spec, mesh, axes
        return shard_rules.gather(block, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter_mean(g, ctx.spec, ctx.mesh, ctx.axes),
                None, None, None)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _LayerGather:
    """The fsdp step's ``gather`` (``transformer._layer``): a layer's
    params from this member's blocks, each leaf that the data axes split
    all-gathered whole inside the layer's function (``_GatherOverData``).
    A recomputed layer gathers again in the backward. A layer that is not
    recomputed keeps no gathered leaf either: autograd's saved copy of one
    is packed as the member's block (a saved-tensor hook) and gathered
    again where the backward reads it."""

    def __init__(self, specs: Dict[str, tuple], mesh: Mesh, axes):
        self.specs, self.mesh, self.axes = specs, mesh, axes

    def __call__(self, fn, path: str, depth: int, recomputed: bool):
        def run(p, *args, **kw):
            whole, blocks = {}, {}
            for k, x in tf.flatten_params(p).items():
                spec = self.specs[f"{path}/{k}"][depth:]
                if self.axes in spec:
                    w = _GatherOverData.apply(x, spec, self.mesh, self.axes)
                    blocks[_storage(w)] = (x.detach(), spec)
                    x = w
                whole[k] = x
            whole = tf.nest_params(whole)
            if recomputed or not blocks:
                return fn(whole, *args, **kw)
            with torch.autograd.graph.saved_tensors_hooks(
                    functools.partial(self._pack, blocks), self._unpack):
                return fn(whole, *args, **kw)
        return run

    @staticmethod
    def _pack(blocks: dict, t: torch.Tensor):
        src = blocks.get(_storage(t))
        if src is None:
            return t
        return src + (t.size(), t.stride(), t.storage_offset())

    def _unpack(self, packed):
        if torch.is_tensor(packed):
            return packed
        block, spec, size, stride, offset = packed
        return shard_rules.gather(block, spec, self.mesh).as_strided(
            size, stride, offset)


def _routing(mesh, rows: int, *, aux: bool = False):
    """``moe.routed_over`` the data axes of ``mesh`` where they split a
    global batch of ``rows`` rows (``sharding.batch_splits``); where every
    member holds it whole, a member routes it alone."""
    split = mesh is not None and shard_rules.batch_splits(rows, mesh)
    return moe.routed_over(mesh if split else None,
                           () if mesh is None else data_axes(mesh), aux=aux)


def _make_fsdp_step(cfg: ModelConfig, policy: TrainPolicy, mesh: Mesh):
    dp = data_axes(mesh)
    dpe = shard_rules.data_entry(mesh)
    schedule = get_schedule(cfg.lr_schedule, policy.lr, policy.total_steps)
    opt_fn = apply_updates(policy.optimizer)
    # every leaf whole over the data axes for its use (the split over model
    # stays): a layer's leaves a layer at a time, the others for the step
    dspecs = {k: tuple(a if a == dpe else None for a in sp) for k, sp in
              held_specs(cfg, policy, mesh)["params"].items()}
    split = mesh.n(dp) > 1
    gather = _LayerGather(dspecs, mesh, dpe) if split else None
    layered = {k for k in dspecs if split and k.startswith(tf.LAYER_KEYS)}

    def train_step(state: State, batch):
        params = state["params"]
        full = {k: p if k in layered else shard_rules.gather(p, dspecs[k],
                                                             mesh)
                for k, p in params.items()}
        with _routing(mesh, batch["tokens"].shape[0], aux=True):
            loss, grads = _value_and_grad(
                cfg, policy, full, local_batch(batch, mesh, divisible=False),
                gather)
        del full
        for k in list(grads):
            if split and dpe in dspecs[k]:
                if k not in layered:   # a layer's comes back as the block
                    grads[k] = _reduce_scatter_mean(grads[k], dspecs[k],
                                                    mesh, dpe)
            else:
                grads[k] = pmean(grads[k], mesh, dp)
        opt = _apply(opt_fn, params, grads, state["opt"],
                     schedule(state["step"]))
        return (dict(state, opt=opt, step=state["step"] + 1),
                {"loss": pmean(loss, mesh, dp)})

    return train_step


# ===========================================================================
# Serving steps
# ===========================================================================
def _serving_mesh(mesh, global_batch) -> None:
    """Name ``mesh`` for the layers; a mesh with several data members
    cannot tell from a member's rows whether the batch split, so it needs
    ``global_batch``."""
    if mesh is None:
        return
    if global_batch is None and n_data_shards(mesh) > 1:
        raise ValueError(f"a serving step on the mesh {mesh.shape} needs "
                         "global_batch: a member's rows do not say whether "
                         "the batch split over its data members")
    set_model_mesh(mesh)


def make_prefill_step(cfg: ModelConfig, q_chunk: int = 1024, mesh=None,
                      global_batch=None):
    """(params, batch) -> (last-token logits, cache); ``batch`` holds the
    tokens and any vision / audio embeddings. On ``mesh`` a member passes
    its blocks of the params (``held_specs``) and its rows of the batch
    (``sharding.batch_shardings``: a global batch of ``global_batch`` rows,
    which a mesh with several data members needs, split over the data axes
    or held whole by every member where it does not divide), and receives
    its block of the logits (over the vocabulary, where it splits:
    ``models/tp.py::gather_last``) and of the cache."""
    _serving_mesh(mesh, global_batch)

    def prefill_step(params, batch):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        tokens = batch["tokens"]
        with _routing(mesh, global_batch or tokens.shape[0]):
            return tf.prefill(params, cfg, tokens, extras, q_chunk=q_chunk)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, circular: bool, mesh=None,
                     global_batch=None):
    """(params, cache, token, pos) -> (logits, new cache); ``pos`` a Python
    int. On ``mesh``, a member's blocks and rows, as
    ``make_prefill_step``."""
    _serving_mesh(mesh, global_batch)

    def decode_step(params, cache, token, pos):
        with _routing(mesh, global_batch or token.shape[0]):
            return tf.decode_step(params, cfg, cache, token, pos,
                                  circular=circular)
    return decode_step
