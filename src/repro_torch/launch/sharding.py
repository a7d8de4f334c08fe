"""Divisibility-aware sharding rules, the port of ``repro/launch/sharding.py``.

Every param leaf gets a spec from a name-keyed rule table:
* ``tp``   -- the tensor-parallel dim, sharded over ``model``;
* ``fsdp`` -- the fully-sharded dim, sharded over the data axes (only in
  fsdp mode: the paper-faithful FL baseline replicates params over data,
  because each "client" holds the full model).

Dims are only sharded when divisible by the axis size (gemma's 8 heads,
whisper's odd 51865 vocab etc. fall back to replication on that dim).
Stacked-layer leading axes are never sharded.

A spec is the reference's ``PartitionSpec`` as plain data: a tuple with one
entry per dim, each ``None``, an axis name or a tuple of axis names (a dim
split over several axes, row-major; one axis is its name, as
``PartitionSpec`` normalizes it). Leaves are keyed by the port's
``/``-joined paths (``transformer.flatten_params``). ``shard`` cuts this
member's block of a full tensor, ``gather`` puts the blocks back together.

A member holds the block the rules give it of every leaf (``held_spec``),
but for mamba's ``in_proj``, ``(d, 2 d_inner)``: its columns are the
``x`` half, then the ``z`` half, and the rule's contiguous block of them
would give member 0 of two every ``x`` column and no ``z`` column. Its
``model`` entry is ``HALVES`` instead: a member holds its block of each
half, joined (Megatron's layout of Mamba: the same bytes a member, no
activation resharded). ``shard`` and ``gather`` read it, so every caller
(init, EF rows, moments, the compressed all-reduce's gathered leaf, the
gathered params) gets the reference's whole leaf back, column for column.
Where ``2 d_inner`` divides over ``model`` and ``d_inner`` does not, the
rules hold every other ``d_inner`` leaf whole, and the member holds
``in_proj`` whole too: the block runs whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import all_gather
from repro_torch.launch.mesh import Mesh, data_axes

Spec = Tuple

# name -> (tp_dim, fsdp_dim), negative indices into the *unstacked* trailing
# dims. None = do not shard that role.
_RULES: Dict[str, Tuple[Optional[int], Optional[int]]] = {
    "embed": (-2, -1),        # (V, d)
    "lm_head": (-1, -2),      # (d, V)
    "pos_embed": (None, None),
    "wq": (-1, -2), "wk": (-1, -2), "wv": (-1, -2), "wo": (-2, -1),
    "w_gate": (-1, -2), "w_up": (-1, -2), "w_down": (-2, -1),
    "b_up": (-1, None), "b_down": (None, None),
    "router": (None, None),
    "shared_gate": (-1, -2), "shared_up": (-1, -2), "shared_down": (-2, -1),
    # mamba
    "in_proj": (-1, -2), "conv_w": (-1, None), "conv_b": (-1, None),
    "x_proj": (-2, -1), "dt_proj": (-1, -2), "dt_bias": (-1, None),
    "A_log": (-2, None), "D": (-1, None), "out_proj": (-2, -1),
    # rg-lru
    "in_x": (-1, -2), "in_gate": (-1, -2), "w_a": (-1, -2), "w_i": (-1, -2),
    "b_a": (-1, None), "b_i": (-1, None), "Lambda": (-1, None),
    # norms / scalars
    "scale": (None, None), "bias": (None, None),
    "gate_attn": (None, None), "gate_mlp": (None, None),
}

# MoE expert stacks: leaf names match w_gate/w_up/w_down but with a leading
# expert dim in the trailing-3 position -> tp on the expert axis instead.
_MOE_EXPERT_NAMES = {"w_gate": (-3, -2), "w_up": (-3, -2), "w_down": (-3, -1)}


class _Halves(str):
    """A spec entry equal to ``"model"`` (it is the axis's name) on a dim
    of two halves side by side: a member's block is its block of each
    half, joined."""


HALVES = _Halves("model")


def data_entry(mesh: Mesh):
    """The spec entry of the data axes: one axis as its name, several as a
    tuple (as ``PartitionSpec`` normalizes them)."""
    dp = data_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def _leaf_name(path: str) -> str:
    return path.split("/")[-1]


def _in_moe_subtree(path: str) -> bool:
    # expert stacks live under blocks/mlp with 3 trailing dims
    return "mlp" in path.split("/")[:-1]


def is_expert_stack(path: str, shape, cfg: ModelConfig) -> bool:
    """Whether ``path`` is an MoE expert stack (its expert dim is the one
    the ``model`` axis splits)."""
    return bool(_leaf_name(path) in _MOE_EXPERT_NAMES and cfg.n_experts
                and _in_moe_subtree(path) and len(shape) >= 3)


def held_spec(spec: Spec, path: str, shape, mesh: Mesh) -> Spec:
    """The spec a member holds the leaf at ``path`` (of full ``shape``) by,
    from its reference-layout ``spec``: ``spec`` itself, but on mamba's
    ``in_proj``, whose ``model`` entry is ``HALVES`` where each half
    divides over ``model`` and dropped (the leaf whole) where only the
    whole dim does."""
    if _leaf_name(path) != "in_proj" or "model" not in spec:
        return spec
    dim = spec.index("model")
    whole = (shape[dim] // 2) % mesh.n("model") != 0
    return tuple(a if i != dim else None if whole else HALVES
                 for i, a in enumerate(spec))


def param_spec(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
               mesh: Mesh, *, fsdp: bool) -> Spec:
    """The spec of one param leaf (``path`` its ``/``-joined key)."""
    name = _leaf_name(path)
    ndim = len(shape)
    rule = _RULES.get(name)
    if is_expert_stack(path, shape, cfg):
        rule = _MOE_EXPERT_NAMES[name]
    # attention head-boundary rule: sharding q/k/v/o across model is only
    # clean when whole heads land on each member
    msize = mesh.shape["model"]
    if name in ("wq", "wo") and cfg.n_heads and cfg.n_heads % msize != 0:
        rule = (None, rule[1] if rule else None)
    if name in ("wk", "wv") and cfg.n_kv_heads and cfg.n_kv_heads % msize != 0:
        rule = (None, rule[1] if rule else None)
    spec = [None] * ndim
    if rule is None:
        return tuple(spec)
    tp_dim, fsdp_dim = rule

    def place(dim: Optional[int], axis) -> None:
        if dim is None:
            return
        idx = ndim + dim  # negative from the end
        if idx < 0 or idx >= ndim:
            return
        if shape[idx] % mesh.n(axis) == 0 and spec[idx] is None:
            spec[idx] = axis

    place(tp_dim, "model")
    if fsdp:
        place(fsdp_dim, data_entry(mesh))
    return tuple(spec)


def param_shardings(cfg: ModelConfig, params: Dict, mesh: Mesh, *,
                    fsdp: bool = False) -> Dict[str, Spec]:
    """The spec of every leaf of ``params`` (anything with ``.shape``)."""
    return {k: param_spec(k, tuple(p.shape), cfg, mesh, fsdp=fsdp)
            for k, p in params.items()}


def stacked_client_shardings(cfg: ModelConfig, params: Dict,
                             mesh: Mesh) -> Dict[str, Spec]:
    """localsgd mode: the leading client axis over the data axes; the
    per-client param keeps its TP spec."""
    dp = data_entry(mesh)
    return {k: (dp,) + param_spec(k, tuple(p.shape)[1:], cfg, mesh,
                                  fsdp=False)
            for k, p in params.items()}


def batch_splits(rows: int, mesh: Mesh) -> bool:
    """Whether a global batch of ``rows`` rows splits over the data axes
    (``batch_shardings``); where it does not, every member holds it
    whole."""
    return rows > 0 and rows % mesh.n(data_entry(mesh)) == 0


def batch_shardings(batch: Dict, mesh: Mesh) -> Dict[str, Spec]:
    """Dim 0 (the batch) over the data axes; replicated if indivisible."""
    dp = data_entry(mesh)

    def leaf(x):
        nd = len(x.shape)
        if nd >= 1 and batch_splits(x.shape[0], mesh):
            return (dp,) + (None,) * (nd - 1)
        return (None,) * nd
    return {k: leaf(x) for k, x in batch.items()}


def cache_shardings(cfg: ModelConfig, cache, mesh: Mesh, batch: int):
    """Decode caches (the reference's pytrees: nested dicts, lists and
    tuples): the batch dim over the data axes when divisible, the last
    kv-head / feature dim over ``model`` when divisible (never head_dim)."""
    dp = data_entry(mesh)
    n = mesh.n(dp)
    msize = mesh.shape["model"]
    feature_sizes = {s for s in (cfg.n_kv_heads, cfg.d_inner, cfg.lru_width)
                     if s and s % msize == 0}

    def leaf(x):
        shape = tuple(x.shape)
        spec = [None] * len(shape)
        for i, s in enumerate(shape):
            if s == batch and batch % n == 0:
                spec[i] = dp
                break
        for i in range(len(shape) - 1, 0, -1):
            if spec[i] is None and shape[i] in feature_sizes:
                spec[i] = "model"
                break
        return tuple(spec)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return leaf(t)
    return walk(cache)


def replicated(ndim: int = 0) -> Spec:
    return (None,) * ndim


def shard_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of a member's block of a ``shape`` leaf under ``spec``."""
    return tuple(s if a is None else s // mesh.n(a)
                 for s, a in zip(shape, spec))


def shard(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This member's block of the full tensor ``x`` under ``spec``, as a
    tensor of its own (the full one can be freed)."""
    out = x
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n = mesh.n(axes)
        if n > 1:
            i = mesh.index(axes)
            if isinstance(axes, _Halves):
                half = x.shape[dim] // 2
                size = half // n
                out = torch.cat([out.narrow(dim, i * size, size),
                                 out.narrow(dim, half + i * size, size)],
                                dim=dim)
            else:
                size = x.shape[dim] // n
                out = out.narrow(dim, i * size, size)
    return out.clone() if out is not x else x


def gather(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every member's block ``x`` under ``spec``."""
    for dim, axes in enumerate(spec):
        if axes is not None and mesh.n(axes) > 1:
            blocks = list(all_gather(x, mesh, axes))
            if isinstance(axes, _Halves):
                halves = [b.chunk(2, dim=dim) for b in blocks]
                blocks = [h[0] for h in halves] + [h[1] for h in halves]
            x = torch.cat(blocks, dim=dim)
    return x
