"""Mixture-of-Experts FFN with capacity-based dispatch (qwen2-moe, kimi-k2):
the auto-partitioned path of ``repro/models/moe.py``.

Dispatch is sort-free: positions-in-expert come from a cumsum over one-hot
assignments, token-major over the flattened (T*k) choices; choices beyond an
expert's capacity are dropped. The reference scatters with
``.add(mode="drop")`` and gathers with ``.get(mode="fill")``, which skip
the out-of-range slot ``cap``; here the buffers have ``cap + 1`` slots and
the last one is cut off before the experts run, and both moves are out of
place (``index_add`` / ``index_select``), so the block runs under
``torch.func.vmap`` and ``grad``. Each kept slot receives one token, so the
dispatch is exact whatever the order of the adds.

Expert stacks are padded up to a multiple of 16 (qwen 60 -> 64) while the
router keeps ``n_experts`` columns, so a padded expert is never chosen.
Top-k ties go to the lower expert index, as ``lax.top_k`` breaks them.

Expert parallelism (``moe_forward_ep``): the stacks' expert axis is split
over the mesh's ``model`` axis. The tokens are replicated over ``model``;
each member routes them to its own ``e_pad / n`` experts and adds its
(T, d) contribution, and the contributions are summed over ``model``. The
sum's backward passes the cotangent on unchanged, and the replicated
inputs' cotangents are summed over ``model``: so every member gets the
gradient of ``moe_forward``, as the reference's ``jax.grad`` through its
``shard_map`` gives (measured bitwise on model 2 and 4 of the reduced
qwen2-moe config). ``moe_forward`` takes this path while a mesh is named
(``models/tp.py::set_model_mesh``, called by the step builders). The shared
experts split over ``model`` as a dense MLP does, where their width
divides (``shared_gate`` / ``shared_up`` by column, ``shared_down`` by
row); their partial output joins the experts' before the one sum.

The whole batch as one capacity group (``routed_over``): where the
reference jits a step over its mesh and leaves the data split to XLA (its
prefill, decode and fsdp train steps), routing sees the global batch: the
capacity comes from the global token count and a choice's slot from one
cumsum over the global (T*k) choices, token by token. A member holds the
rows of its place along the data axes (``P(dp)``: contiguous, in rank
order), so its slots are its own cumsum plus the choices of each expert on
the lower-ranked members, from one all-gather of every member's (E_pad,)
int32 counts a layer. With ``aux`` the load-balance loss takes ``me`` and
``fe`` over the whole batch too (``me``'s mean through ``tp.mean_over``,
``fe`` from the gathered counts). The reference's pssgd and localsgd steps
``shard_map`` over the data axes and route a member's rows alone, as does
every call outside ``routed_over``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import all_gather
from repro_torch.models import tp
from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]

# (mesh, data axes, aux) while a step routes a member's rows as its part of
# the whole batch (``routed_over``); None -> the rows alone
_GROUP: Optional[tuple] = None


@contextlib.contextmanager
def routed_over(mesh, axes, *, aux: bool = False):
    """MoE layers run inside route this member's rows as its part of one
    capacity group over the members along ``axes`` of ``mesh`` (nothing
    changes with no mesh or on one member); ``aux``: the load-balance loss
    over the whole batch too (a train step's)."""
    global _GROUP
    prev = _GROUP
    _GROUP = (None if mesh is None or mesh.n(axes) == 1
              else (mesh, axes, aux))
    try:
        yield
    finally:
        _GROUP = prev


def padded_n_experts(cfg: ModelConfig, multiple: int = 16) -> int:
    e = cfg.n_experts
    return -(-e // multiple) * multiple


def init_moe_block(key, cfg: ModelConfig, dtype,
                   expert_pad_multiple: int = 16) -> Params:
    d, dff = cfg.d_model, cfg.d_ff_expert
    e_pad = padded_n_experts(cfg, expert_pad_multiple)
    keys = trandom.split(key, 8)

    def stack(k, shape, scale):
        return (trandom.normal(k, (e_pad,) + shape) * scale).to(dtype)

    p = {
        "router": dense_init(keys[0], (d, cfg.n_experts), torch.float32),
        "w_gate": stack(keys[1], (d, dff), d ** -0.5),
        "w_up": stack(keys[2], (d, dff), d ** -0.5),
        "w_down": stack(keys[3], (dff, d), dff ** -0.5),
    }
    if cfg.n_shared_experts:
        sd = cfg.n_shared_experts * dff
        p["shared_gate"] = dense_init(keys[4], (d, sd), dtype)
        p["shared_up"] = dense_init(keys[5], (d, sd), dtype)
        p["shared_down"] = dense_init(keys[6], (sd, d), dtype)
    return p


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens (the reference's formula)."""
    k = cfg.moe_top_k
    return int(max(k, -(-k * t // cfg.n_experts) * cfg.capacity_factor))


class Route(NamedTuple):
    top_p: torch.Tensor     # (T, k) renormalized router probabilities
    flat_e: torch.Tensor    # (T*k,) chosen experts, token-major
    flat_pos: torch.Tensor  # (T*k,) slot in the expert; ``cap`` if dropped
    overflow: torch.Tensor  # (T*k,) bool: past the expert's capacity
    aux: torch.Tensor       # () Switch-style load-balance loss
    cap: int


def route(p: Params, xf: torch.Tensor, cfg: ModelConfig,
          expert_pad_multiple: int = 16) -> Route:
    """Router, top-k, aux loss and positions for tokens xf (T, d): this
    member's rows of the whole batch inside ``routed_over``."""
    t = xf.shape[0]
    e_real, k = cfg.n_experts, cfg.moe_top_k
    e_pad = padded_n_experts(cfg, expert_pad_multiple)
    group = _GROUP
    n = 1 if group is None else group[0].n(group[1])
    cap = capacity(cfg, t * n)
    probs = torch.softmax(xf.to(torch.float32) @ p["router"], dim=-1)
    # lax.top_k: descending, ties to the lower index (a stable sort)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = vals[:, :k], idx[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    flat_e = top_e.reshape(t * k)
    onehot = (flat_e[:, None] == torch.arange(e_pad, device=xf.device)
              ).to(torch.int32)  # (T*k, E_pad)
    pos_all = torch.cumsum(onehot, dim=0) - 1
    flat_pos = (pos_all * onehot).sum(dim=-1)
    me = probs.mean(dim=0)
    if group is None:
        experts = torch.arange(e_real, device=xf.device)
        assign = (top_e[..., None] == experts).to(torch.float32)  # (T,k,E)
        fe = assign.sum(dim=1).mean(dim=0) / k
    else:   # the lower-ranked members' choices come first in each expert
        mesh, axes, whole_aux = group
        counts = all_gather(onehot.sum(dim=0, dtype=torch.int32), mesh,
                            axes)   # (n, E_pad)
        flat_pos = flat_pos + counts[:mesh.index(axes)].sum(dim=0)[flat_e]
        fe = counts.sum(dim=0)[:e_real].to(torch.float32) / (t * n) / k
        if whole_aux:
            me = tp.mean_over(me, mesh, axes)
    aux = e_real * (me * fe).sum()
    overflow = flat_pos >= cap
    flat_pos = torch.where(overflow, cap, flat_pos)
    return Route(top_p, flat_e, flat_pos, overflow, aux, cap)


def _act(cfg: ModelConfig):
    if cfg.mlp_type == "swiglu":
        return F.silu
    return lambda v: F.gelu(v, approximate="tanh")


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                expert_pad_multiple: int = 16
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d), aux_loss scalar)."""
    if tp.model_mesh() is not None:
        return moe_forward_ep(p, x, cfg, tp.model_mesh(),
                              expert_pad_multiple)
    bsz, s, d = x.shape
    t, k = bsz * s, cfg.moe_top_k
    e_pad = padded_n_experts(cfg, expert_pad_multiple)
    xf = x.reshape(t, d)
    r = route(p, xf, cfg, expert_pad_multiple)
    cap = r.cap

    # dispatch into (E_pad, cap + 1, d); slot cap collects the dropped
    # choices and is cut off
    slot = r.flat_e * (cap + 1) + r.flat_pos
    xk = xf.repeat_interleave(k, dim=0)  # (T*k, d), token-major
    buf = torch.zeros((e_pad * (cap + 1), d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, xk).reshape(e_pad, cap + 1, d)[:, :cap]

    act = _act(cfg)
    h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"])  # (E_pad, cap, d)

    # combine: gather back (the dropped slot reads zeros), weight, sum
    out_buf = F.pad(out_buf, (0, 0, 0, 1)).reshape(e_pad * (cap + 1), d)
    gathered = out_buf.index_select(0, slot)  # (T*k, d)
    w = (r.top_p.reshape(t * k) * (~r.overflow)).to(x.dtype)
    out = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)

    if cfg.n_shared_experts:
        hs = act(xf @ p["shared_gate"]) * (xf @ p["shared_up"])
        out = out + hs @ p["shared_down"]
    return out.reshape(bsz, s, d), r.aux


def local_experts(w: torch.Tensor, cfg: ModelConfig, mesh,
                  expert_pad_multiple: int = 16, axis: str = "model"
                  ) -> torch.Tensor:
    """This member's ``e_pad / n`` experts of a stack: ``w`` as it is if
    it holds only them, else its block of the full stack."""
    n = mesh.n(axis)
    e_local = padded_n_experts(cfg, expert_pad_multiple) // n
    if w.shape[0] == e_local:
        return w
    return w.narrow(0, mesh.index(axis) * e_local, e_local)


def moe_forward_ep(p: Params, x: torch.Tensor, cfg: ModelConfig, mesh,
                   expert_pad_multiple: int = 16, axis: str = "model"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_forward`` with the experts split over ``mesh``'s ``axis``: the
    stacks in ``p`` hold this member's experts (or all of them, and it
    takes its block). x: (B,S,d) -> (out (B,S,d), aux_loss scalar), the
    same on every member."""
    bsz, s, d = x.shape
    t, k = bsz * s, cfg.moe_top_k
    n = mesh.n(axis)
    e_pad = padded_n_experts(cfg, expert_pad_multiple)
    if e_pad % n:
        raise ValueError(f"{e_pad} experts do not split over {n} members")
    e_local = e_pad // n
    xf = x.reshape(t, d)
    r = route(p, xf, cfg, expert_pad_multiple)
    cap = r.cap
    weights = (r.top_p.reshape(t * k) * (~r.overflow)).to(x.dtype)
    wg, wu, wd = (local_experts(p[name], cfg, mesh, expert_pad_multiple,
                                axis) for name in ("w_gate", "w_up",
                                                   "w_down"))
    xf_in = tp.copy_to(xf, mesh, axis)
    weights = tp.copy_to(weights, mesh, axis)

    # this member's experts: the others' choices go to the dropped slot
    le = r.flat_e - mesh.index(axis) * e_local
    mine = (le >= 0) & (le < e_local) & (r.flat_pos < cap)
    le = torch.clamp(le, 0, e_local - 1)
    pos = torch.where(mine, r.flat_pos, cap)
    slot = le * (cap + 1) + pos
    xk = xf_in.repeat_interleave(k, dim=0)
    buf = torch.zeros((e_local * (cap + 1), d), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_add(0, slot, xk).reshape(e_local, cap + 1, d)[:, :cap]
    act = _act(cfg)
    h = act(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out_buf = torch.bmm(h, wd)
    out_buf = F.pad(out_buf, (0, 0, 0, 1)).reshape(e_local * (cap + 1), d)
    gathered = out_buf.index_select(0, slot)
    gathered = gathered * (weights * mine).to(gathered.dtype)[:, None]
    out = gathered.reshape(t, k, d).sum(dim=1)
    shared = cfg.n_shared_experts and split_shared(p, cfg)
    if shared:  # this member's columns of the shared experts, one sum
        hs = act(xf_in @ p["shared_gate"]) * (xf_in @ p["shared_up"])
        out = out + hs @ p["shared_down"]
    out = tp.sum_over(out, mesh, axis)

    if cfg.n_shared_experts and not shared:
        hs = act(xf @ p["shared_gate"]) * (xf @ p["shared_up"])
        out = out + hs @ p["shared_down"]
    return out.reshape(bsz, s, d), r.aux


def split_shared(p: Params, cfg: ModelConfig) -> bool:
    """Whether ``p`` holds a block of the shared experts' width."""
    width = cfg.n_shared_experts * cfg.d_ff_expert
    return p["shared_down"].shape[-2] != width
