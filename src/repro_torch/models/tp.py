"""The ``model`` axis of a mesh inside the model: Megatron-style tensor
parallelism of the transformer, mamba and RG-LRU blocks and expert
parallelism of the MoE layer share these helpers.

The step builders (``launch/steps.py``, ``launch/specs.py``) name the mesh
(``set_model_mesh``); the layers read it. A member holds its block of each
leaf the ``model`` axis splits (``launch/sharding.py::held_spec``) and
the whole of every other, and a layer tells the two apart by the leaf's
shape against the config's width. The residual stream is replicated over
``model``: a region that computes with split leaves starts at ``copy_to``
(forward: the input as it is; backward: the members' partial cotangents
summed over ``model``) and ends at ``sum_over`` (forward: the members'
partial outputs summed; backward: the cotangent as it is). A whole leaf
used inside such a region (``wk`` / ``wv`` when the kv heads do not split
but the q heads do) goes through ``copy_to`` too, so that its gradient,
partial on each member, is summed. A split activation that a split
leaf's rows need whole (RG-LRU's ``xc`` before ``w_a`` / ``w_i``, split by
columns) goes through ``gather_from`` (forward: the members' blocks
joined along the last dim; backward: the cotangent summed over ``model``,
this member's block kept: a reduce-scatter).

On a ``model`` axis of one member (or with no mesh named) every helper
returns its input and adds no op. Sums take ``collectives.psum``'s order
(member by member from member 0), so every member gets the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives import (all_gather, psum,
                                          reduce_scatter_sum)

AXIS = "model"

_MESH = None  # named by the step builders; None -> one member


def set_model_mesh(mesh) -> None:
    """Name the mesh whose ``model`` axis the layers split over (None, or
    a mesh without one, names none). MoE layers route through
    ``moe_forward_ep`` while a mesh is named."""
    global _MESH
    _MESH = mesh if (mesh is not None and AXIS in mesh.axis_names) else None


def model_mesh():
    """The mesh named by ``set_model_mesh``, or None."""
    return _MESH


def n() -> int:
    """Members along ``model`` (1 with no mesh named)."""
    return 1 if _MESH is None else _MESH.n(AXIS)


def index() -> int:
    """This member's place along ``model``."""
    return 0 if _MESH is None else _MESH.index(AXIS)


class _SumOverAxis(torch.autograd.Function):
    """Forward: the sum over the axis's members; backward: the cotangent as
    it is (every member holds the same one)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MeanOverAxis(torch.autograd.Function):
    """Forward: the mean over the axis's members (``pmean``); backward: the
    cotangent as it is. For a mean over members that split the batch: the
    step's mean of the members' gradients supplies the 1 / n."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis) / mesh.n(axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToAxis(torch.autograd.Function):
    """Forward: a replicated input as it is; backward: the members'
    partial cotangents summed over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.mesh, ctx.axis), None, None


class _GatherFromAxis(torch.autograd.Function):
    """Forward: the members' blocks joined along the last dim; backward:
    the cotangent summed over the axis in ``psum``'s order, this member's
    block kept."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return torch.cat(list(all_gather(x.contiguous(), mesh, axis)),
                         dim=-1)

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.n(ctx.axis)
        blocks = g.reshape(*g.shape[:-1], n, g.shape[-1] // n).movedim(-2, 0)
        part = reduce_scatter_sum(
            blocks.reshape(n * g.shape[0], *blocks.shape[2:]), ctx.mesh,
            ctx.axis)
        return part.to(g.dtype), None, None


def sum_over(x: torch.Tensor, mesh=None, axis: str = AXIS) -> torch.Tensor:
    """The sum of the members' partial ``x`` over ``axis`` (the named
    mesh's ``model`` axis by default)."""
    mesh = _MESH if mesh is None else mesh
    if mesh is None or mesh.n(axis) == 1:
        return x
    return _SumOverAxis.apply(x, mesh, axis)


def mean_over(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The mean of the members' ``x`` over ``axis`` (e.g. the data axes,
    whose members hold the batch's rows), its cotangent passed on as it
    is (``_MeanOverAxis``)."""
    if mesh is None or mesh.n(axis) == 1:
        return x
    return _MeanOverAxis.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh=None, axis: str = AXIS) -> torch.Tensor:
    """A replicated ``x`` entering a split region (its gradient summed over
    ``axis``)."""
    mesh = _MESH if mesh is None else mesh
    if mesh is None or mesh.n(axis) == 1:
        return x
    return _CopyToAxis.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh=None,
                axis: str = AXIS) -> torch.Tensor:
    """The whole of an activation split over ``axis`` along its last dim,
    joined from every member's block (its gradient summed over ``axis``
    and cut back to this member's block)."""
    mesh = _MESH if mesh is None else mesh
    if mesh is None or mesh.n(axis) == 1:
        return x
    return _GatherFromAxis.apply(x, mesh, axis)


def max_over(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of the members' ``x`` over ``model``, detached
    (an all-gather of the small ``x``, then a max)."""
    x = x.detach()
    if n() == 1:
        return x
    return all_gather(x, _MESH, AXIS).amax(dim=0)


def gather_last(x: torch.Tensor, full: int) -> torch.Tensor:
    """The whole of a tensor split over ``model`` along its last dim (e.g.
    a member's logits over its block of the vocabulary); ``x`` as it is
    when its last dim is already ``full``."""
    return x if x.shape[-1] == full else gather_from(x)
