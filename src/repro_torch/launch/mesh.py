"""Meshes of the port's trainer, the port of ``repro/launch/mesh.py``:
named axes over the members of a ``torch.distributed`` process group.

A member is one process. Rank r sits at the row-major coordinates of r
over the mesh's axes in order, as ``jax.make_mesh`` lays devices out, so
that a dim split over ``("pod", "data")`` gives member (p, d) the block
``p * n_data + d``, as ``P(("pod", "data"))`` does. A mesh of one member
needs no process group. A larger one, and any mesh made inside a group,
binds to the default group, whose world size it must equal (there is no
fallback to fewer members, and no member runs alone beside others), and
makes one group for each set of its axes that spans more than one member:
the ranks that share the other axes' coordinates. The production meshes
(``make_production_mesh``) describe a pod for the sharding rules and bind
to nothing.

Launch the members with ``torchrun --standalone --nproc-per-node N -m
repro_torch.launch.train ...`` or ``torch.multiprocessing.spawn`` after
``init_members`` (``launch/members.py``).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch.distributed as dist

Axes = Union[str, Tuple[str, ...]]


class Mesh:
    """Named axes over ``size`` members; ``coords`` is this member's place.

    ``shape`` maps each axis to its size. ``group(axes)``, ``n(axes)`` and
    ``index(axes)`` take one axis name or a tuple of them (row-major over
    the tuple, as a ``PartitionSpec`` entry reads)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 bind: bool = True):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self.size = math.prod(self.shape.values())
        self.bound = bind and (self.size > 1 or dist.is_initialized())
        self.rank = 0
        self._groups: Dict[Tuple[str, ...], object] = {}
        if self.bound:
            self._bind()
        self.coords = self.coords_of(self.rank)

    def _bind(self) -> None:
        if not dist.is_initialized():
            raise RuntimeError(
                f"a mesh of {self.size} members {self.shape} needs a "
                f"process group of {self.size} members: launch with "
                f"torchrun --nproc-per-node {self.size} (or spawn members "
                f"and call init_members)")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"the mesh {self.shape} has {self.size} members "
                             f"but the process group has {world}")
        self.rank = dist.get_rank()
        for r in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, r):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                if len(axes) == len(self.axis_names):
                    self._groups[axes] = dist.group.WORLD
                    continue
                # every rank makes every group, in one order
                others = [a for a in self.axis_names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in others)):
                    ranks = [rk for rk in range(self.size)
                             if all(self.coords_of(rk)[a] == v
                                    for a, v in zip(others, fixed))]
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def coords_of(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in the mesh {self.shape}")
        return axes

    def n(self, axes: Axes) -> int:
        """Members along ``axes``."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes: Axes) -> int:
        """This member's place along ``axes`` (row-major over a tuple)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Axes):
        """The process group over ``axes``; None for a single member."""
        axes = self._axes(axes)
        if self.n(axes) == 1:
            return None
        if not self.bound:
            raise RuntimeError(f"the mesh {self.shape} is a description "
                               "and has no process groups")
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh over the members of the default process group."""
    return Mesh(shape, axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, (16, 16) over ("data", "model") or
    (2, 16, 16) over ("pod", "data", "model"), as a description."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, bind=False)


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The (data, model) mesh of the process group's members."""
    return make_mesh((data, model), ("data", "model"))


def data_axes(mesh: Mesh) -> tuple:
    """The batch/client axes: ("pod", "data") on a multi-pod mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def n_data_shards(mesh: Mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def members_line(mesh: Optional[Mesh]) -> str:
    """One line naming the members and the backend, for a log."""
    if mesh is None or not mesh.bound:
        return "one member, no process group"
    return (f"{mesh.size} members {mesh.shape}, backend "
            f"{dist.get_backend()}")
