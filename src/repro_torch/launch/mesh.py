"""The local mesh of the port's trainer: one card (``repro/launch/mesh.py``'s
``make_local_mesh``, ``data_axes`` and ``n_data_shards``).

A mesh here names its axes and their sizes and holds no devices: the
trainer's state lives on the device of its init key. Meshes of more than
one member (and the production meshes) run across cards: ROADMAP queue A
item 5.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class LocalMesh(NamedTuple):
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]


def make_local_mesh(data: int = 1, model: int = 1) -> LocalMesh:
    """The (data, model) mesh of one card."""
    if (data, model) != (1, 1):
        raise NotImplementedError(
            f"a ({data}, {model}) mesh spans several cards: ROADMAP queue A "
            f"item 5 (the port's trainer runs on one card)")
    return LocalMesh(("data", "model"), {"data": 1, "model": 1})


def data_axes(mesh: LocalMesh) -> tuple:
    """The batch/client axes: ("pod", "data") on a multi-pod mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def n_data_shards(mesh: LocalMesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n
