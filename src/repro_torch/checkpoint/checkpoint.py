"""Flat-key npz checkpointing, the port of ``repro/checkpoint/checkpoint.py``
in the same format: one ``ckpt_%08d.npz`` a step, keyed by ``/``-joined
tree paths (a dict by its keys, a NamedTuple such as ``OptState`` by its
field names, a list or tuple by index; ``None`` holds no leaf), bf16 stored
as float32. The port's flat params already carry ``/``-joined keys, so a
checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

Tree = Any


def _items(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs of ``tree`` in the reference's order: dict keys
    sorted, NamedTuple fields and sequence entries in order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix[:-1], tree
        return
    for k, v in items:
        yield from _items(v, f"{prefix}{k}/")


def _array(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    arr = np.asarray(leaf)
    return arr if arr.dtype.kind in "fiub" else arr.astype(np.float32)


def save_checkpoint(directory: str, step: int, tree: Tree) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    flat: Dict[str, np.ndarray] = {k: _array(v) for k, v in _items(tree)}
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _rebuild(like: Tree, data, prefix: str = "") -> Tree:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, data, f"{prefix}{k}/") for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, data, f"{prefix}{f}/")
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, data, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    key = prefix[:-1]
    arr = data[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: {arr.shape} vs {tuple(like.shape)}")
    return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)


def load_checkpoint(directory: str, step: int, like: Tree) -> Tree:
    """Restore into the structure of ``like`` (shape checked; each leaf
    takes ``like``'s dtype and device)."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        return _rebuild(like, data)
