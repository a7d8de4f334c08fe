"""Chunk-invariant reductions and per-client randomness for the fleet engine.

The chunked client pass processes clients in power-of-two blocks of
``chunk_size`` so that peak temporary memory is O(chunk * D), and it must be
*bitwise* equal to the unchunked pass. A plain ``sum`` cannot promise that:
the reduction order of an (N, D) operand and of its (chunk, D) slices may
differ, and float addition is not associative.

``canonical_sum`` folds adjacent row pairs of the zero-padded (to a power of
two) operand, ``log2`` times: the left-complete binary tree over rows. Aligned
blocks of any power-of-two size are subtrees of it, so summing per-block
canonical sums canonically gives the full sum bit for bit. Padded and masked
rows are ``+0.0`` (selected, never multiplied by zero: ``-x * 0.0`` is
``-0.0``, which is not a neutral element bitwise).

``client_keys`` gives each client ``fold_in(key, client_id)``, which depends
only on the pair and not on the batch, unlike ``split(key, n)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import random as trandom


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n <= 0:
        raise ValueError(f"pow2_ceil needs n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def canonical_sum(x: torch.Tensor, valid: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Sum over dim 0 through the canonical adjacent-fold tree. ``valid``: an
    optional (N,) mask; rows where it is 0 are selected to ``+0.0``."""
    if valid is not None:
        keep = (valid != 0).reshape((-1,) + (1,) * (x.dim() - 1))
        x = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
    n = x.shape[0]
    if n == 0:
        raise ValueError("canonical_sum needs at least one row")
    p = pow2_ceil(n)
    if p != n:
        x = torch.cat([x, x.new_zeros((p - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


class CanonicalFold:
    """``canonical_sum`` over a stack of block partials, fed one partial at a
    time: adjacent pairs merge as soon as both exist (a binary counter), and
    ``total`` pads with ``+0.0`` leaves to a power of two as
    ``canonical_sum`` pads its rows. Bitwise ``canonical_sum(stack(parts))``,
    with at most ``log2(m) + 1`` partials alive instead of all ``m``."""

    def __init__(self):
        self._stack = []  # (level, partial), levels strictly decreasing
        self._count = 0

    def add(self, x: torch.Tensor) -> None:
        level = 0
        while self._stack and self._stack[-1][0] == level:
            x = self._stack.pop()[1] + x
            level += 1
        self._stack.append((level, x))
        self._count += 1

    def total(self) -> torch.Tensor:
        if not self._count:
            raise ValueError("canonical_sum needs at least one row")
        zero = torch.zeros_like(self._stack[-1][1])
        for _ in range(pow2_ceil(self._count) - self._count):
            self.add(zero)
        return self._stack[0][1]


def canonical_mean(x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``canonical_sum / count``; ``count`` defaults to N (or the mask sum),
    floored at one so an empty selection gives zeros, not NaN."""
    if count is None:
        count = (torch.tensor(float(x.shape[0]), device=x.device)
                 if valid is None else valid.to(torch.float32).sum())
    return canonical_sum(x, valid) / torch.clamp_min(count, 1.0)


def client_keys(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Chunk-invariant per-client keys: ``fold_in(key, id)`` per row,
    ``(n, 2)`` for ``(n,)`` ids."""
    return trandom.fold_in(key, ids)


def block_ids(block: int, chunk: int, device=None) -> torch.Tensor:
    """Global client ids covered by block index ``block``."""
    return block * chunk + torch.arange(chunk, dtype=torch.int64,
                                        device=device)


def n_blocks(n: int, chunk: int) -> int:
    """Number of chunk-sized blocks covering n clients; validates chunk."""
    if not is_pow2(chunk):
        raise ValueError(f"chunk_size must be a power of two, got {chunk}")
    return -(-n // chunk)
