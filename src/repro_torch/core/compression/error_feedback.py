"""Per-client error-feedback state of the fleet engine (paper §II.A.4):
``c_t = comp(x_t + e_t)``, ``e_{t+1} = (x_t + e_t) - c_t``.

The dense state is an (N, D) matrix (float32 or bfloat16). :class:`SparseEF`
keeps only each row's top-``S`` residual entries as (value, index) pairs,
O(N * S) memory for the top-k compressor family; the truncation is per row,
so it is exactly chunk-invariant.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SparseEF(NamedTuple):
    """Top-S sparse EF state: per row, S (value, index) pairs."""
    values: torch.Tensor   # (N, S) state dtype (float32 or bfloat16)
    indices: torch.Tensor  # (N, S) int64 coordinates into the D-dim message


def init_sparse_error(n: int, d: int, slots: int, dtype=torch.float32,
                      device=None) -> SparseEF:
    if not 1 <= slots <= d:
        raise ValueError(f"sparse EF needs 1 <= slots <= d, got "
                         f"slots={slots}, d={d}")
    return SparseEF(torch.zeros((n, slots), dtype=dtype, device=device),
                    torch.zeros((n, slots), dtype=torch.int64, device=device))


def densify_rows(ef: SparseEF, d: int) -> torch.Tensor:
    """(N, S) sparse EF -> dense (N, D) float32."""
    out = torch.zeros((ef.values.shape[0], d), dtype=torch.float32,
                      device=ef.values.device)
    return out.scatter_(1, ef.indices, ef.values.to(torch.float32))


def sparsify_rows(resid: torch.Tensor, slots: int, dtype=torch.float32
                  ) -> SparseEF:
    """Dense (N, D) residual -> the top-|.| (N, S) sparse EF of each row,
    largest first and ties by lower index (the order of ``lax.top_k``)."""
    r = resid.to(torch.float32)
    idx = torch.argsort(-r.abs(), dim=1, stable=True)[:, :slots]
    return SparseEF(torch.gather(r, 1, idx).to(dtype), idx)
