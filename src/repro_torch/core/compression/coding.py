"""Bit-cost accounting of sparse messages (paper Alg. 4), the traced twins of
``repro/core/compression/coding.py`` (``sparse_bits_jax``,
``elias_gamma_bits_jax``) on float32 tensors.

The small epsilon protects ``ceil``/``floor`` of float32 ``log2`` at exact
powers of two (``log2(16.)`` may come out as 4.0000002).
"""
from __future__ import annotations

import torch

_LOG2_EPS = 1e-6


def sparse_bits_jax(d: int, nnz, value_bits: float = 32.0) -> torch.Tensor:
    """Alg. 4 block coding of ``nnz`` kept coordinates out of ``d`` (``nnz``
    may be fractional); ``nnz == 0`` costs 0 bits."""
    nnz = torch.as_tensor(nnz, dtype=torch.float32)
    safe = torch.clamp_min(nnz, 1.0)
    log_bs = torch.clamp_min(torch.ceil(torch.log2(d / safe) - _LOG2_EPS), 0.0)
    bs = torch.exp2(log_bs)
    n_blocks = torch.ceil(d / bs - _LOG2_EPS)
    bits = safe * (1.0 + log_bs + value_bits) + n_blocks
    return torch.where(nnz > 0, bits, torch.zeros_like(bits))


def elias_gamma_bits_jax(gaps) -> torch.Tensor:
    """Elias-gamma cost of index gaps [30]; gaps below one cost nothing."""
    g = torch.as_tensor(gaps, dtype=torch.float32)
    cost = 2.0 * torch.floor(torch.log2(torch.clamp_min(g, 1.0))
                             + _LOG2_EPS) + 1.0
    return torch.where(g >= 1.0, cost, torch.zeros_like(cost)).sum()
