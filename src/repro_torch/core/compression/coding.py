"""Bit-cost accounting of sparse messages (paper Alg. 4), the traced twins of
``repro/core/compression/coding.py`` (``sparse_bits_jax``,
``elias_gamma_bits_jax``) on float32 tensors, and the finite-field codec of
secure aggregation (``field_scale``, ``to_field``, ``from_field``).

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


# ---------------------------------------------------------------------------
# Finite-field fixed-point codec (secure aggregation, core/privacy)
# ---------------------------------------------------------------------------
# Pairwise masks cancel exactly only in modular arithmetic, so masked sums
# live in Z_{2^32}. A field element is an int64 tensor holding a value in
# [0, 2^32): the uint32 word of the reference (PyTorch on the CPU cannot add
# uint32). Sums of elements stay exact in int64 and are reduced with
# ``& FIELD_MASK``. A sum of m encodings decodes exactly while
# m * 2^(field_bits-1) < 2^31.
FIELD_MASK = 0xFFFFFFFF
_SIGN = 0x80000000


def field_scale(clip, field_bits) -> torch.Tensor:
    """Fixed-point scale: the clip value maps to ``2^(field_bits-1) - 1``."""
    clip = torch.as_tensor(clip, dtype=torch.float32)
    fb = torch.as_tensor(field_bits, dtype=torch.float32)
    return (torch.exp2(fb - 1.0) - 1.0) / torch.clamp_min(clip, 1e-30)


def to_field(x: torch.Tensor, clip, field_bits) -> torch.Tensor:
    """Clamp ``x`` to ``[-clip, clip]`` and encode as field elements
    (symmetric fixed point; negative values wrap to the top of the ring)."""
    clip = torch.as_tensor(clip, dtype=torch.float32, device=x.device)
    s = field_scale(clip, field_bits)
    q = torch.round(torch.clamp(x.to(torch.float32), -clip, clip) * s)
    return q.to(torch.int32).to(torch.int64) & FIELD_MASK


def from_field(q: torch.Tensor, clip, field_bits) -> torch.Tensor:
    """Decode field elements (or modular sums of them) back to float32,
    taking the centered representative in ``[-2^31, 2^31)``."""
    # the scale on q's device: CUDA divides by a CPU scalar as a multiply
    # by its reciprocal, which is not the IEEE quotient
    s = field_scale(clip, field_bits).to(q.device)
    centered = ((q & FIELD_MASK) ^ _SIGN) - _SIGN
    return centered.to(torch.float32) / s
