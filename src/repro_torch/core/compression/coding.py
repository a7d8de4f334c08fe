"""Sparse position coding (paper §II.A.5, Alg. 4) and bit accounting, port
of ``repro/core/compression/coding.py``: the bit-level encoder and decoder
and the analytic costs (Python and numpy, copied), their traced twins
(``sparse_bits_jax``, ``elias_gamma_bits_jax``) on float32 tensors, and the
finite-field codec of secure aggregation (``field_scale``, ``to_field``,
``from_field``).

Block position coding: a sparse vector of dimension d at sparsity level
phi = nnz/d is split into blocks of size 1/phi; each non-zero costs
1 + log2(1/phi) bits (flag + intra-block offset) and each block costs one
end-of-block bit -> total = nnz*(1 + log2(1/phi)) + phi*d bits.

The small epsilon of the twins protects ``ceil``/``floor`` of float32
``log2`` at exact powers of two (``log2(16.)`` may come out as 4.0000002).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch


def _block_size(d: int, nnz: int) -> int:
    """1/phi rounded up to a power of two (so offsets are whole bits)."""
    phi = max(nnz, 1) / d
    return 1 << max(0, math.ceil(math.log2(1.0 / phi)))


def encode_positions(indices: Sequence[int], d: int) -> Tuple[str, int]:
    """Alg. 4 encoder. Returns (bitstring, block_size).

    Per block: for each non-zero inside, '1' + offset bits; then '0' to close
    the block. Indices must be sorted & unique.
    """
    idx = sorted(set(int(i) for i in indices))
    assert all(0 <= i < d for i in idx), "index out of range"
    bs = _block_size(d, len(idx))
    off_bits = int(math.log2(bs))
    n_blocks = -(-d // bs)
    bits: List[str] = []
    ptr = 0
    for b in range(n_blocks):
        lo, hi = b * bs, (b + 1) * bs
        while ptr < len(idx) and lo <= idx[ptr] < hi:
            bits.append("1")
            bits.append(format(idx[ptr] - lo, f"0{off_bits}b") if off_bits else "")
            ptr += 1
        bits.append("0")  # end-of-block
    return "".join(bits), bs


def decode_positions(bitstring: str, d: int, block_size: int) -> List[int]:
    """Alg. 4 decoder (pointer walk)."""
    off_bits = int(math.log2(block_size))
    out: List[int] = []
    block_index = 0
    pointer = 0
    n = len(bitstring)
    while pointer < n:
        if bitstring[pointer] == "0":
            block_index += 1
            pointer += 1
        else:
            pointer += 1
            off = int(bitstring[pointer:pointer + off_bits], 2) if off_bits else 0
            out.append(block_size * block_index + off)
            pointer += off_bits
    return out


def sparse_message_bits(d: int, nnz: int, value_bits: float = 32.0) -> float:
    """Analytic total bits for one sparse message under Alg. 4 coding."""
    if nnz == 0:
        return 0.0
    bs = _block_size(d, nnz)
    n_blocks = -(-d // bs)
    return nnz * (1 + math.log2(bs) + value_bits) + n_blocks


def naive_sparse_bits(d: int, nnz: int, value_bits: float = 32.0) -> float:
    """log2(d) bits per index (the baseline Alg. 4 improves on)."""
    return nnz * (math.ceil(math.log2(max(d, 2))) + value_bits)


def elias_gamma_bits(gaps: Sequence[int]) -> float:
    """Analytic Elias-gamma cost of encoding index gaps [30]."""
    return float(sum(2 * math.floor(math.log2(g)) + 1 for g in gaps if g >= 1))


def mask_to_indices(mask: np.ndarray) -> np.ndarray:
    return np.nonzero(np.asarray(mask).reshape(-1))[0]


# ---------------------------------------------------------------------------
# Traced twins: the same analytic formulas on float32 tensors
# ---------------------------------------------------------------------------

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
