"""Quantization operators on one tensor (paper §II.B), port of
``repro/core/compression/quantize.py``.

Every operator returns ``(dequantized_value, bits_per_element)``: the dense
reconstruction the PS would compute, in the input's dtype, and the bit cost
as a Python float. Unbiased: qsgd, ternary. Biased (use with error
feedback): sign, scaled_sign, blockwise_scaled_sign. They run on the device
of the tensor they are given; the dithers are the port's threefry draws
(``uniform(key, shape)``), so a key gives the reference's bits.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import random as trandom


def _norm(x: torch.Tensor) -> torch.Tensor:
    """float32 L2 norm of all of ``x``, the root correctly rounded (PyTorch's
    float32 CPU sqrt is an ulp low on some inputs)."""
    return torch.sqrt(torch.sum(x * x).double()).to(torch.float32)


_TINY = torch.finfo(torch.float32).tiny


def _sign(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 sign: +-1, a zero of x's sign for +-0 and for denormals
    (XLA treats them as zeros), NaN for NaN; ``torch.sign`` gives +0 for
    all of those but the denormals."""
    return torch.where(x.abs() >= _TINY, torch.sign(x), x * 0.0)


def _recip(n: int) -> float:
    """float32 ``1 / n``. XLA divides by a compile-time constant (QSGD's
    static ``levels``, a mean's count) as a multiply by this reciprocal."""
    return float(torch.tensor(1.0 / n, dtype=torch.float32))


# ---------------------------------------------------------------------------
# QSGD: stochastic uniform quantization, eqs. (24)-(25) [30],[32]
# ---------------------------------------------------------------------------
def qsgd(key, u: torch.Tensor, levels: int = 256
         ) -> Tuple[torch.Tensor, float]:
    """L equal sub-intervals of [0,1]; round each |u_i|/||u|| stochastically
    to a boundary of its sub-interval. Unbiased."""
    uf = u.to(torch.float32)
    norm = _norm(uf)
    x = uf.abs().div_(torch.clamp_min(norm, 1e-30)).mul_(levels)
    lower = torch.floor(x)
    up = trandom.uniform_below(key, x.sub_(lower))
    del x
    q = lower.add_(up).mul_(_recip(levels))
    out = _sign(uf).mul_(q).mul_(norm)
    bits = math.log2(levels + 1) + 1  # level index + sign (norm amortized)
    return out.to(u.dtype), bits


# ---------------------------------------------------------------------------
# TernGrad: eqs. (26)-(28) [40]
# ---------------------------------------------------------------------------
def ternary(key, g: torch.Tensor) -> Tuple[torch.Tensor, float]:
    gf = g.to(torch.float32)
    gmax = gf.abs().max()
    b = trandom.uniform_below(key, gf.abs().div_(torch.clamp_min(gmax,
                                                                 1e-30)))
    out = _sign(gf).mul_(gmax).mul_(b)
    return out.to(g.dtype), math.log2(3)


# ---------------------------------------------------------------------------
# SignSGD: Alg. 5 [36]
# ---------------------------------------------------------------------------
def sign_compress(g: torch.Tensor) -> Tuple[torch.Tensor, float]:
    return _sign(g.to(torch.float32)).to(g.dtype), 1.0


# ---------------------------------------------------------------------------
# Scaled sign: eq. (29) [38]; delta-approximate compressor (eq. 30)
# ---------------------------------------------------------------------------
def scaled_sign(g: torch.Tensor) -> Tuple[torch.Tensor, float]:
    gf = g.to(torch.float32)
    scale = torch.sum(gf.abs()).mul_(_recip(gf.numel()))
    return _sign(gf).mul_(scale).to(g.dtype), 1.0


def blockwise_scaled_sign(g: torch.Tensor, block: int = 4096
                          ) -> Tuple[torch.Tensor, float]:
    """Block-wise scaled sign [39]: per-block L1 scale captures layer/block
    magnitude variation, reducing quantization error. The padding of the
    last block is left out of its scale."""
    flat = g.reshape(-1).to(torch.float32)
    d = flat.numel()
    n_blocks = -(-d // block)
    blocks = F.pad(flat, (0, n_blocks * block - d)).view(n_blocks, block)
    count = torch.full((n_blocks,), float(block), dtype=torch.float32,
                       device=g.device)
    count[-1] = max(d - (n_blocks - 1) * block, 1)
    scale = blocks.abs().sum(dim=1).div_(count)
    out = _sign(blocks).mul_(scale[:, None])
    return (out.view(-1)[:d].reshape(g.shape).to(g.dtype),
            1.0 + 32.0 / block)


def delta_of_scaled_sign(g: torch.Tensor) -> torch.Tensor:
    """Empirical delta such that ||Q(g)-g||^2 <= (1-delta)||g||^2 (eq. 30):
    delta = ||g||_1^2 / (d * ||g||_2^2)."""
    gf = g.to(torch.float32).reshape(-1)
    l1 = torch.sum(gf.abs())
    l2sq = torch.sum(gf * gf)
    return l1 * l1 / (gf.numel() * torch.clamp_min(l2sq, 1e-30))
