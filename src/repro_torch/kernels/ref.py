"""Plain oracles of the tile kernels, port of ``repro/kernels/ref.py``: on
``(rows, cols)`` tensors, written from the paper's definitions rather than
from the kernels, so that a test on a card can hold a kernel against them
without JAX."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def block_topk_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Row-wise top-k keep, exact via sort: every entry at least as large in
    magnitude as the row's k-th largest (ties may keep more than k)."""
    absx = x.abs()
    kth = torch.sort(absx, dim=1).values[:, -k][:, None]
    return torch.where(absx >= kth, x, torch.zeros_like(x))


def block_topk_threshold_ref(x: torch.Tensor, k: int, n_iter: int = 24
                             ) -> torch.Tensor:
    """Bisection-threshold top-k, the kernels' selection rule."""
    absx = x.abs()
    hi = absx.amax(dim=1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        take_hi = (absx >= mid).sum(dim=1, keepdim=True) > k
        lo, hi = torch.where(take_hi, mid, lo), torch.where(take_hi, hi, mid)
    return torch.where(absx >= lo, x, torch.zeros_like(x))


def topk_adversarial(rows: int, d: int, seed: int = 0) -> np.ndarray:
    """(rows, d) float32 rows that stress the top-k kernels' selection, one
    kind per row in turn: normal draws; halves of them rounded (ties at every
    threshold); constant; one NaN; one +inf; one -inf; signed zeros;
    denormals; 100 (or all) equal maxima over small values, more candidates
    than a warp row's 64-slot buffer holds."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    kind = np.arange(rows) % 9
    col = np.arange(rows) % d
    x[kind == 1] = np.round(2 * x[kind == 1]) / 2
    x[kind == 2] = 2.5
    for kd, val in ((3, np.nan), (4, np.inf), (5, -np.inf)):
        x[kind == kd, col[kind == kd]] = val
    x[kind == 6] = np.where(np.arange(d) % 2, -0.0, 0.0).astype(np.float32)
    x[kind == 7] = x[kind == 7] * np.float32(1e-40)
    tops = np.where(np.arange(min(d, 100)) % 2, -5.0, 5.0)
    x[kind == 8] = 0.01 * x[kind == 8]
    x[np.ix_(kind == 8, np.arange(min(d, 100)))] = tops
    return x


def qsgd_ref(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor,
             levels: int) -> torch.Tensor:
    """Stochastic uniform quantization (eqs. 24-25) with noise u ~ U[0, 1)
    and one norm; returns x's type."""
    xf = x.to(torch.float32)
    lv = torch.tensor(float(levels), dtype=torch.float32, device=x.device)
    scaled = xf.abs() / torch.clamp_min(norm, 1e-30) * lv
    lower = torch.floor(scaled)
    q = (lower + (u < scaled - lower).to(torch.float32)) / lv
    return (torch.sign(xf) * q * norm).to(x.dtype)


def sign_ef_ref(x: torch.Tensor, e: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise scaled sign + error update with a per-row L1 scale
    (blockwise scaled sign [39]); returns (c, e') in float32."""
    corrected = x.to(torch.float32) + e
    scale = corrected.abs().mean(dim=1, keepdim=True)
    c = scale * torch.sign(corrected)
    return c, corrected - c
