"""Plain oracles of the tile kernels, port of ``repro/kernels/ref.py``: on
``(rows, cols)`` tensors, written from the paper's definitions rather than
from the kernels, so that a test on a card can hold a kernel against them
without JAX. Also the row norms in the summation order of QSGD's row
kernel (``lane_order_norms``), and adversarial rows for top-k."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.nn.functional import pad


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


GROUP_MAX = 1024   # threads of the widest row group (csrc/warp_rows.cuh)
ROW_THREADS = 512  # threads of a block-per-row kernel (csrc/rows.cu)


def _xor_tree(s: torch.Tensor) -> torch.Tensor:
    """The sum over the last dimension (a power of two) in the order of xor
    shuffles at offsets n/2 down to 1: its first and second halves are
    added, until one value is left."""
    n = s.shape[-1]
    while n > 1:
        n //= 2
        s = s[..., :n] + s[..., n:2 * n]
    return s[..., 0]


def _lane_sums(sq: torch.Tensor, lanes: int) -> torch.Tensor:
    """(rows, lanes): lane l's sum of columns l, l + lanes, ... in order."""
    rows, d = sq.shape
    per = -(-d // lanes)
    sq = pad(sq, (0, per * lanes - d)).reshape(rows, per, lanes)
    s = sq[:, 0]
    for j in range(1, per):
        s = s + sq[:, j]
    return s


def _pow2ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def row_vals(d: int) -> int:
    """Values a thread of a row group holds (``warp_rows.cuh::row_vals``)."""
    return 4 if d % 4 == 0 and d > 64 else 2 if d % 2 == 0 else 1


def lane_order_norms(x: torch.Tensor) -> torch.Tensor:
    """Each row's L2 norm of float32 ``(rows, d)`` x, as QSGD's row kernel
    (``csrc/rows.cu``) computes it with no norms given: squares rounded
    apart from the sums, summed in the order of the kernel's layout for d,
    then the IEEE square root. Returns ``(rows, 1)``.

    * a row group (G = pow2ceil(d / V) <= 1024 threads, V = ``row_vals``):
      thread q sums the squares of columns Vq..Vq+V-1 in order; up to 32
      threads meet by xor shuffles at offsets G/2 down to 1; more meet so
      within each warp, then the G / 32 warp sums meet by xor shuffles at
      offsets G/64 down to 1;
    * wider rows (a 512-thread block a row): thread t sums columns t,
      t + 512, ... in order; each warp's 32 sums meet by xor shuffles, then
      the 16 warps' sums, padded to 32 with zeros, likewise.
    """
    rows, d = x.shape
    sq = x * x
    v = row_vals(d)
    g = _pow2ceil(-(-d // v))
    if g <= GROUP_MAX:
        q = sq.reshape(rows, d // v, v)
        s = q[..., 0]
        for j in range(1, v):
            s = s + q[..., j]
        s = pad(s, (0, g - s.shape[1]))
        if g > 32:
            s = _xor_tree(s.reshape(rows, g // 32, 32))
        total = _xor_tree(s)
    else:
        warps = _xor_tree(_lane_sums(sq, ROW_THREADS).reshape(rows, -1, 32))
        total = _xor_tree(pad(warps, (0, 32 - warps.shape[1])))
    return torch.sqrt(total).reshape(rows, 1)


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
