"""Sparsification operators on one tensor (paper §II.A), port of
``repro/core/compression/sparsify.py``.

All operators return ``(g_sparse, mask)``: the mask-selected values embedded
densely, in the input's dtype, and the bool mask. Bit accounting lives in
``coding.py``. They run on the device of the tensor they are given and draw
from the port's threefry keys.

The top-K selections rank as ``lax.top_k`` does: by the bit pattern of
``|g|`` (NaN above +inf, denormals as values), ties to the lower index, so
the masks are the reference's bit for bit. A K-th largest key comes from
``torch.topk``'s values (which are the same whatever order it returns), and
the ties at it are filled from the lowest index up.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import random as trandom

_INT_OF = {2: torch.int16, 4: torch.int32, 8: torch.int64}


# ---------------------------------------------------------------------------
# Random (unbiased) sparsification: Wangni et al. [18], eqs. (11)-(14)
# ---------------------------------------------------------------------------
def _variance_budget(lam: torch.Tensor, absg: torch.Tensor) -> torch.Tensor:
    """sum g_i^2 / p_i with p_i = min(lam*|g_i|, 1)."""
    nz = absg > 0  # zero coords contribute nothing
    p = torch.where(nz, torch.clamp_max(lam * absg, 1.0), 1.0)
    return torch.where(nz, absg * absg / p, 0.0).sum()


def random_sparsify(key, g: torch.Tensor, eps: float = 1.0,
                    n_bisect: int = 40) -> Tuple[torch.Tensor, torch.Tensor]:
    """P1 solution: p_i = min(lam*|g_i|, 1) with lam chosen by bisection so
    that Var <= (1+eps) * ||g||^2 (eq. 13). Unbiased: E[out] = g."""
    p = _keep_probability(g, eps, n_bisect)
    keep = trandom.uniform_below(key, p)
    p_safe = torch.clamp_min_(p, 1e-30).to(g.dtype)
    out = torch.where(keep, g / p_safe, 0.0)
    return out.to(g.dtype), keep


def _keep_probability(g: torch.Tensor, eps: float = 1.0,
                      n_bisect: int = 40) -> torch.Tensor:
    """:func:`random_sparsify`'s float32 p_i (0 where g_i = 0), its
    variance budget met. The bisection stays on the device (no host sync a
    step)."""
    absg = g.to(torch.float32).abs()
    sq = torch.sum(absg * absg)
    target = (1.0 + eps) * sq

    # Var(lam) is monotone decreasing; bracket lam in [lo, hi]
    lo = 1.0 / (absg.max() + 1e-30)       # p_max = 1 -> most aggressive
    hi = torch.sum(absg) / (sq + 1e-30) * 4.0 + lo
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        # if the variance is still too high, lam must grow
        high = _variance_budget(mid, absg) > target
        lo, hi = torch.where(high, mid, lo), torch.where(high, hi, mid)
    lam = hi  # guaranteed to satisfy the budget
    return torch.where(absg > 0, torch.clamp_max(lam * absg, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Top-K / Rand-K / R-top-K: eqs. (18)-(19), [23]
# ---------------------------------------------------------------------------
def _order_key(g: torch.Tensor) -> torch.Tensor:
    """Flat ``|g|`` as integers in ``lax.top_k``'s order: the bit pattern of
    a non-negative float grows with its value, and NaN's lies above
    +inf's."""
    absg = g.reshape(-1).abs()
    key = absg.view(_INT_OF[absg.element_size()])
    return key.to(torch.int32) if key.dtype == torch.int16 else key


def _top_mask(key: torch.Tensor, k: int) -> torch.Tensor:
    """Bool mask of the ``k`` largest entries of the 1-D ``key``, ties to
    the lower index."""
    n = key.numel()
    if not 0 <= k <= n:
        raise ValueError(f"top-k needs 0 <= k <= {n}, got k={k}")
    if k == 0:
        return torch.zeros(n, dtype=torch.bool, device=key.device)
    kth = torch.topk(key, k, sorted=False).values.min()
    above = key > kth
    tie = key == kth
    room = k - above.sum()
    count = torch.int32 if n < 2 ** 31 else torch.int64
    return above | (tie & (torch.cumsum(tie, 0, dtype=count) <= room))


def _top_k_indices(g: torch.Tensor, k: int) -> torch.Tensor:
    """The flat indices of ``lax.top_k(|g|, k)``: largest first, ties by
    the lower index."""
    key = _order_key(g)
    idx = torch.nonzero(_top_mask(key, k)).squeeze(1)
    return idx[torch.sort(key[idx], descending=True, stable=True).indices]


def _mask_at(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    mask = torch.zeros(like.numel(), dtype=torch.bool, device=like.device)
    mask[idx] = True
    return mask.reshape(like.shape)


def topk_mask(g: torch.Tensor, k: int) -> torch.Tensor:
    """S_top(|g|, K) as a boolean mask (eq. 18)."""
    return _top_mask(_order_key(g), k).reshape(g.shape)


def topk_sparsify(g: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = topk_mask(g, k)
    return torch.where(m, g, 0), m


def _choice(key, n: int, k: int) -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False)``: the first ``k``
    of ``permutation(key, n)``."""
    if k > n:
        raise ValueError(f"Cannot take a larger sample (size {k}) than "
                         f"population (size {n}) when 'replace=False'")
    return trandom.permutation(key, n)[:k]


def randk_sparsify(key, g: torch.Tensor, k: int, unbiased: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniformly random K-mask (eq. 19); optional d/K unbiasing scale [22]
    (a scalar of g's dtype, as the reference's weak-typed ``d / k``)."""
    d = g.numel()
    mask = _mask_at(_choice(key, d, k), g)
    out = torch.where(mask, g, 0)
    if unbiased:
        out = out * torch.tensor(d / k, dtype=g.dtype, device=g.device)
    return out.to(g.dtype), mask


def rtopk_sparsify(key, g: torch.Tensor, r: int, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """R-top-K [23]: restrict to the top-R coordinates, keep K of them at
    random (better compression, less bias than pure rand-K)."""
    assert r >= k, "need R >= K"
    idx = _top_k_indices(g, r)[_choice(key, r, k)]
    mask = _mask_at(idx, g)
    return torch.where(mask, g, 0), mask


# ---------------------------------------------------------------------------
# Synchronous sparse parameter averaging: eqs. (15)-(17)
# ---------------------------------------------------------------------------
def synchronous_mask_cycle(d: int, k: int, t: int,
                           device=None) -> torch.Tensor:
    """Identical-across-devices mask M_t cycling through all coordinates.

    Deterministic round-robin partition: coordinate i is sampled every
    ceil(d/k) iterations, so the eq. (17) constraint holds with
    tau_max = ceil(d/k).
    """
    period = -(-d // k)
    start = (t % period) * k
    idx = (start + torch.arange(k, device=device)) % d
    mask = torch.zeros(d, dtype=torch.bool, device=device)
    mask[idx] = True
    return mask


def sync_sparse_period(d: int, k: int) -> int:
    """tau_max guaranteed by synchronous_mask_cycle."""
    return -(-d // k)
