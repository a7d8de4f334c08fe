"""Decentralized consensus topology (paper §I.B, eqs. 7-8), port of
``repro/core/topology.py``.

Mixing matrices W built from graph Laplacians; convergence speed is governed
by the spectral gap 1 - |lambda_2(W)|.

Two layers, mirroring ``core/wireless.py``:

* numpy builders/diagnostics, copied from the reference: host-side graph
  construction. A W built here is a per-run input of the gossip engine
  (``fl/decentralized.py``), so a grid of topologies is one more sweep axis
  of one engine.
* torch twins (``laplacian_mixing_jax``, ``metropolis_hastings_mixing_jax``,
  ``gate_mixing_jax``), the same math on adjacency / availability tensors on
  the engine's device: the fog hybrid derives its intra-cluster D2D graph
  from its deployment, and time-varying graphs renormalize W under the churn
  mask every round.
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Adjacency builders
# ---------------------------------------------------------------------------
def ring(n: int) -> np.ndarray:
    a = np.zeros((n, n))
    for i in range(n):
        a[i, (i + 1) % n] = a[i, (i - 1) % n] = 1
    if n == 2:
        a = np.minimum(a, 1)
    np.fill_diagonal(a, 0)
    return a


def torus_2d(rows: int, cols: int) -> np.ndarray:
    n = rows * cols
    a = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                if j != i:
                    a[i, j] = 1
    return a


def complete(n: int) -> np.ndarray:
    a = np.ones((n, n))
    np.fill_diagonal(a, 0)
    return a


def star(n: int) -> np.ndarray:
    a = np.zeros((n, n))
    a[0, 1:] = a[1:, 0] = 1
    return a


def is_connected(adj: np.ndarray) -> bool:
    """BFS reachability from node 0 (edges where ``adj > 0``)."""
    a = np.asarray(adj) > 0
    n = a.shape[0]
    reached = np.zeros(n, dtype=bool)
    reached[0] = True
    frontier = reached.copy()
    while frontier.any():
        frontier = a[frontier].any(axis=0) & ~reached
        reached |= frontier
    return bool(reached.all())


def erdos_renyi(seed: int, n: int, p: float) -> np.ndarray:
    """Connected ER graph: overlays a ring *only if* the G(n, p) draw is
    disconnected. (The overlay used to be unconditional, which silently
    forced every node's degree >= 2 and changed the degree distribution of
    every draw, not just the disconnected ones.)"""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < p).astype(float)
    a = np.triu(a, 1)
    a = a + a.T
    if not is_connected(a):
        a = np.maximum(a, ring(n))
    return a


def standard_adjacencies(n: int, seed: int = 0, p: float = 0.3):
    """Name -> adjacency for the standard topology grid at size ``n`` (the
    sweep axis of ``run_gossip_sweep(wgrid=)``): ring, 2-D torus (square
    ``n`` only), complete, and a connected ER draw."""
    adjs = {"ring": ring(n)}
    side = int(round(np.sqrt(n)))
    if side * side == n and side >= 2:
        adjs["torus"] = torus_2d(side, side)
    adjs["complete"] = complete(n)
    adjs["erdos_renyi"] = erdos_renyi(seed, n, p)
    return adjs


# ---------------------------------------------------------------------------
# Mixing matrices
# ---------------------------------------------------------------------------
def laplacian_mixing(adj: np.ndarray) -> np.ndarray:
    """Eq. (8): W = I - (D - A) / (d_max + 1). Symmetric, doubly stochastic."""
    deg = adj.sum(axis=1)
    d_max = deg.max()
    lap = np.diag(deg) - adj
    return np.eye(adj.shape[0]) - lap / (d_max + 1.0)


def metropolis_hastings_mixing(adj: np.ndarray) -> np.ndarray:
    """Degree-aware alternative: W_ij = 1/(1+max(d_i,d_j)) for edges."""
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    w = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if adj[i, j]:
                w[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        w[i, i] = 1.0 - w[i].sum()
    return w


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------
def is_doubly_stochastic(w: np.ndarray, tol: float = 1e-8) -> bool:
    return (np.allclose(w.sum(0), 1, atol=tol)
            and np.allclose(w.sum(1), 1, atol=tol) and (w >= -tol).all())


def _abs_eigvals_desc(w: np.ndarray) -> np.ndarray:
    """|eigenvalues| of a symmetric mixing matrix, descending. ``eigvalsh``
    (not ``eigvals``): both mixing builders return symmetric W, and the
    symmetric solver is exact-real — the general solver's spurious
    ~1e-16 imaginary parts used to flow into |lambda_2|."""
    sym = 0.5 * (w + w.T)
    return np.sort(np.abs(np.linalg.eigvalsh(sym)))[::-1]


def spectral_gap(w: np.ndarray) -> float:
    """1 - |lambda_2|; larger gap -> faster consensus."""
    ev = _abs_eigvals_desc(w)
    return float(1.0 - ev[1]) if len(ev) > 1 else 1.0


def consensus_rounds(w: np.ndarray, eps: float = 1e-3) -> float:
    """Rounds for consensus error eps: ~ log(eps)/log(|lambda_2|)."""
    ev = _abs_eigvals_desc(w)
    lam2 = ev[1] if len(ev) > 1 else 0.0
    if lam2 <= 0:
        return 1.0
    return float(np.log(eps) / np.log(lam2))


# ---------------------------------------------------------------------------
# torch twins (the engine's path: adjacency / availability on the device)
# ---------------------------------------------------------------------------
def laplacian_mixing_jax(adj: torch.Tensor) -> torch.Tensor:
    """Eq. (8) on an adjacency tensor: W = I - (D - A) / (d_max + 1), the
    math of :func:`laplacian_mixing` in float32 on ``adj``'s device (the
    fog engine builds its intra-cluster mixing matrix from its
    deployment)."""
    a = adj.to(torch.float32)
    deg = a.sum(dim=1)
    lap = torch.diag(deg) - a
    return (torch.eye(a.shape[0], dtype=torch.float32, device=a.device)
            - lap / (deg.max() + 1.0))


def metropolis_hastings_mixing_jax(adj: torch.Tensor) -> torch.Tensor:
    """Degree-aware twin of :func:`metropolis_hastings_mixing`: W_ij =
    1/(1+max(d_i, d_j)) on edges, the diagonal absorbs the leftover row
    mass."""
    a = adj.to(torch.float32)
    deg = a.sum(dim=1)
    w = a / (1.0 + torch.maximum(deg[:, None], deg[None, :]))
    return w + torch.diag(1.0 - w.sum(dim=1))


def gate_mixing_jax(w: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """Effective mixing matrix under a node-availability mask (time-varying
    graphs): edges touching an offline node are cut and their weight folds
    back into *both* endpoint diagonals, so W_eff stays symmetric-doubly-
    stochastic whenever W is. An isolated (offline) node's row becomes
    exactly one-hot (its diagonal is ``1 - sum(0) == 1.0``), so it keeps its
    own model bitwise through the consensus product."""
    a = avail.to(w.dtype)
    off = w * (a[:, None] * a[None, :])
    off = off - torch.diag(torch.diagonal(off))
    return off + torch.diag(1.0 - off.sum(dim=1))
