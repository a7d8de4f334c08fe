"""Error feedback (paper §II.A.4, Alg. 3 & 6):
``c_t = comp(x_t + e_t)``, ``e_{t+1} = (x_t + e_t) - c_t``.

The fleet engine's per-client state is an (N, D) matrix (float32 or
bfloat16). :class:`SparseEF` keeps only each row's top-``S`` residual
entries as (value, index) pairs, O(N * S) memory for the top-k compressor
family; the truncation is per row, so it is exactly chunk-invariant.

The tree API (:func:`ef_compress`, :func:`tree_ef_compress`) wraps any
compressor ``comp(x) -> (compressed, meta)`` leaf by leaf over a gradient
tree: a flat ``/``-keyed dict of tensors, as the port's parameters are, or
nested dicts, lists and tuples of them. Leaves are visited in
``jax.tree.leaves`` order (dict keys sorted) and the structure is kept. The
error state is float32 whatever the leaf's dtype.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, NamedTuple, Tuple

import torch

Compressor = Callable[[torch.Tensor], Tuple[torch.Tensor, Any]]


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


# ---------------------------------------------------------------------------
# The tree API over one gradient (leaf-wise EF)
# ---------------------------------------------------------------------------
def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _rebuild(tree: Any, leaves: Iterator[torch.Tensor]) -> Any:
    """``tree``'s structure with its leaves taken from ``leaves`` in
    :func:`_leaves` order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(v, leaves) for v in tree]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return None if tree is None else next(leaves)


def init_error_state(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x, dtype=torch.float32)


_TINY = torch.finfo(torch.float32).tiny


def _flush(x: torch.Tensor) -> torch.Tensor:
    """float32 denormals to zeros of their sign (a fresh tensor)."""
    return x * (x.abs() >= _TINY)


def ef_compress(comp: Compressor, x: torch.Tensor, e: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Returns (compressed, new_error, meta). The add and the subtract
    flush float32 denormals, inputs and results, as the reference's XLA
    does (denormals-are-zero and flush-to-zero)."""
    corrected = _flush(_flush(x.to(torch.float32)).add_(_flush(e)))
    c, meta = comp(corrected.to(x.dtype))
    e_new = _flush(corrected.sub_(_flush(c.to(torch.float32))))
    return c, e_new, meta


def tree_init_error(tree: Any) -> Any:
    return _rebuild(tree, map(init_error_state, _leaves(tree)))


def tree_ef_compress(comp: Compressor, tree: Any, e_tree: Any
                     ) -> Tuple[Any, Any]:
    """Leaf-wise EF over a gradient tree. Returns (compressed_tree, new_e)."""
    outs, errs = [], []
    for x, e in zip(_leaves(tree), _leaves(e_tree)):
        c, e_new, _ = ef_compress(comp, x, e)
        outs.append(c)
        errs.append(e_new)
    return _rebuild(tree, iter(outs)), _rebuild(tree, iter(errs))


def is_k_contraction(comp: Compressor, x: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """Check Def. 1 (eq. 22): E||x - comp(x)||^2 <= (1 - k/d) ||x||^2.

    Returns the boolean for one realization (property tests average over
    seeds for randomized compressors).
    """
    c, _ = comp(x)
    xf = x.to(torch.float32)
    lhs = torch.sum((xf - c.to(torch.float32)) ** 2)
    rhs = (1.0 - k / x.numel()) * torch.sum(xf ** 2)
    return lhs <= rhs + 1e-5 * torch.clamp_min(rhs, 1.0)
