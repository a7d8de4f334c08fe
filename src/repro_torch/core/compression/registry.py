"""Compression registry of the engine: nine operators by name, their
parameters as float32 scalar tensors, and their data-independent bit costs.

Port of ``repro/core/compression/registry.py``. Every operator here works on
a batch of client rows, ``(cparams, keys (B, 2), rows (B, D)) -> (compressed
(B, D), bits (B,))``; ``keys`` are per-client keys (``fold_in(key, id)``), so
row i never depends on which rows share its batch. :func:`get_compressor`
gives the one-message form ``(cparams, key, flat (D,))`` of the reference.

Above ``KERNEL_DISPATCH_MIN_ELEMS`` elements in the whole client pass (N * D,
never the block size, so chunked and unchunked runs take the same path) the
kernel-backed operators (topk, qsgd, scaled_sign) go through
``repro_torch.kernels.ops``: the CUDA kernels for CUDA tensors, their plain
versions on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch import random as trandom
from repro_torch.core.compression.coding import sparse_bits_jax

LOG2_3 = 1.584962500721156  # ternary alphabet cost, log2(3)
SCALE_BITS = 32.0           # one fp32 scale / norm per message
_INV_LN2 = 1.4426950216293335  # float32(1 / ln 2)


class CompressionParams(NamedTuple):
    """Compressor parameters as float32 scalar tensors: ``k`` the kept-
    coordinate budget (topk/randk/rtopk), ``levels`` the QSGD levels,
    ``block`` the blockwise-scaled-sign block length."""
    k: torch.Tensor
    levels: torch.Tensor
    block: torch.Tensor

    def to(self, device) -> "CompressionParams":
        return CompressionParams(*(f.to(device) for f in self))


def compression_params(k: float = 1.0, levels: float = 256.0,
                       block: float = 4096.0, device=None
                       ) -> CompressionParams:
    return CompressionParams(
        *(torch.tensor(float(v), dtype=torch.float32, device=device)
          for v in (k, levels, block)))


def default_compression_params(d: int, device=None) -> CompressionParams:
    """1% top-k, 8-bit QSGD, block min(4096, d)."""
    return compression_params(k=max(1, d // 100), levels=256.0,
                              block=min(4096.0, float(d)), device=device)


def stack_compression_params(ps) -> CompressionParams:
    """Stack params along a leading variant axis."""
    ps = list(ps)
    return CompressionParams(*(torch.stack([getattr(p, f) for p in ps])
                               for f in CompressionParams._fields))


RowsFn = Callable[[CompressionParams, torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


def _nnz(k: torch.Tensor, d: int) -> torch.Tensor:
    """Kept-coordinate count for a (possibly fractional) budget."""
    return torch.clamp(torch.ceil(k), 1.0, float(d))


def _rank(score: torch.Tensor) -> torch.Tensor:
    """Dense descending rank per row (0 = best); ties break by index."""
    order = torch.argsort(-score, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _per_row(value: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return value.to(torch.float32).expand(rows.shape[0])


def _const_bits(bits: float, rows: torch.Tensor) -> torch.Tensor:
    return torch.full((rows.shape[0],), bits, dtype=torch.float32,
                      device=rows.device)


# ---------------------------------------------------------------------------
# Operators over client rows (B, D): dense reconstruction + bits per row
# ---------------------------------------------------------------------------
def _none(cp, keys, x):
    return x, _const_bits(SCALE_BITS * x.shape[1], x)


def _sign(cp, keys, x):
    return torch.sign(x), _const_bits(float(x.shape[1]), x)


def _scaled_sign(cp, keys, x):
    scale = x.abs().mean(dim=1, keepdim=True)
    return scale * torch.sign(x), _const_bits(x.shape[1] + SCALE_BITS, x)


def _blockwise_scaled_sign(cp, keys, x):
    d = x.shape[1]
    block = torch.clamp(cp.block, 1.0, float(d))
    bid = torch.floor(torch.arange(d, dtype=torch.float32, device=x.device)
                      / block).to(torch.int64)
    l1 = x.new_zeros(x.shape).index_add_(1, bid, x.abs())
    cnt = x.new_zeros(d).index_add_(0, bid, x.new_ones(d))
    scale = l1 / torch.clamp_min(cnt, 1.0)
    bits = d + SCALE_BITS * torch.ceil(d / block)
    return scale[:, bid] * torch.sign(x), _per_row(bits, x)


def _ternary(cp, keys, x):
    gmax = x.abs().amax(dim=1, keepdim=True)
    p = x.abs() / torch.clamp_min(gmax, 1e-30)
    b = trandom.uniform(keys, (x.shape[1],)) < p
    return (gmax * torch.sign(x) * b.to(torch.float32),
            _const_bits(LOG2_3 * x.shape[1] + SCALE_BITS, x))


def _qsgd(cp, keys, x):
    levels = torch.clamp_min(cp.levels, 1.0)
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    t = x.abs() / torch.clamp_min(norm, 1e-30) * levels
    lower = torch.floor(t)
    up = trandom.uniform(keys, (x.shape[1],)) < (t - lower)
    q = (lower + up.to(torch.float32)) / levels
    return torch.sign(x) * q * norm, _per_row(uplink_bits_jax("qsgd", cp,
                                                              x.shape[1]), x)


def _topk(cp, keys, x):
    nnz = _nnz(cp.k, x.shape[1])
    mask = _rank(x.abs()) < nnz
    return (torch.where(mask, x, torch.zeros_like(x)),
            _per_row(sparse_bits_jax(x.shape[1], nnz), x))


def _randk(cp, keys, x):
    nnz = _nnz(cp.k, x.shape[1])
    mask = _rank(trandom.uniform(keys, (x.shape[1],))) < nnz
    return (torch.where(mask, x, torch.zeros_like(x)),
            _per_row(sparse_bits_jax(x.shape[1], nnz), x))


def _rtopk(cp, keys, x):
    """R-top-K [23] with R = min(4K, d): random K of the top-R coords."""
    d = x.shape[1]
    nnz = _nnz(cp.k, d)
    r = torch.clamp_max(4.0 * nnz, float(d))
    eligible = _rank(x.abs()) < r
    score = torch.where(eligible, trandom.uniform(keys, (d,)),
                        torch.full_like(x, -torch.inf))
    mask = _rank(score) < nnz
    return (torch.where(mask, x, torch.zeros_like(x)),
            _per_row(sparse_bits_jax(d, nnz), x))


_REGISTRY: Dict[str, RowsFn] = {
    "none": _none,
    "qsgd": _qsgd,
    "ternary": _ternary,
    "sign": _sign,
    "scaled_sign": _scaled_sign,
    "blockwise_scaled_sign": _blockwise_scaled_sign,
    "topk": _topk,
    "randk": _randk,
    "rtopk": _rtopk,
}


def _rows_op(name: str) -> RowsFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown compressor {name!r}; "
                         f"known: {sorted(_REGISTRY)}") from None


def get_compressor(name: str) -> Callable:
    """One-message form ``(cparams, key (2,), flat (D,)) -> (compressed (D,),
    bits ())`` of a registry operator."""
    op = _rows_op(name)

    def one(cp, key, flat):
        c, bits = op(cp, key[None], flat[None])
        return c[0], bits[0]

    return one


def compressor_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


# ---------------------------------------------------------------------------
# Batched row compression + kernel dispatch
# ---------------------------------------------------------------------------
KERNEL_DISPATCH_MIN_ELEMS = 1 << 20
_KERNEL_BACKED = ("topk", "qsgd", "scaled_sign")


def kernel_dispatch(name: str, total_elems: int) -> bool:
    """Does this operator run on the kernel row path for a client pass of
    ``total_elems`` = N * D elements?"""
    return name in _KERNEL_BACKED and total_elems >= KERNEL_DISPATCH_MIN_ELEMS


def rows_compressor(name: str, total_elems: int = 0) -> RowsFn:
    """Batched compressor over client rows; kernel-backed operators go to
    ``repro_torch.kernels.ops`` when :func:`kernel_dispatch` fires."""
    op = _rows_op(name)
    if not kernel_dispatch(name, total_elems):
        return op
    from repro_torch.kernels import ops as kernel_ops

    if name == "topk":
        def rows_fn(cp, keys, rows):
            d = rows.shape[1]
            nnz = _nnz(cp.k, d)
            return (kernel_ops.topk_rows(rows, nnz),
                    _per_row(sparse_bits_jax(d, nnz), rows))
    elif name == "qsgd":
        def rows_fn(cp, keys, rows):
            u = trandom.uniform(keys, (rows.shape[1],))
            return (kernel_ops.qsgd_rows(rows, u, cp.levels),
                    _per_row(uplink_bits_jax("qsgd", cp, rows.shape[1]),
                             rows))
    else:  # scaled_sign (the EF-fused variant lives in fl_round)
        def rows_fn(cp, keys, rows):
            comp, _ = kernel_ops.sign_ef_rows(rows, torch.zeros_like(rows))
            return comp, _const_bits(rows.shape[1] + SCALE_BITS, rows)
    return rows_fn


def uplink_bits_jax(name: str, cp: CompressionParams, d: int) -> torch.Tensor:
    """Bits on the wire for one d-dimensional message (data-independent, so
    it equals the ``bits`` the operator itself returns)."""
    dev = cp.k.device
    if name == "none":
        return torch.tensor(SCALE_BITS * d, dtype=torch.float32, device=dev)
    if name == "sign":
        return torch.tensor(float(d), dtype=torch.float32, device=dev)
    if name == "scaled_sign":
        return torch.tensor(d + SCALE_BITS, dtype=torch.float32, device=dev)
    if name == "blockwise_scaled_sign":
        block = torch.clamp(cp.block, 1.0, float(d))
        return d + SCALE_BITS * torch.ceil(d / block)
    if name == "ternary":
        return (torch.tensor(LOG2_3 * d, dtype=torch.float32, device=dev)
                + SCALE_BITS)
    if name == "qsgd":
        # as the reference's compiled programs price it: log2 as log times
        # float32(1 / ln 2), both multiply-adds contracted into FMAs (each
        # product is exact in float64, so only the final rounding remains)
        levels = torch.clamp_min(cp.levels, 1.0)
        rate = (torch.log(levels + 1.0).double() * _INV_LN2 + 1.0).float()
        return (rate.double() * d + SCALE_BITS).float()
    if name in ("topk", "randk", "rtopk"):
        return sparse_bits_jax(d, _nnz(cp.k, d))
    raise ValueError(f"unknown compressor {name!r}; "
                     f"known: {sorted(_REGISTRY)}")
