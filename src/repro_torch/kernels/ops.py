"""Compression APIs over the CUDA kernels, the port of ``repro/kernels/ops.py``.

Each call runs the hand-written CUDA kernel for CUDA tensors and its plain
PyTorch version for CPU tensors: the device of the operands is the mode (the
reference's ``interpret=`` and ``mode=`` choose among JAX's execution modes,
which have no counterpart here). No padding is made; the kernels mask ragged
rows themselves.

* Row APIs (``topk_rows``, ``qsgd_rows``, ``sign_ef_rows``): one row is one
  client's D-dim message, the engine's client pass.
* Whole-tensor APIs (``block_topk``, ``qsgd_quantize``, ``sign_ef_compress``):
  one gradient of any shape in float32 or bf16, compressed per 1024-wide row
  of its flattened elements, the same shape out.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import random as trandom
from repro_torch.kernels import qsgd, sign_ef, topk_mask

COLS = 1024      # row width of the whole-tensor APIs
ROWS_ALIGN = 8   # the reference pads to whole (8, 1024) tiles


def topk_rows(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row threshold-bisection top-k with keep budget ``k``."""
    return topk_mask.topk_rows(x, k)


def qsgd_rows(x: torch.Tensor, u: torch.Tensor,
              levels: torch.Tensor) -> torch.Tensor:
    """Per-row QSGD with per-row L2 norms; ``u`` is the caller's (B, D)
    stochastic-rounding noise from per-client keys. On a card one launch
    computes the norms and quantizes; on the CPU the norms come from
    ``torch.linalg.vector_norm``."""
    if x.device.type != "cpu":
        return qsgd.qsgd_rows(x, u, None, levels)
    norms = torch.linalg.vector_norm(x.to(torch.float32), dim=1, keepdim=True)
    return qsgd.qsgd_rows(x, u, norms, levels)


def sign_ef_rows(x: torch.Tensor, e: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused per-row scaled sign + EF: ``c = mean|x+e| * sign(x+e)``,
    ``e' = (x+e) - c``. Returns (c, e') in float32."""
    return sign_ef.sign_ef_rows(x.to(torch.float32).contiguous(),
                                e.to(torch.float32).contiguous())


def block_topk(x: torch.Tensor, k_frac: float = 0.01) -> torch.Tensor:
    """Keep about ``k_frac`` of the entries of every 1024-element block (phi
    in eq. 10): ``k = max(1, int(k_frac * 1024))`` per block. Returns x's
    shape and type."""
    k = max(1, int(k_frac * COLS))
    return topk_mask.block_topk_tiles(x.contiguous(), k, COLS)


def qsgd_quantize(key: torch.Tensor, x: torch.Tensor, levels: int = 256
                  ) -> torch.Tensor:
    """Unbiased stochastic uniform quantization of ``x`` (eqs. 24-25) against
    its global L2 norm. The dither is ``uniform(key)`` over the reference's
    padded tile shape ``(ceil(n / 8192) * 8, 1024)``, so the same key gives
    the reference's bits. Returns x's shape and type."""
    n = x.numel()
    rows = -(-n // (COLS * ROWS_ALIGN)) * ROWS_ALIGN
    u = trandom.uniform(key.to(x.device), (rows, COLS))
    norm = torch.linalg.vector_norm(x.to(torch.float32).reshape(-1))
    return qsgd.qsgd_tiles(x.contiguous(), u, norm, levels)


def sign_ef_compress(x: torch.Tensor, e: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``c = blockscale * sign(x + e)``, ``e' = (x + e) - c`` per
    1024-element block; ``e`` is float32 (or cast to it) and x-shaped.
    Returns (c, e') with x's shape, in float32."""
    return sign_ef.sign_ef_tiles(x.contiguous(),
                                 e.to(torch.float32).contiguous(), COLS)
