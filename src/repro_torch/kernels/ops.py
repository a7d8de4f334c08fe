"""Row-batched compression APIs of the engine's client pass (one row = one
client's D-dim message), the port of ``repro/kernels/ops.py``'s row APIs.

Each call runs the hand-written CUDA kernel for CUDA tensors and its plain
PyTorch version for CPU tensors: the device of the operands is the mode. No
padding is needed; the kernels mask ragged rows themselves.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import qsgd, sign_ef, topk_mask


def topk_rows(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row threshold-bisection top-k with keep budget ``k``."""
    return topk_mask.topk_rows(x, k)


def qsgd_rows(x: torch.Tensor, u: torch.Tensor,
              levels: torch.Tensor) -> torch.Tensor:
    """Per-row QSGD with per-row L2 norms; ``u`` is the caller's (B, D)
    stochastic-rounding noise from per-client keys."""
    levels = torch.clamp_min(
        torch.as_tensor(levels, dtype=torch.float32, device=x.device), 1.0)
    norms = torch.linalg.vector_norm(x.to(torch.float32), dim=1, keepdim=True)
    return qsgd.qsgd_rows(x, u, norms, levels)


def sign_ef_rows(x: torch.Tensor, e: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused per-row scaled sign + EF: ``c = mean|x+e| * sign(x+e)``,
    ``e' = (x+e) - c``. Returns (c, e') in float32."""
    return sign_ef.sign_ef_rows(x.to(torch.float32).contiguous(),
                                e.to(torch.float32).contiguous())
