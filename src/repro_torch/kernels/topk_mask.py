"""Per-row threshold-bisection top-k (paper §II.A.3), CUDA kernel + plain twin.

Replaces ``repro/kernels/topk_mask.py::topk_rows_pallas`` (body
``_topk_rows_kernel``): per row, ``hi = max|x|``, ``lo = 0``, 24 halvings of
``[lo, hi]`` that count ``|x| >= mid`` against a float keep budget ``k``, then
keep ``x`` where ``|x| >= lo``. No sort; ties may keep more than ``k``.

Bound on the card: device-memory bytes, one read of ``x`` and one write of
the output, 8 B per element. The kernel (``csrc/rows.cu``) keeps the row
on-chip for all 25 reductions: in registers, one warp per row, for rows up to
1024 wide; in shared memory, one block per row, up to 50176; wider rows are
re-read per step. Every step is exact (max, halving, integer counts below
2^24), so kernel and plain version agree bitwise, and the plain version
equals the reference's compiled mirror ``ops._topk_rows_jnp`` bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

N_BISECT = 24


def topk_rows_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same bisection on a (B, D) tensor."""
    absx = x.to(torch.float32).abs()
    hi = absx.amax(dim=1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        cnt = (absx >= mid).to(torch.float32).sum(dim=1, keepdim=True)
        take_hi = cnt > k
        lo, hi = torch.where(take_hi, mid, lo), torch.where(take_hi, hi, mid)
    return torch.where(absx >= lo, x, torch.zeros_like(x))


def topk_rows(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row top-k of (B, D) float32 ``x`` with keep budget ``k`` (a float
    scalar tensor shared by every row). CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    k = torch.as_tensor(k, dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return topk_rows_plain(x, k)
    k = k.reshape(1).contiguous()
    build.check_operands("topk_rows", x, k)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = build.lib().topk_rows_launch(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            k.data_ptr(), build.stream(x))
    build.check(rc, "topk_rows")
    topk_rows.launches += 1
    return out


topk_rows.launches = 0
