"""Per-row threshold-bisection top-k (paper §II.A.3), two CUDA kernels, each
with its plain twin.

``topk_rows`` replaces ``repro/kernels/topk_mask.py::topk_rows_pallas`` (body
``_topk_rows_kernel``): per row, ``hi = max|x|``, ``lo = 0``, 24 halvings of
``[lo, hi]`` that count ``|x| >= mid`` against a float keep budget ``k``, then
keep ``x`` where ``|x| >= lo``. No sort; ties may keep more than ``k``.
Denormal ``|x|`` and ``mid`` count as zero, as the reference's XLA flushes
them on the CPU and the TPU; a kept denormal is written as it was. A row
that holds a NaN has ``hi = NaN``, as ``jnp.max`` gives it: every ``mid`` is
NaN and counts nothing, so (for ``k >= 0``) every non-NaN value is kept.

``block_topk_tiles`` replaces ``block_topk_pallas`` (body ``_topk_kernel``):
the same bisection per 1024-wide row of a flattened gradient of any shape in
float32 or bf16, int counts against a static int ``k``, with the ragged last
row read as the zeros of the reference's padding, and no padded copy.

The kernels (``csrc/warp_rows.cuh``, ``rows.cu``, ``tiles.cu``) select, then
replay. Each step of the bisection asks whether ``count(|x| >= mid) > k``;
with ``K = floor(k) + 1`` and ``t`` the row's K-th largest ``|x|``, that holds
exactly when ``t >= mid``. So a kernel finds ``t`` once per row (a warp max
K times for rows of up to 32, a lane-maximum bound and a candidate buffer up
to 1024, a radix select of four 8-bit digits above) and replays the 24
halvings as scalar arithmetic. ``k < 0`` moves ``lo`` at every step, ``K``
past the row's width at none. Bound on the card: device-memory bytes, one
read of ``x`` and one write of the output (8 B per element in float32, 4 B
in bf16). Every decision is the count's, so kernel and plain version agree
bitwise, and the plain version equals the reference's kernels and its
compiled mirror ``ops._topk_rows_jnp`` bitwise.

``_bisect`` is the kernels' plain version; ``select_replay`` is the second
formulation, by sort, that the tests hold bitwise equal to it as the CPU
evidence for the invariant the kernels rely on.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

N_BISECT = 24
FLT_MIN = torch.finfo(torch.float32).tiny


def _flush(a: torch.Tensor) -> torch.Tensor:
    """Denormals to zero, as the reference's XLA computes on the CPU and the
    TPU: a non-negative float32 below the least normal is 0 (NaN stays)."""
    return torch.where(a < FLT_MIN, torch.zeros_like(a), a)


def _bisect(x: torch.Tensor, k, count_dtype) -> torch.Tensor:
    """The bisection on a (B, D) tensor, counting in ``count_dtype``."""
    absx = _flush(x.to(torch.float32).abs())
    hi = absx.amax(dim=1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(N_BISECT):
        mid = _flush(0.5 * (lo + hi))
        cnt = (absx >= mid).to(count_dtype).sum(dim=1, keepdim=True)
        take_hi = cnt > k
        lo, hi = torch.where(take_hi, mid, lo), torch.where(take_hi, hi, mid)
    return torch.where(absx >= lo, x, torch.zeros_like(x))


def select_replay(x: torch.Tensor, k) -> torch.Tensor:
    """The bisection on a (B, D) tensor by select-then-replay: ``t``, the
    K-th largest ``|x|`` of each row (``K = floor(k) + 1``) by ``torch.sort``,
    then the 24 halvings with ``take_hi = k < 0 or (K <= D and t >= mid)``.
    Equal to ``_bisect`` bitwise (a NaN ``mid`` fails the comparison, as it
    counts nothing)."""
    absx = _flush(x.to(torch.float32).abs())
    d = absx.shape[1]
    k = torch.as_tensor(k, dtype=torch.float32)
    hi = absx.amax(dim=1, keepdim=True)
    always = bool(k < 0)
    have = bool(k >= 0) and bool(k < d)
    t = torch.zeros_like(hi)
    if have:
        kk = int(torch.floor(k)) + 1
        t = torch.sort(absx, dim=1, descending=True).values[:, kk - 1:kk]
    lo = torch.zeros_like(hi)
    for _ in range(N_BISECT):
        mid = _flush(0.5 * (lo + hi))
        take_hi = (t >= mid) & have | always
        lo, hi = torch.where(take_hi, mid, lo), torch.where(take_hi, hi, mid)
    return torch.where(absx >= lo, x, torch.zeros_like(x))


def topk_rows_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same bisection on a (B, D) tensor."""
    return _bisect(x, k, torch.float32)


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
    build.launch("topk_rows", build.lib().topk_rows_launch, x,
                 x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                 k.data_ptr())
    topk_rows.launches += 1
    return out


topk_rows.launches = 0


def block_topk_tiles_plain(x: torch.Tensor, k: int, cols: int = 1024
                           ) -> torch.Tensor:
    """Plain PyTorch version: ``x`` flattened, zero-padded to whole rows of
    ``cols`` and bisected per row with int counts against the int ``k``;
    returns x's shape and type."""
    flat = x.reshape(-1)
    n = flat.numel()
    tiles = torch.nn.functional.pad(flat, (0, -n % cols)).reshape(-1, cols)
    return _bisect(tiles, int(k), torch.int32).reshape(-1)[:n].reshape(
        x.shape)


def block_topk_tiles(x: torch.Tensor, k: int, cols: int = 1024
                     ) -> torch.Tensor:
    """Top-k of every ``cols``-wide row of flattened ``x`` (float32 or bf16,
    any shape, ``cols`` <= 1024) with the int budget ``k``. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return block_topk_tiles_plain(x, k, cols)
    build.check_tile_operands("block_topk_tiles", x)
    if not 1 <= cols <= 1024:
        raise ValueError(f"block_topk_tiles: cols must be in [1, 1024], got "
                         f"{cols}")
    out = torch.empty_like(x)
    build.launch("block_topk_tiles", build.lib().topk_tiles_launch, x,
                 x.data_ptr(), out.data_ptr(), x.numel(), cols, int(k),
                 int(x.dtype == torch.bfloat16))
    block_topk_tiles.launches += 1
    return out


block_topk_tiles.launches = 0
