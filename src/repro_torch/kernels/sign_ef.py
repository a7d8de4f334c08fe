"""Fused scaled-sign + error feedback (eqs. 29 + 20-21), two CUDA kernels,
each with its plain twin.

``sign_ef_rows`` replaces ``repro/kernels/sign_ef.py::sign_ef_rows_pallas`` (body
``_sign_ef_rows_kernel``): ``corr = x + e``, ``scale = sum|corr| / d`` with
``d`` the real row width, ``c = scale * sign(corr)``, ``e' = corr - c``.

Bound on the card: device-memory bytes, reads of ``x`` and ``e`` and writes
of ``c`` and ``e'``, 16 B per element (unfused it would be three reads and
two writes). At the engine's (4096, 32) the kernel (``csrc/rows.cu``) is one
wave of about 2 us, mostly launch and load latency, so rows that fit 32
threads (d <= 64, or d <= 128 with d % 4 == 0) take the row groups of
``csrc/warp_rows.cuh``: two neighbouring values a thread up to d = 64, four
above, in one load and store each (4-byte ones where an operand is not
aligned to them), a row's sum in log2 of its threads' count of shuffles.
Other rows of width <= 1024 stay in one warp's registers and reduce with
shuffles; wider rows take one block each, reduce in a first pass and
recompute in a second. It needs no padding, so it divides by the real ``d``
directly (IEEE division, as the reference divides). Its sum runs in another
order than the plain version's, lane by lane and then across lanes: they
agree to rtol 1e-5, atol 1e-6.

``sign_ef_tiles`` replaces ``sign_ef_pallas`` (body ``_sign_ef_kernel``): the
same update per 1024-wide row of a flattened gradient of any shape, ``x`` in
float32 or bf16 and ``e`` in float32, where the mean divides by 1024 in the
ragged last row too (the TPU kernel averages over its zero padding). The
kernel (``csrc/tiles.cu``) runs the warp-per-row code of ``sign_ef_rows``
without a padded copy: 16 B per element, 14 B with bf16 ``x``; rtol 1e-5,
atol 1e-6 against its plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build


def sign_ef_rows_plain(x: torch.Tensor, e: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. Returns (c, e') in float32."""
    corr = x.to(torch.float32) + e.to(torch.float32)
    scale = corr.abs().sum(dim=1, keepdim=True) / corr.shape[1]
    c = scale * torch.sign(corr)
    return c, corr - c


def sign_ef_rows(x: torch.Tensor, e: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled sign + EF of (B, D) float32 rows ``x`` with error state ``e``.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return sign_ef_rows_plain(x, e)
    build.check_operands("sign_ef_rows", x, e)
    if e.shape != x.shape:
        raise ValueError(f"sign_ef_rows: e {tuple(e.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    c = torch.empty_like(x)
    e_new = torch.empty_like(x)
    build.launch("sign_ef_rows", build.lib().sign_ef_rows_launch, x,
                 x.data_ptr(), e.data_ptr(), c.data_ptr(), e_new.data_ptr(),
                 x.shape[0], x.shape[1])
    sign_ef_rows.launches += 1
    return c, e_new


sign_ef_rows.launches = 0


def sign_ef_tiles_plain(x: torch.Tensor, e: torch.Tensor, cols: int = 1024
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``x`` and ``e`` flattened and zero-padded to
    whole rows of ``cols``, each row's mean over all ``cols`` columns.
    Returns (c, e') in float32, shaped like ``x``."""
    n = x.numel()
    corr = torch.nn.functional.pad(
        x.to(torch.float32).reshape(-1) + e.to(torch.float32).reshape(-1),
        (0, -n % cols)).reshape(-1, cols)
    scale = corr.abs().sum(dim=1, keepdim=True) / cols
    c = scale * torch.sign(corr)
    return (c.reshape(-1)[:n].reshape(x.shape),
            (corr - c).reshape(-1)[:n].reshape(x.shape))


def sign_ef_tiles(x: torch.Tensor, e: torch.Tensor, cols: int = 1024
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled sign + EF of every ``cols``-wide row of flattened ``x`` (float32
    or bf16, any shape, ``cols`` <= 1024) with float32 error state ``e`` of
    its shape. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return sign_ef_tiles_plain(x, e, cols)
    build.check_tile_operands("sign_ef_tiles", x, e)
    if e.shape != x.shape or not 1 <= cols <= 1024:
        raise ValueError(f"sign_ef_tiles: e {tuple(e.shape)} does not fit x "
                         f"{tuple(x.shape)}, or cols {cols} is not in "
                         "[1, 1024]")
    c = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    e_new = torch.empty_like(c)
    build.launch("sign_ef_tiles", build.lib().sign_ef_tiles_launch, x,
                 x.data_ptr(), e.data_ptr(), c.data_ptr(), e_new.data_ptr(),
                 x.numel(), cols, int(x.dtype == torch.bfloat16))
    sign_ef_tiles.launches += 1
    return c, e_new


sign_ef_tiles.launches = 0
