"""QSGD stochastic quantization (paper §II.B.1, eqs. 24-25), two CUDA
kernels, each with its plain twin.

``qsgd_rows`` replaces ``repro/kernels/qsgd.py::qsgd_rows_pallas`` (body
``_qsgd_rows_kernel``): ``scaled = |x| / max(norm, 1e-30) * L``,
``q = (floor(scaled) + [u < frac]) / L``, ``out = sign(x) * q * norm``, with
``L = max(levels, 1)`` taken inside, as the TPU kernel takes it, and each
row's L2 norm either an operand (the TPU kernel's interface) or, with
``norms=None``, computed by the kernel from the ``x`` it has loaded: then
one launch does what the reference's ``ops.qsgd_rows`` does with a norm
pass and the kernel. The noise ``u`` is an operand, exactly as on the TPU:
it comes from per-client threefry keys, and drawing it in-kernel (Philox)
would break parity with the reference.

Bound on the card: device-memory bytes, reads of ``x`` and ``u`` and a write
of the output, 12 B per element (plus one norm per row when given). At the
engine's (4096, 32) the kernel (``csrc/rows.cu``) is one wave of about 2 us,
mostly launch and load latency, and a thread's chain of IEEE divisions (two
an element) is what is left of it: rows of up to 1024 threads take the row
groups of ``csrc/warp_rows.cuh``, two neighbouring values a thread up to
d = 64 and four above (one access each where the operands are aligned), a
row's norm in log2 of its threads' count of shuffles. Wider rows take a
block each to compute their norm, or a flat pass when it is given. Built
with ``-fmad=false``, the kernel is bitwise equal to the plain version given
the same norms, and with ``norms=None`` to the plain version's norms summed
in the kernel's order (``ref.lane_order_norms``).

``qsgd_tiles`` replaces ``qsgd_pallas`` (body ``_qsgd_kernel``): the same
rule on a whole gradient of any shape in float32 or bf16, against one global
L2 norm (a device scalar, so the host never waits for it) and a static
``levels``, not clamped (neither is the TPU kernel's). The kernel
(``csrc/tiles.cu``) is a grid-stride pass with 16-byte loads and stores
where the operands are aligned: 12 B per element in float32, 10 B with bf16
``x``. It is bitwise equal to its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref


def _quantize(xf: torch.Tensor, u: torch.Tensor, norms: torch.Tensor,
              levels: torch.Tensor) -> torch.Tensor:
    scaled = xf.abs() / torch.clamp_min(norms, 1e-30) * levels
    lower = torch.floor(scaled)
    q = (lower + (u < (scaled - lower)).to(torch.float32)) / levels
    return torch.sign(xf) * q * norms


def qsgd_rows_plain(x: torch.Tensor, u: torch.Tensor,
                    norms: Optional[torch.Tensor],
                    levels: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. ``norms``: (B, 1), or None for each row's
    norm summed in the kernel's order; ``levels`` a float32 tensor, clamped
    to >= 1 here."""
    xf = x.to(torch.float32)
    if norms is None:
        norms = ref.lane_order_norms(xf)
    return _quantize(xf, u, norms, torch.clamp_min(levels, 1.0)).to(x.dtype)


def qsgd_rows(x: torch.Tensor, u: torch.Tensor,
              norms: Optional[torch.Tensor],
              levels: torch.Tensor) -> torch.Tensor:
    """QSGD of (B, D) float32 rows with dither ``u`` (B, D), per-row
    ``norms`` (B, 1) or None (computed in the kernel), and a one-element
    ``levels`` (a tensor or a number; clamped to >= 1 inside). CPU tensors
    take the plain version; CUDA tensors launch the kernel, once."""
    levels = torch.as_tensor(levels, dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return qsgd_rows_plain(x, u, norms, levels)
    if norms is None:
        build.check_operands("qsgd_rows", x, u, levels)
    else:
        build.check_operands("qsgd_rows", x, u, levels, norms)
    if (u.shape != x.shape or levels.numel() != 1
            or (norms is not None and norms.shape != (x.shape[0], 1))):
        raise ValueError(f"qsgd_rows: u {tuple(u.shape)}, norms "
                         f"{None if norms is None else tuple(norms.shape)} "
                         f"and levels {tuple(levels.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    build.launch("qsgd_rows", build.lib().qsgd_rows_launch, x,
                 x.data_ptr(), u.data_ptr(),
                 None if norms is None else norms.data_ptr(), out.data_ptr(),
                 x.shape[0], x.shape[1], levels.data_ptr())
    qsgd_rows.launches += 1
    return out


qsgd_rows.launches = 0


def qsgd_tiles_plain(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor,
                     levels: int) -> torch.Tensor:
    """Plain PyTorch version: ``x`` of any shape, ``u`` float32 with at
    least ``x.numel()`` elements (the first ones are used, in order),
    ``norm`` a one-element float32 tensor. Returns x's shape and type."""
    # levels as a tensor on x's device: PyTorch's CUDA division by a Python
    # number multiplies by its reciprocal, which the kernel does not
    lv = torch.tensor(float(levels), dtype=torch.float32, device=x.device)
    return _quantize(x.to(torch.float32).reshape(1, -1),
                     u.reshape(-1)[:x.numel()], norm.reshape(1, 1),
                     lv).to(x.dtype).reshape(x.shape)


def qsgd_tiles(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor,
               levels: int) -> torch.Tensor:
    """QSGD of ``x`` (float32 or bf16, any shape) with noise ``u`` (float32,
    at least ``x.numel()`` elements), the global ``norm`` (one float32
    element) and ``levels``. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if x.device.type == "cpu":
        return qsgd_tiles_plain(x, u, norm, levels)
    build.check_tile_operands("qsgd_tiles", x, u, norm)
    if u.numel() < x.numel() or norm.numel() != 1:
        raise ValueError(f"qsgd_tiles: u {tuple(u.shape)} and norm "
                         f"{tuple(norm.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    build.launch("qsgd_tiles", build.lib().qsgd_tiles_launch, x,
                 x.data_ptr(), u.data_ptr(), norm.data_ptr(), out.data_ptr(),
                 x.numel(), float(levels), int(x.dtype == torch.bfloat16))
    qsgd_tiles.launches += 1
    return out


qsgd_tiles.launches = 0
