"""QSGD stochastic quantization (paper §II.B.1, eqs. 24-25), two CUDA
kernels, each with its plain twin.

``qsgd_rows`` replaces ``repro/kernels/qsgd.py::qsgd_rows_pallas`` (body
``_qsgd_rows_kernel``): ``scaled = |x| / max(norm, 1e-30) * L``,
``q = (floor(scaled) + [u < frac]) / L``, ``out = sign(x) * q * norm``, with
each row's L2 norm and ``L = max(levels, 1)`` as operands. The noise ``u`` is
an operand too, exactly as on the TPU: it comes from per-client threefry keys,
and drawing it in-kernel (Philox) would break parity with the reference.

Bound on the card: device-memory bytes, reads of ``x`` and ``u`` and a write
of the output (12 B per element) plus one norm per row. With the norms given
there is no reduction left, so the kernel (``csrc/rows.cu``) is one flat
elementwise pass. Built with ``-fmad=false``, it is bitwise equal to the plain
version for the same ``x, u, norms, levels``.

``qsgd_tiles`` replaces ``qsgd_pallas`` (body ``_qsgd_kernel``): the same
rule on a whole gradient of any shape in float32 or bf16, against one global
L2 norm (a device scalar, so the host never waits for it) and a static
``levels``. The kernel (``csrc/tiles.cu``) is a grid-stride pass with 16-byte
loads and stores where the operands are aligned: 12 B per element in
float32, 10 B with bf16 ``x``. It is bitwise equal to its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def qsgd_rows_plain(x: torch.Tensor, u: torch.Tensor, norms: torch.Tensor,
                    levels: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. ``norms``: (B, 1); ``levels`` clamped >= 1."""
    xf = x.to(torch.float32)
    scaled = xf.abs() / torch.clamp_min(norms, 1e-30) * levels
    lower = torch.floor(scaled)
    q = (lower + (u < (scaled - lower)).to(torch.float32)) / levels
    return (torch.sign(xf) * q * norms).to(x.dtype)


def qsgd_rows(x: torch.Tensor, u: torch.Tensor, norms: torch.Tensor,
              levels: torch.Tensor) -> torch.Tensor:
    """QSGD of (B, D) float32 rows with per-row ``norms`` (B, 1) and a scalar
    ``levels`` tensor (already clamped to >= 1). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    levels = torch.as_tensor(levels, dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return qsgd_rows_plain(x, u, norms, levels)
    levels = levels.reshape(1).contiguous()
    build.check_operands("qsgd_rows", x, u, norms, levels)
    if u.shape != x.shape or norms.shape != (x.shape[0], 1):
        raise ValueError(f"qsgd_rows: u {tuple(u.shape)} and norms "
                         f"{tuple(norms.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = build.lib().qsgd_rows_launch(
            x.data_ptr(), u.data_ptr(), norms.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], levels.data_ptr(), build.stream(x))
    build.check(rc, "qsgd_rows")
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
    return qsgd_rows_plain(x.reshape(1, -1), u.reshape(-1)[:x.numel()],
                           norm.reshape(1, 1), lv).reshape(x.shape)


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
    with torch.cuda.device(x.device):
        rc = build.lib().qsgd_tiles_launch(
            x.data_ptr(), u.data_ptr(), norm.data_ptr(), out.data_ptr(),
            x.numel(), float(levels), int(x.dtype == torch.bfloat16),
            build.stream(x))
    build.check(rc, "qsgd_tiles")
    qsgd_tiles.launches += 1
    return out


qsgd_tiles.launches = 0
