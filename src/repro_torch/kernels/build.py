"""Build and load the hand-written CUDA kernels (``csrc/rows.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``: no PyTorch headers, so a
build takes seconds. The library goes to ``build/repro_torch/`` at the root
of the checkout, named by a hash of the source and flags, and is built at its
first use in a process (never at import). The compiler's register and
shared-memory report (``-Xptxas -v``) is kept beside it as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "rows.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -fmad=false keeps multiply and add separately rounded, as PyTorch's plain
# versions compute them: QSGD is then bitwise equal to its plain version
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "topk_rows_launch": (_P, _P, _I, _I, _P, _P),
    "qsgd_rows_launch": (_P, _P, _P, _P, _I, _I, _P, _P),
    "sign_ef_rows_launch": (_P, _P, _P, _P, _I, _I, _P),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda)")
    return nvcc


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"rows-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``rows.cu`` unless the library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial
    return out


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    so = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def check_operands(name: str, rows_like, *others) -> None:
    """The kernels take contiguous float32 CUDA tensors on one device: a 2-D
    ``(rows, d)`` first operand with fewer than 2^31 elements, and further
    operands of any shape. Raise on anything else."""
    for t in (rows_like, *others):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != rows_like.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{rows_like.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32, got "
                             f"{t.dtype} (contiguous={t.is_contiguous()})")
    if rows_like.dim() != 2 or rows_like.numel() >= 2 ** 31:
        raise ValueError(f"{name}: expected (rows, d) with < 2^31 elements, "
                         f"got {tuple(rows_like.shape)}")


def stream(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
