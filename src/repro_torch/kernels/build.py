"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
source, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds. The library goes to ``build/repro_torch/`` at the
root of the checkout, named by a hash of every source and header under
``csrc/`` and the flags, and is built at its first use in a process (never
at import). The compiler's register and shared-memory report (``-Xptxas
-v``) is kept beside it as ``<name>.log``.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false keeps multiply and add separately rounded, as PyTorch's plain
# versions compute them: QSGD is then bitwise equal to its plain version
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                 "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "topk_rows_launch": (_P, _P, _I, _I, _P, _P),
    "qsgd_rows_launch": (_P, _P, _P, _P, _I, _I, _P, _P),
    "sign_ef_rows_launch": (_P, _P, _P, _P, _I, _I, _P),
    "topk_tiles_launch": (_P, _P, _L, _I, _I, _I, _P),
    "qsgd_tiles_launch": (_P, _P, _P, _P, _L, _F, _I, _P),
    "sign_ef_tiles_launch": (_P, _P, _P, _P, _L, _I, _I, _P),
}


def sources() -> list:
    """The kernel sources, one object each."""
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda)")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(COMPILE_FLAGS).encode())
    return BUILD_DIR / f"kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source unless the library for them exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [subprocess.Popen(
        [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True, check=False)
        logs.append(link.stdout + link.stderr)
    out.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
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


def _check_cuda(name: str, first, tensors, x_types) -> None:
    # is_cuda and get_device() read the device without building a
    # torch.device, a few microseconds a call on the host path
    index = first.get_device()
    for i, t in enumerate(tensors):
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.get_device() != index:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{first.device}")
        allowed = x_types if i == 0 else (torch.float32,)
        if t.dtype not in allowed or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous "
                             f"{'/'.join(map(str, allowed))}, got {t.dtype} "
                             f"(contiguous={t.is_contiguous()})")


def check_operands(name: str, rows_like, *others) -> None:
    """The row kernels take contiguous float32 CUDA tensors on one device: a
    2-D ``(rows, d)`` first operand with rows and d each below 2^30 (an
    int index within a row, plus a block's stride, stays below 2^31; the
    kernels index elements in 64 bits), and further operands of any shape.
    Raise on anything else."""
    _check_cuda(name, rows_like, (rows_like, *others), (torch.float32,))
    if rows_like.dim() != 2 or max(rows_like.shape) >= 2 ** 30:
        raise ValueError(f"{name}: expected (rows, d), each < 2^30, got "
                         f"{tuple(rows_like.shape)}")


def check_tile_operands(name: str, x, *others) -> None:
    """The tile kernels take a contiguous CUDA ``x`` of any shape in float32
    or bfloat16 with fewer than 2^31 elements, and further contiguous float32
    operands on its device. Raise on anything else."""
    _check_cuda(name, x, (x, *others), (torch.float32, torch.bfloat16))
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: expected < 2^31 elements, got "
                         f"{x.numel()}")


def launch(name: str, fn, first, *args) -> None:
    """Call the entry point ``fn(*args, stream)`` with PyTorch's current
    stream on ``first``'s device, and raise if it returns a CUDA error. The
    launch goes to the calling thread's current device, so that device is
    switched to ``first``'s for the call, where it is another."""
    # the raw handle as PyTorch's generated code reads it, with no
    # torch.cuda.Stream built around it
    index = first.get_device()
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(rc, name)
