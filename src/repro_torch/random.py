"""Counter-based threefry2x32 random numbers, bit-compatible with ``jax.random``.

The fleet engine's contract rests on per-client keys ``fold_in(key, id)``:
a client's randomness depends only on its id, never on which other clients
share its block, which is what makes the chunked client pass equal to the
unchunked one. A ``torch.Generator`` is a stream and cannot give that, so the
port carries JAX's default generator instead: threefry2x32 in the
"partitionable" layout (``jax_threefry_partitionable=True``, the default of
jax 0.9), with the same key derivation for ``split`` and ``fold_in``.

Keys are int64 tensors of shape ``(..., 2)`` holding two 32-bit words. All
arithmetic runs in int64 and is reduced with ``& 0xFFFFFFFF`` (CPU PyTorch
has no uint32 addition). Every function takes a batch of keys: a leading
``(...)`` key batch is the port's form of ``jax.vmap`` over keys, and the
output shape is ``key.shape[:-1] + shape``.

Floats follow ``jax.random._uniform``: 23 random mantissa bits under the
exponent of 1.0, minus one. ``normal`` is ``sqrt(2) * erfinv(u)`` with XLA's
float32 ``ErfInv`` polynomial ported term for term, its Horner steps fused
multiply-adds as the reference's compiled x86 code has them; its ``log1p``
and that of ``exponential`` are XLA's CPU ``log1p`` (``models/xla_math.py``),
so every sampler here is bitwise the reference's on the CPU.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from repro_torch.models import xla_math

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 32-bit seeds: words ``(0, seed)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block function (20 rounds) on broadcastable int64
    tensors of 32-bit words. Returns the two output words, at the broadcast
    shape. Works in place on two fresh buffers (four times faster on the CPU
    than allocating per operation). On the meta device only the shape is
    worked out (a draw there describes a state without computing it)."""
    shape = torch.broadcast_shapes(k1.shape, x1.shape, x2.shape)
    if x1.is_meta:
        return x1.expand(shape), x2.expand(shape)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]).bitwise_and_(MASK).expand(shape).contiguous()
    x2 = (x2 + ks[1]).bitwise_and_(MASK).expand(shape).contiguous()
    tmp = torch.empty_like(x2)
    for i in range(5):
        for r in _ROT[i % 2]:
            x1.add_(x2).bitwise_and_(MASK)
            torch.bitwise_left_shift(x2, r, out=tmp).bitwise_and_(MASK)
            x2.bitwise_right_shift_(32 - r).bitwise_or_(tmp).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x2.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x1, x2


def _counts(key: torch.Tensor, shape: tuple):
    """Key words broadcast against the row-major 64-bit iota of ``shape``
    (split into high and low words, as ``iota_2x32_shape``)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    return k1, k2, idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., num, 2)``."""
    k1, k2, hi, lo = _counts(key, (num,))
    return torch.stack(threefry2x32(k1, k2, hi, lo), dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``. ``data`` is an int or an integer tensor of ids;
    a tensor of ids folds each id into the one key (``(n, 2)`` out), the
    port's form of ``vmap(lambda i: fold_in(key, i))``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    k1 = key[..., 0].reshape(key.shape[:-1] + (1,) * d.dim())
    k2 = key[..., 1].reshape(key.shape[:-1] + (1,) * d.dim())
    return torch.stack(threefry2x32(k1, k2, torch.zeros_like(d), d), dim=-1)


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element (as int64 in ``[0, 2^32)``)."""
    b1, b2 = threefry2x32(*_counts(key, _shape(shape)))
    return b1.bitwise_xor_(b2)


def _unit_floats(key, shape) -> torch.Tensor:
    return _floats_of(bits(key, shape))


def _floats_of(b: torch.Tensor) -> torch.Tensor:
    """32-bit words -> float32 in [0, 1): 23 mantissa bits under 1.0."""
    fbits = ((b >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


# A draw over a whole tensor for one key is made CHUNK elements at a time
# (the counters are the flat index), so that a 6e8-element leaf holds its
# int64 threefry words for one chunk, not six 4.8 GB buffers at once.
CHUNK = 1 << 24


def _bits_range(key: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """``bits(key, shape).reshape(-1)[start:stop]`` for one key ``(2,)`` and
    any shape of at least ``stop`` elements."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK)
    return b1.bitwise_xor_(b2)


def uniform_below(key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``uniform(key, p.shape) < p`` for one key, as a bool tensor, drawn
    CHUNK elements at a time."""
    flat = p.reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.bool, device=p.device)
    for a in range(0, flat.numel(), CHUNK):
        b = min(a + CHUNK, flat.numel())
        torch.lt(_floats_of(_bits_range(key, a, b)), flat[a:b], out=out[a:b])
    return out.reshape(p.shape)


def _in_range(f: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in ``[minval, maxval)`` (``jax.random.uniform``)."""
    return _in_range(_unit_floats(key, _shape(shape)), minval, maxval)


# XLA's float32 ErfInv (xla/client/lib/math.cc): a degree-8 polynomial in
# w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _f32(values: tuple) -> tuple:
    """The float32 roundings of ``values``, as Python floats."""
    return tuple(torch.tensor(values, dtype=torch.float32).tolist())


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's polynomial term for term."""
    if x.is_meta:
        return torch.empty_like(x)
    w = -xla_math.log1p(-x * x)
    lt = w < 5.0
    # sqrt correctly rounded (in float64), as x86's vsqrtps: PyTorch's CPU
    # float32 sqrt is an ulp low on some inputs
    w = torch.where(lt, w - 2.5, w.double().sqrt().float() - 3.0)
    coef = torch.where(lt[..., None],
                       xla_math.const64(_f32(_ERFINV_LT5), x.device),
                       xla_math.const64(_f32(_ERFINV_GE5), x.device))
    w64 = w.double()
    p = coef[..., 0]
    for i in range(1, len(_ERFINV_LT5)):
        p = xla_math.fma64(w64, p, coef[..., i])
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = -0.99999994  # nextafter(-1, 0) in float32


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """Standard normal float32 (``jax.random.normal``). For one key and
    more than CHUNK elements it is drawn CHUNK elements at a time, the same
    bits (erfinv's float64 steps over a whole 6.6e8-element embedding peak
    near 30x its size, past the card's 80 GB)."""
    shape = _shape(shape)
    n = math.prod(shape)
    if (key.dim() > 1 or n <= CHUNK or key.is_meta
            or torch._C._are_functorch_transforms_active()):
        return math.sqrt(2.0) * erfinv(uniform(key, shape, _NORMAL_LO, 1.0))
    out = torch.empty(n, dtype=torch.float32, device=key.device)
    for a in range(0, n, CHUNK):
        b = min(a + CHUNK, n)
        u = _in_range(_floats_of(_bits_range(key, a, b)), _NORMAL_LO, 1.0)
        out[a:b] = math.sqrt(2.0) * erfinv(u)
    return out.reshape(shape)


def exponential(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """Exp(1) float32 (``jax.random.exponential``): ``-log1p(-u)``."""
    return -xla_math.log1p(-uniform(key, shape))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for one key: repeated stable sorts
    by fresh 32-bit keys, as many rounds as JAX's collision bound asks."""
    x = torch.arange(n, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.argsort(_sort_keys(sub, n), stable=True)
        x = x[order]
    return x


def _sort_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """``bits(key, (n,))`` as int32 ``bits - 2^31`` (the same order, half
    the bytes to sort), CHUNK elements at a time."""
    out = torch.empty(n, dtype=torch.int32, device=key.device)
    for a in range(0, n, CHUNK):
        b = min(a + CHUNK, n)
        out[a:b] = _bits_range(key, a, b) - (1 << 31)
    return out


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 integers in ``[minval, maxval)`` (``jax.random.randint`` with
    the default int32 type), bit for bit: two 32-bit draws from
    ``split(key)``, combined modulo the span in wrapping uint32 arithmetic
    (the multiplier ``(2^16 mod span)^2`` wraps to 0 for spans past 2^16,
    as it does in JAX). An empty range returns ``minval``."""
    shape = _shape(shape)
    lo, hi = int(minval), int(maxval)
    ks = split(key)
    higher, lower = bits(ks[..., 0, :], shape), bits(ks[..., 1, :], shape)
    span = (hi - lo) & MASK if hi > lo else 1
    mult = ((((1 << 16) % span) ** 2) & MASK) % span
    off = ((((higher % span) * mult) & MASK) + lower % span) & MASK
    off = off % span
    out = (off + lo) & MASK
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(
        torch.int32)


def bernoulli(key: torch.Tensor, p: float = 0.5,
              shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low") at a float32 ``p``: a uniform
    draw below ``p``."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                              device=key.device)
