"""float32 ``log``, ``log1p``, ``exp``, ``tanh``, ``expm1`` and
``linspace`` as the reference's CPU backend computes them, so that the
recurrent blocks' constant inits (mamba's ``A_log``, RG-LRU's ``Lambda``),
the normal and exponential draws (``random.erfinv``,
``random.exponential``) and the vlm's cross-attention gates are bitwise the
reference's.

XLA's CPU backend does not call libm for these: it emits Cephes-style
polynomials (``log`` a degree-8 polynomial after a frexp split, ``log1p``
a 6/6 rational near 0, ``exp`` a degree-5 one after a ``2^n`` split,
``tanh`` a 13/6 rational), which differ from a correctly rounded result by
an ulp on some inputs (``log(7)``, most of ``linspace(0.9, 0.999, w)``'s
chain). Each step below is one float32 operation or one fused
multiply-add, where the reference's compiled x86 code has one (``fma64``),
so the results are the same on the CPU and on the card. ``linspace``
divides by ``num - 1`` as a multiply by its float32 reciprocal and takes
``stop * step`` as ``iota * (stop * (1 / (num - 1)))``, as XLA's
simplifier rewrites them.
"""
from __future__ import annotations

import functools
import struct

import numpy as np
import torch


def _f(bits: str) -> float:
    """A float32 constant, given as the IEEE double the compiled program
    prints (``0x3FB2043760000000``)."""
    return float(np.float32(struct.unpack(">d", bytes.fromhex(bits))[0]))


_SQRTHF = _f("3FE6A09E60000000")
_LOG_P = [_f(h) for h in ("3FB2043760000000", "BFBD7A3700000000",
                          "BFBFCBA9E0000000", "3FC23D37E0000000",
                          "3FC999D580000000", "BFCFFFFF80000000",
                          "3FBDE4A340000000", "BFC555CA00000000",
                          "3FD5555540000000")]
_LN2_HI, _LN2_LO = _f("3FE6300000000000"), _f("BF2BD01060000000")
_LOG2E = _f("3FF7154760000000")
_EXP_LO, _EXP_HI = _f("C055F33340000000"), _f("4056333340000000")
_EXP_P = [_f(h) for h in ("3F2A0D2CE0000000", "3F56E879C0000000",
                          "3F81112100000000", "3FA5553820000000",
                          "3FC5555540000000")]
_TANH_CLAMP, _TANH_TINY = _f("401FFEC880000000"), _f("3F3A36E2E0000000")
_TANH_N = [_f(h) for h in ("BCB3E4B800000000", "3D4C266FC0000000",
                           "BDD7A6FFE0000000", "3E6B800820000000",
                           "3EEF286940000000", "3F44E1BDA0000000",
                           "3F740B3B80000000")]
_TANH_D = [_f(h) for h in ("3EB41A7B00000000", "3F1F12BAC0000000",
                           "3F629540A0000000", "3F740B3BA0000000")]
_MIN_NORMAL = 2.0 ** -126
# log1p's rational branch below |x| = sqrt(2) - 1: x - x^2 / 2 + x^3 P / Q
_LOG1P_SMALL = _f("3FDA8279A0000000")
_LOG1P_P = [_f(h) for h in ("3F07BC0960000000", "3FDFE818A0000000",
                            "401A509F40000000", "403DE97380000000",
                            "404E798EC0000000", "404C8E75A0000000",
                            "40340A2020000000")]
_LOG1P_Q = [_f(h) for h in ("402E2035A0000000", "4054C30B60000000",
                            "406BB865A0000000", "4073519460000000",
                            "406B0DB140000000", "404E0F3040000000")]


@functools.lru_cache(maxsize=None)
def const64(v, device: torch.device) -> torch.Tensor:
    """A float64 constant (a float, or a tuple of them) on ``device``, made
    once per device and never written."""
    return torch.tensor(v, dtype=torch.float64, device=device)


def fma64(a64: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, ``a`` handed over widened to
    float64 (so that callers widen a shared factor once); ``b`` and ``c``
    float32 tensors or Python floats that float32 holds exactly. The product
    of two float32 values is exact in float64, and one ``addcmul`` forms the
    float64 sum before the rounding to float32: two launches on the card."""
    d = a64.device
    b = b if torch.is_tensor(b) else const64(b, d)
    c = c if torch.is_tensor(c) else const64(c, d)
    return torch.addcmul(c, a64, b).to(torch.float32)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, ``a`` a float32 tensor."""
    return fma64(a.double(), b, c)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log``."""
    x = x.to(torch.float32)
    bits = torch.clamp_min(x, _MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -2139095041) | 1056964608).view(torch.float32)
    small = m < _SQRTHF
    e = e - small.to(torch.float32)
    v = (m - 1.0) + torch.where(small, m, 0.0)
    z = v * v
    v3 = z * v
    v64, v3_64 = v.double(), v3.double()
    p = _LOG_P
    a = fma64(v64, fma64(v64, p[0], p[1]), p[6])
    b = fma64(v64, fma64(v64, p[2], p[3]), p[7])
    d = fma64(v64, fma64(v64, p[4], p[5]), p[8])
    t = fma64(v3_64, fma64(v3_64, a, b), d)
    y = fma64(v3_64, t, e * _LN2_LO)
    # fma(-1/2, z, v) is v - z / 2, the product exact
    out = fma64(e.double(), _LN2_HI, torch.add(v, z, alpha=-0.5) + y)
    # denormals are flushed to zero, as the reference's CPU flushes them
    out = torch.where(x < 0, float("nan"), out)
    out = torch.where(x.abs() < _MIN_NORMAL, -float("inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where(x.isnan(), x, out)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log1p``: ``log(1 + x)`` (the ``log`` above) from
    ``|x| = sqrt(2) - 1`` on, and below it ``x + fma(-1/2, x^2, x^3 P / Q)``
    with ``P`` (degree 6) and ``Q`` (monic, degree 6) by Horner's rule in
    FMAs and one correctly rounded division. ``random.normal`` feeds it
    ``-x * x`` and ``random.exponential`` ``-u``, as the reference's
    compiled samplers do."""
    x = x.to(torch.float32)
    x64 = x.double()
    p = fma64(x64, _LOG1P_P[0], _LOG1P_P[1])
    for v in _LOG1P_P[2:]:
        p = fma64(x64, p, v)
    q = x + _LOG1P_Q[0]
    for v in _LOG1P_Q[1:]:
        q = fma64(x64, q, v)
    x2 = x * x
    small = x + torch.add(x * x2 * (p / q), x2, alpha=-0.5)
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + 1.0))


def _exp_parts(x: torch.Tensor):
    """Cephes ``exp(x) = (1 + r + r^2 poly(r)) * 2^n``: returns the
    mantissa part and ``2^n`` (their product is ``exp``)."""
    xc = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(_fma(xc, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = _fma(n, -_LN2_LO, _fma(n, -_LN2_HI, xc))
    y = _fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:] + [0.5]:
        y = _fma(r, y, p)
    y = _fma(y, r * r, r) + 1.0
    pow2 = ((n.to(torch.int32) << 23) + 1065353216).view(torch.float32)
    return y, pow2


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``exp`` for ``|x| < 87`` (the clamp saturates)."""
    y, pow2 = _exp_parts(x.to(torch.float32))
    return y * pow2


def _tanh(x: torch.Tensor) -> torch.Tensor:
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    num = _fma(x2, _TANH_N[0], _TANH_N[1])
    for p in _TANH_N[2:]:
        num = _fma(x2, num, p)
    num = xc * num
    den = _fma(x2, _TANH_D[0], _TANH_D[1])
    for p in _TANH_D[2:]:
        den = _fma(x2, den, p)
    t = torch.where(x.abs() < _TANH_TINY, x, num / den)
    return torch.where(x.abs() >= 20.0, torch.sign(x), t)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``tanh``: a 13/6 rational on ``|x| < 7.99``."""
    return _tanh(x.to(torch.float32))


def expm1(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``expm1``: ``exp(x) - 1`` past |x| = 0.5, else
    ``tanh(x / 2) * (exp(x) + 1)``; 0 stays 0."""
    x = x.to(torch.float32)
    y, pow2 = _exp_parts(x)
    e = y * pow2
    out = torch.where(x.abs() > 0.5, e - 1.0, _tanh(x * 0.5) * (e + 1.0))
    return torch.where(x == 0, x, out)


def linspace(start: float, stop: float, num: int, device=None
             ) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 (endpoint included).

    ``start * (1 - step) + iota * (stop * r)``, ``r = f32(1 / (num - 1))``,
    the sum one fused multiply-add. Up to 352 points the compiled loop is
    unrolled and ``1 - step`` is folded into a table, two roundings; past
    that it runs 32 lanes at a time with ``1 - step`` fused, and the tail
    of fewer than 32 points as the unrolled form. This is the reference's
    output bit for bit from 2 to 1199 points and at 2560 (RG-LRU's widths
    at ``reduced()`` and published), but for the second point at 12, 14, 15
    and 26 points, an ulp away; wider loops may split their tail again."""
    s = torch.tensor(start, dtype=torch.float32, device=device)
    t = torch.tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return s.reshape(1)
    r = torch.tensor(np.float32(1.0) / np.float32(num - 1), device=device)
    one = torch.tensor(1.0, device=device)
    iota = torch.arange(num - 1, dtype=torch.float32, device=device)
    one_minus = one - iota * r
    if num > 352:
        lanes = (num - 1) // 32 * 32
        one_minus[:lanes] = _fma(-iota[:lanes], r, one)
    out = _fma(iota, t * r, s * one_minus)
    return torch.cat([out, t.reshape(1)])
