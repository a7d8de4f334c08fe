"""Wireless channel simulation and update-success analytics (paper §III),
port of ``repro/core/wireless.py``.

Two halves, as in the reference:

* **numpy reference** (top): large-scale path loss, Rayleigh block fading,
  Shannon rates over orthogonal subchannels, and the PPP/SINR update-success
  analytics of eqs. (47)-(56) [59], copied (eq. (51)'s integrand is garbled
  in the source text; the standard Rayleigh/PPP interference functional of
  [59] is implemented, a documented deviation with the same RS/RR/PF order);
* **torch twins** (``*_jax``, below): the engine's channel, driven by
  threefry keys. Static integers stay on :class:`WirelessConfig`; the
  continuous parameters are float32 scalar tensors in :class:`ChannelParams`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.models import xla_math


@dataclasses.dataclass(frozen=True)
class WirelessConfig:
    """Defaults follow the chapter's Fig. 1 experiment."""
    n_devices: int = 100
    cell_radius_m: float = 500.0
    bandwidth_hz: float = 2e7
    noise_dbw_per_hz: float = -204.0
    tx_power_dbm: float = 10.0       # device uplink
    bs_power_dbm: float = 15.0       # downlink
    path_loss_exponent: float = 3.0
    ref_loss_db: float = 30.0        # loss at 1 m
    n_subchannels: int = 20


def dbm_to_watt(dbm: float) -> float:
    return 10 ** ((dbm - 30) / 10)


def db_to_lin(db: float) -> float:
    return 10 ** (db / 10)


# ---------------------------------------------------------------------------
# Topology + fading
# ---------------------------------------------------------------------------
def sample_positions(rng: np.random.Generator, cfg: WirelessConfig) -> np.ndarray:
    """Uniform in the disk of radius R (distances to the BS at origin)."""
    r = cfg.cell_radius_m * np.sqrt(rng.random(cfg.n_devices))
    return np.maximum(r, 1.0)


def path_gain(dist_m: np.ndarray, cfg: WirelessConfig) -> np.ndarray:
    """Linear large-scale gain: -ref_loss - 10*alpha*log10(d)."""
    loss_db = cfg.ref_loss_db + 10 * cfg.path_loss_exponent * np.log10(dist_m)
    return db_to_lin(-loss_db)


def sample_fading(rng: np.random.Generator, n: int) -> np.ndarray:
    """Rayleigh block fading power |h|^2 ~ Exp(1), i.i.d. per round."""
    return rng.exponential(1.0, size=n)


def snr(dist_m: np.ndarray, fading: np.ndarray, cfg: WirelessConfig,
        bandwidth_hz: float | None = None) -> np.ndarray:
    bw = bandwidth_hz if bandwidth_hz is not None else cfg.bandwidth_hz
    p = dbm_to_watt(cfg.tx_power_dbm)
    n0 = db_to_lin(cfg.noise_dbw_per_hz) * bw
    return p * path_gain(dist_m, cfg) * fading / n0


def shannon_rate(snr_lin: np.ndarray, bandwidth_hz: float) -> np.ndarray:
    """bits/s (eq. 40 up to the orthogonal-subchannel split)."""
    return bandwidth_hz * np.log2(1.0 + snr_lin)


def comm_latency(bits: float, rate_bps: np.ndarray) -> np.ndarray:
    """L_comm = d / R (paper §III). A non-positive rate is an *outage*:
    the payload never arrives, so the latency is ``inf`` (not the absurd
    finite number a silent rate clamp used to produce) — deadline-aware
    policies then exclude the device instead of scheduling a phantom."""
    rate = np.asarray(rate_bps, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return np.where(rate > 0.0, bits / np.maximum(rate, 1e-300), np.inf)


def subchannel_rate(snr_per_sub: np.ndarray, cfg: WirelessConfig,
                    n_alloc: int) -> np.ndarray:
    """Rate when n_alloc orthogonal subchannels are allocated (eq. 40),
    equal power split."""
    sub_bw = cfg.bandwidth_hz / cfg.n_subchannels
    return n_alloc * sub_bw * np.log2(1.0 + snr_per_sub / max(n_alloc, 1))


# ---------------------------------------------------------------------------
# Update-success analytics (eqs. 47-56), [59]
# ---------------------------------------------------------------------------
def interference_functional(gamma_star: float, alpha: float,
                            noise_term: float = 0.0) -> float:
    """V(gamma*, alpha): mean interference functional under Rayleigh fading
    and unit-density PPP interferers,
        V = gamma*^{2/alpha} * integral_{gamma*^{-2/alpha}}^inf du/(1+u^{alpha/2})
    plus an additive noise term. (Deviation note in the module docstring.)
    """
    lo = gamma_star ** (-2.0 / alpha)
    us = np.linspace(lo, lo + 5_000.0, 200_000)
    integrand = 1.0 / (1.0 + us ** (alpha / 2.0))
    integral = np.trapezoid(integrand, us)
    return float(gamma_star ** (2.0 / alpha) * integral + noise_term)


def update_success_rs(k: int, n: int, v: float) -> float:
    """Eq. (50): U_n ~= (K/N) / (1+V)."""
    return (k / n) / (1.0 + v)


def update_success_rr(v: float) -> float:
    """Eq. (53), conditioned on being scheduled."""
    return 1.0 / (1.0 + v)


def update_success_pf(k: int, n: int, gamma_star: float, alpha: float,
                      noise_term: float = 0.0) -> float:
    """Eq. (55): opportunistic gain via the binomial alternating sum."""
    m = n - k + 1
    total = 0.0
    for i in range(1, m + 1):
        vi = interference_functional(i * gamma_star, alpha, noise_term)
        total += math.comb(m, i) * ((-1) ** (i + 1)) * (n / k) / (1.0 + vi)
    # eq. (55) is a per-scheduled-slot probability; clamp to [0,1)
    return min(max(total * (k / n), 0.0), 0.999999)


def rounds_required(u: float) -> float:
    """Required iterations ~ 1/|log(1-U)| (eqs. 52/54/56 up to constants)."""
    return 1.0 / abs(math.log(max(1.0 - u, 1e-12)))


def rounds_required_rr(u_scheduled: float, k: int, n: int) -> float:
    """Eq. (54): RR pays the N/K scheduling duty cycle on top of the
    per-scheduled-round success probability."""
    return (n / k) * rounds_required(u_scheduled)


class ChannelParams(NamedTuple):
    """WirelessConfig's continuous fields as float32 scalar tensors."""
    cell_radius_m: torch.Tensor
    bandwidth_hz: torch.Tensor
    noise_dbw_per_hz: torch.Tensor
    tx_power_dbm: torch.Tensor
    path_loss_exponent: torch.Tensor
    ref_loss_db: torch.Tensor
    bs_power_dbm: torch.Tensor


def channel_params(cfg: WirelessConfig, device=None) -> ChannelParams:
    return ChannelParams(*(
        torch.tensor(float(getattr(cfg, f)), dtype=torch.float32,
                     device=device) for f in ChannelParams._fields))


def stack_channel_params(cfgs, device=None) -> ChannelParams:
    """Several WirelessConfigs as one ChannelParams with a leading variant
    axis, as the reference's sweep batches its variants."""
    ps = [channel_params(c, device) for c in cfgs]
    return ChannelParams(*(torch.stack([getattr(p, f) for p in ps])
                           for f in ChannelParams._fields))


def gather_channel_params(cp: ChannelParams,
                          idx: torch.Tensor) -> ChannelParams:
    """Per-group ChannelParams -> per-device ChannelParams: fields with a
    leading group axis (one entry per HFL cluster) are gathered through
    ``idx`` (the device -> group assignment); scalar fields, one cell
    configuration shared by every group, pass through untouched."""
    ids = idx.to(torch.int64)
    return ChannelParams(*(f[ids] if f.dim() >= 1 else f for f in cp))


# The reference's CPU arithmetic for deployments, held bitwise: its cos
# and sin are the C library's cosf/sinf, which reduce by pi/2 and evaluate
# these polynomials in float64 (the coefficients of glibc's sincosf tables);
# its sqrt is correctly rounded, which PyTorch's float32 CPU sqrt is not
# everywhere; its 2-D norm contracts into a fused multiply-add. Every step
# is one float64 op, so the card computes the same bits as the CPU. The
# hierarchical geometry (``core/hierarchy.py``) and the D2D geometry below
# share them.
_HPI_INV = float.fromhex("0x1.45f306dc9c883p-1")   # 2 / pi
_HPI = float.fromhex("0x1.921fb54442d18p0")        # pi / 2
_HPI_HI = float.fromhex("0x1.921fb6p0")             # pi / 2, 24 bits
_HPI_LO = float.fromhex("-0x1.777a5cf72cecep-25")   # pi / 2 - _HPI_HI
_COS_C = tuple(float.fromhex(c) for c in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN_S = tuple(float.fromhex(c) for c in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64)."""
    return torch.sqrt(x.double()).to(torch.float32)


def _cos_sin(theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(cos, sin)`` of float32 angles, as the C library's
    cosf/sinf compute them: reduce by pi/2 to ``|x| <= pi/4`` with quadrant
    n, evaluate the even and odd polynomials, and swap and negate them by
    the quadrant. Below ``|theta| = 120`` the reduction is one float64
    ``x - n * pi/2``; from there the C library reduces exactly (a table of
    2/pi bits), which pi/2 in two parts matches (``n * hi`` is exact)."""
    x = theta.double()
    n = torch.round(x * _HPI_INV)
    x = torch.where(theta.abs() < 120, x - n * _HPI,
                    (x - n * _HPI_HI) - n * _HPI_LO)
    q = n.to(torch.int64) & 3
    xs = torch.where((q == 1) | (q == 2), -x, x)
    x2 = x * x
    c0, c1, c2, c3, c4 = _COS_C
    s1, s2, s3 = _SIN_S
    x4 = x2 * x2
    cpoly = (c0 + x2 * c1) + x4 * c2
    cpoly = cpoly + (x4 * x2) * (c3 + x2 * c4)
    cpoly = torch.where(q >= 2, -cpoly, cpoly)
    x3 = xs * x2
    spoly = (xs + x3 * s1) + (x3 * x2) * (s2 + x2 * s3)
    odd = (q & 1) == 1
    cos_t = torch.where(odd, spoly, cpoly)
    sin_t = torch.where(odd, cpoly, spoly)
    return cos_t.to(torch.float32), sin_t.to(torch.float32)


def _norm_xy(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """float32 ``|(dx, dy)|`` as the reference's compiled norm: ``dy * dy``
    contracted into a fused multiply-add on the rounded ``dx * dx`` (the
    product is exact in float64), then a correctly rounded sqrt."""
    return _sqrt(((dx * dx).double() + dy.double() * dy.double()).to(
        torch.float32))


def sample_positions_jax(key: torch.Tensor, cp: ChannelParams,
                         n_devices: int) -> torch.Tensor:
    """Distances to the BS, uniform in the disk of radius R (>= 1 m)."""
    r = cp.cell_radius_m * torch.sqrt(trandom.uniform(key, (n_devices,)))
    return torch.clamp_min(r, 1.0)


def sample_positions_xy_jax(key: torch.Tensor, cp: ChannelParams,
                            n_devices: int) -> torch.Tensor:
    """Uniform (N, 2) xy deployment in the disk of radius R, the xy
    companion of :func:`sample_positions_jax` (same disk law): the D2D
    (gossip) engine prices pairwise device distances."""
    k_r, k_t = trandom.split(key)
    theta = trandom.uniform(k_t, (n_devices,)) * (2.0 * math.pi)
    r = cp.cell_radius_m * _sqrt(trandom.uniform(k_r, (n_devices,)))
    cos_t, sin_t = _cos_sin(theta)
    return torch.stack([r * cos_t, r * sin_t], dim=-1)


def pairwise_dist_jax(pos_xy: torch.Tensor) -> torch.Tensor:
    """(N, 2) positions -> (N, N) pairwise distances, clamped to >= 1 m so
    the log-distance path loss stays finite (the self-distance diagonal is
    clamped too; self-edges are never priced)."""
    diff = pos_xy[:, None, :] - pos_xy[None, :, :]
    return torch.clamp_min(_norm_xy(diff[..., 0], diff[..., 1]), 1.0)


# The reference's compiled channel arithmetic: XLA folds ``10 * ple *
# log10(d)`` into ``log(d) * (ple * f32(10 * f32(1 / ln 10)))`` with its own
# float32 ``log`` (``xla_math.log``), contracts the add of the reference
# loss into a fused multiply-add, divides by 10 as a multiply by f32(0.1),
# and its pow is correctly rounded. Mirrored in float64 steps, the SNR
# matches its bits.
_DB_PER_NEPER = float(torch.tensor(1.0 / math.log(10.0),
                                   dtype=torch.float32) * 10.0)


def _pow10(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``10 ** x``."""
    return torch.pow(10.0, x.double()).to(torch.float32)


def path_gain_jax(dist_m: torch.Tensor, cp: ChannelParams) -> torch.Tensor:
    k = cp.path_loss_exponent * _DB_PER_NEPER
    loss_db = (xla_math.log(dist_m).double() * k.double()
               + cp.ref_loss_db.double()).to(torch.float32)
    return _pow10(-loss_db * 0.1)


def sample_fading_jax(key: torch.Tensor, n: int) -> torch.Tensor:
    """Rayleigh block fading power |h|^2 ~ Exp(1), i.i.d. per round."""
    return trandom.exponential(key, (n,))


def snr_jax(dist_m, fading, cp: ChannelParams, bandwidth_hz=None):
    rx, n0 = snr_parts_jax(dist_m, fading, cp, bandwidth_hz)
    return rx / n0


def snr_parts_jax(dist_m, fading, cp: ChannelParams, bandwidth_hz=None):
    """``(received power, noise power)``, whose quotient is the SNR."""
    bw = bandwidth_hz if bandwidth_hz is not None else cp.bandwidth_hz
    p = _pow10((cp.tx_power_dbm - 30.0) * 0.1)
    n0 = _pow10(cp.noise_dbw_per_hz * 0.1) * bw
    return p * path_gain_jax(dist_m, cp) * fading, n0


def downlink_snr_jax(dist_m, fading, cp: ChannelParams, bandwidth_hz=None):
    """Broadcast (BS -> device) SNR at ``bs_power_dbm`` over the full cell
    bandwidth by default; ``fading`` is the downlink slot's own draw."""
    bw = bandwidth_hz if bandwidth_hz is not None else cp.bandwidth_hz
    p = _pow10((cp.bs_power_dbm - 30.0) * 0.1)
    n0 = _pow10(cp.noise_dbw_per_hz * 0.1) * bw
    return p * path_gain_jax(dist_m, cp) * fading / n0


def shannon_rate_jax(snr_lin: torch.Tensor, bandwidth_hz) -> torch.Tensor:
    """bits/s (eq. 40 up to the orthogonal-subchannel split)."""
    return bandwidth_hz * torch.log2(1.0 + snr_lin)


def comm_latency_jax(bits, rate_bps: torch.Tensor) -> torch.Tensor:
    """L_comm = d / R (paper §III); a non-positive rate is an outage with
    ``inf`` latency (the division is guarded, so no NaN appears)."""
    tiny = torch.finfo(torch.float32).tiny
    lat = bits / torch.clamp_min(rate_bps, tiny)
    return torch.where(rate_bps > 0.0, lat, torch.full_like(lat, torch.inf))
