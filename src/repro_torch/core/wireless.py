"""Wireless channel of the engine (paper §III), port of the jnp twins in
``repro/core/wireless.py``: large-scale path loss, Rayleigh block fading and
Shannon rates, driven by threefry keys. Function names mirror the reference.

Static integers stay on :class:`WirelessConfig`; the continuous parameters
are float32 scalar tensors in :class:`ChannelParams`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import random as trandom


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


def sample_positions_jax(key: torch.Tensor, cp: ChannelParams,
                         n_devices: int) -> torch.Tensor:
    """Distances to the BS, uniform in the disk of radius R (>= 1 m)."""
    r = cp.cell_radius_m * torch.sqrt(trandom.uniform(key, (n_devices,)))
    return torch.clamp_min(r, 1.0)


def path_gain_jax(dist_m: torch.Tensor, cp: ChannelParams) -> torch.Tensor:
    loss_db = cp.ref_loss_db + 10.0 * cp.path_loss_exponent * torch.log10(
        dist_m)
    return torch.pow(10.0, -loss_db / 10.0)


def sample_fading_jax(key: torch.Tensor, n: int) -> torch.Tensor:
    """Rayleigh block fading power |h|^2 ~ Exp(1), i.i.d. per round."""
    return trandom.exponential(key, (n,))


def snr_jax(dist_m, fading, cp: ChannelParams, bandwidth_hz=None):
    bw = bandwidth_hz if bandwidth_hz is not None else cp.bandwidth_hz
    p = torch.pow(10.0, (cp.tx_power_dbm - 30.0) / 10.0)
    n0 = torch.pow(10.0, cp.noise_dbw_per_hz / 10.0) * bw
    return p * path_gain_jax(dist_m, cp) * fading / n0


def downlink_snr_jax(dist_m, fading, cp: ChannelParams, bandwidth_hz=None):
    """Broadcast (BS -> device) SNR at ``bs_power_dbm`` over the full cell
    bandwidth by default; ``fading`` is the downlink slot's own draw."""
    bw = bandwidth_hz if bandwidth_hz is not None else cp.bandwidth_hz
    p = torch.pow(10.0, (cp.bs_power_dbm - 30.0) / 10.0)
    n0 = torch.pow(10.0, cp.noise_dbw_per_hz / 10.0) * bw
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
