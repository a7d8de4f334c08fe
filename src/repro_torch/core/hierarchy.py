"""Hierarchical FL (paper §III.A, Alg. 9), port of ``repro/core/hierarchy.py``.

Devices are grouped into L clusters around small-cell base stations (SBS);
intra-cluster averaging runs every round, inter-cluster (via the macro BS)
every H rounds. This module holds the configuration, the hex deployment
geometry, the aggregation steps over stacked ``(N, ...)`` / ``(L, ...)``
parameter dicts and the analytic latency model; the wireless-aware engine
is ``fl/runtime.py::run_hfl``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as trandom

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class HFLConfig:
    n_clusters: int = 7
    inter_cluster_period: int = 4        # H in Alg. 9
    # --- wireless-aware engine (fl/runtime.py run_hfl) --------------------
    # Devices talk to their nearest SBS over the fading channel layer; the
    # SBS<->MBS backhaul is a wired fronthaul at a fixed rate.
    backhaul_rate_bps: float = 1e9       # SBS->MBS fronthaul (per SBS link)
    deploy_radius_m: float = 750.0       # device deployment disk radius
    sbs_pitch_m: float = 500.0           # hex SBS grid pitch
    # --- analytic latency model (hfl_round_latency, Table I) --------------
    fronthaul_speedup: float = 100.0     # MBS<->SBS vs MU<->SBS link speed
    uplink_sparsity: float = 0.01        # MU->SBS (99% sparsification)
    downlink_sparsity: float = 0.10      # SBS->MU
    sbs_up_sparsity: float = 0.10        # SBS->MBS
    sbs_down_sparsity: float = 0.10      # MBS<->SBS
    mbs_rate_penalty: float = 6.0        # MU<->MBS rate is this much worse
                                         # than MU<->SBS (distance/path loss)

    def static_key(self) -> "HFLConfig":
        """Copy with the per-run fields zeroed: what the engine cache keys
        on. ``backhaul_rate_bps`` is a per-run input of the engine (so
        backhaul-rate grids share one engine); everything else (cluster
        count, H, geometry) shapes the engine and stays."""
        return dataclasses.replace(self, backhaul_rate_bps=0.0)


def assign_clusters_hex(positions_xy: np.ndarray, centers_xy: np.ndarray
                        ) -> np.ndarray:
    """Nearest-SBS assignment (hexagonal layout in the chapter's example)."""
    d = np.linalg.norm(positions_xy[:, None, :] - centers_xy[None, :, :],
                       axis=-1)
    return np.argmin(d, axis=1)


def hex_centers(n_clusters: int = 7, pitch_m: float = 500.0) -> np.ndarray:
    """Center cell + 6 neighbours (the chapter's 7-hex layout)."""
    if not 1 <= n_clusters <= 7:
        raise ValueError(
            f"hex_centers supports the chapter's 7-hex layout (center + 6 "
            f"neighbours); n_clusters={n_clusters} would duplicate center "
            "positions (the angle wraps after 6 neighbours), leaving "
            "permanently empty clusters")
    pts = [(0.0, 0.0)]
    for k in range(n_clusters - 1):
        ang = 2 * np.pi * k / 6
        pts.append((pitch_m * np.cos(ang), pitch_m * np.sin(ang)))
    return np.asarray(pts[:n_clusters])


# The reference's CPU arithmetic for the deployment, held bitwise: its cos
# and sin are the C library's cosf/sinf, which reduce by pi/2 and evaluate
# these polynomials in float64 (the coefficients of glibc's sincosf tables);
# its sqrt is correctly rounded, which PyTorch's float32 CPU sqrt is not
# everywhere. Every step is one float64 op, so the card computes the same
# bits as the CPU.
_HPI_INV = float.fromhex("0x1.45f306dc9c883p-1")   # 2 / pi
_HPI = float.fromhex("0x1.921fb54442d18p0")        # pi / 2
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
    """float32 ``(cos, sin)`` of float32 angles with ``|theta| < 120``, as
    the C library's cosf/sinf compute them: reduce by pi/2 to ``|x| <=
    pi/4`` with quadrant n, evaluate the even and odd polynomials, and swap
    and negate them by the quadrant."""
    x = theta.double()
    n = torch.round(x * _HPI_INV)
    x = x - n * _HPI
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


def hfl_geometry_xy_jax(key: torch.Tensor, hcfg: HFLConfig, n_devices: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor]:
    """Device deployment for the wireless-aware HFL engine, on ``key``'s
    device: ``n_devices`` uniform in the deployment disk, each assigned to
    its nearest SBS on the hex grid. Returns ``(pos_xy (N, 2) m,
    cluster_ids (N,) int32, dist_to_sbs (N,) m, member (L, N) bool,
    cluster_sizes (L,) float32)``."""
    dev = key.device
    centers = torch.tensor(hex_centers(hcfg.n_clusters, hcfg.sbs_pitch_m),
                           dtype=torch.float32, device=dev)
    k_r, k_t = trandom.split(key)
    theta = trandom.uniform(k_t, (n_devices,)) * (2.0 * math.pi)
    r = hcfg.deploy_radius_m * _sqrt(trandom.uniform(k_r, (n_devices,)))
    cos_t, sin_t = _cos_sin(theta)
    pos = torch.stack([r * cos_t, r * sin_t], dim=-1)
    diff = pos[:, None, :] - centers[None, :, :]
    dx, dy = diff[..., 0], diff[..., 1]
    # the reference's norm contracts dy * dy into a fused multiply-add on
    # the rounded dx * dx (the product is exact in float64)
    d = _sqrt(((dx * dx).double() + dy.double() * dy.double()).to(
        torch.float32))                                             # (N, L)
    cluster_ids = torch.argmin(d, dim=1).to(torch.int32)
    dist_to_sbs = torch.clamp_min(d.amin(dim=1), 1.0)
    member = (cluster_ids[None, :] == torch.arange(
        hcfg.n_clusters, dtype=torch.int32, device=dev)[:, None])  # (L, N)
    cluster_sizes = member.to(torch.float32).sum(dim=1)             # (L,)
    return pos, cluster_ids, dist_to_sbs, member, cluster_sizes


def hfl_geometry_jax(key: torch.Tensor, hcfg: HFLConfig, n_devices: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The pure-HFL engine's 4-tuple (no xy positions); see
    :func:`hfl_geometry_xy_jax`."""
    _, cluster_ids, dist_to_sbs, member, cluster_sizes = (
        hfl_geometry_xy_jax(key, hcfg, n_devices))
    return cluster_ids, dist_to_sbs, member, cluster_sizes


# ---------------------------------------------------------------------------
# Aggregation steps (stacked-client layout, cluster ids as data)
# ---------------------------------------------------------------------------
def intra_cluster_average(client_models: Params, cluster_ids: torch.Tensor,
                          n_clusters: int) -> Params:
    """Per-cluster mean; returns stacked (L, ...) cluster models (Alg. 9
    l.9)."""
    ids = cluster_ids.to(torch.int64)
    onehot = torch.nn.functional.one_hot(ids, n_clusters).to(torch.float32)
    counts = torch.clamp_min(onehot.sum(dim=0), 1.0)               # (L,)

    def leaf(x):
        xf = x.to(torch.float32).reshape(x.shape[0], -1)
        means = (onehot.T @ xf) / counts[:, None]
        return means.reshape((n_clusters,) + tuple(x.shape[1:])).to(x.dtype)
    return {k: leaf(v) for k, v in client_models.items()}


def inter_cluster_average(cluster_models: Params,
                          cluster_sizes: Optional[torch.Tensor] = None
                          ) -> Params:
    """Alg. 9 line 13: global mean over cluster models, weighted by cluster
    population (empty clusters carry zero weight)."""
    if cluster_sizes is None:
        return {k: x.mean(dim=0) for k, x in cluster_models.items()}
    w = cluster_sizes.to(torch.float32)
    w = w / torch.clamp_min(w.sum(), 1.0)

    def leaf(x):
        wb = w.reshape((-1,) + (1,) * (x.dim() - 1))
        return (x.to(torch.float32) * wb).sum(dim=0).to(x.dtype)
    return {k: leaf(v) for k, v in cluster_models.items()}


def broadcast_to_clients(cluster_models: Params,
                         cluster_ids: torch.Tensor) -> Params:
    """Each client pulls its cluster's model."""
    ids = cluster_ids.to(torch.int64)
    return {k: x[ids] for k, x in cluster_models.items()}


# ---------------------------------------------------------------------------
# Latency model (chapter's 5-7x speedup claim)
# ---------------------------------------------------------------------------
def hfl_round_latency(model_bits: float, mu_rate_bps: float, cfg: HFLConfig
                      ) -> Tuple[float, float]:
    """Returns (hfl_round_s, fl_round_s) for one global period.

    HFL: H intra-cluster rounds (sparse MU<->SBS exchange over the short
    SBS link) + one SBS<->MBS exchange over the fast fronthaul. FL: H rounds
    of direct MU<->MBS exchange at the (slower) MU rate.
    """
    h = cfg.inter_cluster_period
    up = model_bits * cfg.uplink_sparsity / mu_rate_bps
    down = model_bits * cfg.downlink_sparsity / mu_rate_bps
    fronthaul_rate = mu_rate_bps * cfg.fronthaul_speedup
    sbs_up = model_bits * cfg.sbs_up_sparsity / fronthaul_rate
    sbs_down = model_bits * cfg.sbs_down_sparsity / fronthaul_rate
    hfl = h * (up + down) + (sbs_up + sbs_down)
    # conventional FL: MU talks to the (farther, weaker-link) MBS directly
    mbs_rate = mu_rate_bps / cfg.mbs_rate_penalty
    fl = h * (model_bits * cfg.uplink_sparsity / mbs_rate
              + model_bits * cfg.downlink_sparsity / mbs_rate)
    return hfl, fl
