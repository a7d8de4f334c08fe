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
from repro_torch.core import wireless

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
    r = hcfg.deploy_radius_m * wireless._sqrt(
        trandom.uniform(k_r, (n_devices,)))
    cos_t, sin_t = wireless._cos_sin(theta)
    pos = torch.stack([r * cos_t, r * sin_t], dim=-1)
    diff = pos[:, None, :] - centers[None, :, :]
    d = wireless._norm_xy(diff[..., 0], diff[..., 1])              # (N, L)
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
