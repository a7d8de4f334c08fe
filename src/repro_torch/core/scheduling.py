"""Device selection / scheduling policies (paper §III), port of
``repro/core/scheduling.py``.

Two layers, as in the reference:

* **numpy reference policies** (top half, copied): host-side per-round
  logic mapping channel gains, ages, update norms and latencies to a 0/1
  participation mask;
* **the engine's policy registry** (bottom half): a policy maps a static
  :class:`PolicyConfig` and the round's :class:`RoundState` to an (N,) bool
  mask of scheduled devices. Rankings are stable sorts, so ties break by
  device index as in the reference; the two greedy policies (``deadline``,
  ``age``) are the reference's fixed-trip loops, which stop early here once
  they are done (later trips change nothing).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as trandom


def _mask(n: int, idx: np.ndarray) -> np.ndarray:
    m = np.zeros(n, dtype=bool)
    m[np.asarray(idx, dtype=int)] = True
    return m


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------
def random_schedule(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    return _mask(n, rng.choice(n, size=k, replace=False))


def round_robin(t: int, n: int, k: int) -> np.ndarray:
    """G = N/K groups scheduled cyclically."""
    n_groups = max(1, n // k)
    g = t % n_groups
    idx = np.arange(g * k, min((g + 1) * k, n))
    return _mask(n, idx)


def proportional_fair(inst_snr: np.ndarray, avg_snr: np.ndarray, k: int
                      ) -> np.ndarray:
    """Top-K of instantaneous/time-averaged SNR ratio (§III.2)."""
    ratio = inst_snr / np.maximum(avg_snr, 1e-12)
    idx = np.argsort(-ratio)[:k]
    return _mask(len(inst_snr), idx)


def latency_minimal(comm_latency: np.ndarray, comp_latency: np.ndarray, k: int
                    ) -> np.ndarray:
    """Eq. (37) with fixed power: schedule the K devices minimizing
    max(L_comm + L_comp)."""
    total = comm_latency + comp_latency
    idx = np.argsort(total)[:k]
    return _mask(len(total), idx)


def best_channel(gains: np.ndarray, k: int) -> np.ndarray:
    """BC policy (§III.3)."""
    idx = np.argsort(-gains)[:k]
    return _mask(len(gains), idx)


# ---------------------------------------------------------------------------
# Update-aware policies [62] (§III.3)
# ---------------------------------------------------------------------------
def best_norm(update_norms: np.ndarray, k: int) -> np.ndarray:
    """BN2: top-K l2 norms of the local updates."""
    idx = np.argsort(-update_norms)[:k]
    return _mask(len(update_norms), idx)


def bc_bn2(gains: np.ndarray, update_norms: np.ndarray, k_c: int, k: int
           ) -> np.ndarray:
    """BC-BN2: preselect K_c by channel, pick K of those by norm."""
    pre = np.argsort(-gains)[:k_c]
    chosen = pre[np.argsort(-update_norms[pre])[:k]]
    return _mask(len(gains), chosen)


def quantized_norm(update_norms: np.ndarray, rates_bps: np.ndarray,
                   d_params: int, round_seconds: float) -> np.ndarray:
    """Post-quantization update fidelity model for BN2-C: a device that can
    push b bits/param keeps ~(1 - 2^-b) of its update norm (uniform
    quantization SNR). Sole-transmitter assumption per [62]."""
    bits_total = rates_bps * round_seconds
    bits_per_param = np.maximum(bits_total / max(d_params, 1), 1e-3)
    fidelity = 1.0 - 2.0 ** (-np.minimum(bits_per_param, 32.0))
    return update_norms * fidelity


def bn2_c(update_norms: np.ndarray, rates_bps: np.ndarray, d_params: int,
          round_seconds: float, k: int) -> np.ndarray:
    """BN2-C: rank by the norm each device would deliver *after* channel-
    driven quantization, were it the sole transmitter."""
    eff = quantized_norm(update_norms, rates_bps, d_params, round_seconds)
    idx = np.argsort(-eff)[:k]
    return _mask(len(update_norms), idx)


# ---------------------------------------------------------------------------
# Age-based scheduling [58] (§III.1, P2/P3 greedy)
# ---------------------------------------------------------------------------
def f_alpha(x: np.ndarray, alpha: float) -> np.ndarray:
    """Fairness utility (eq. after (38))."""
    x = np.asarray(x, dtype=float)
    if alpha == 1.0:
        return np.log1p(x)
    return (x ** (1.0 - alpha)) / (1.0 - alpha)


def update_ages(ages: np.ndarray, scheduled: np.ndarray) -> np.ndarray:
    """Age recursion: 0 if scheduled else age+1."""
    return np.where(scheduled, 0, ages + 1)


def min_subchannels(snr_per_sub: np.ndarray, r_min: float, sub_bw: float,
                    max_sub: int) -> int:
    """P3 greedy: allocate best subchannels (equal power) until the Shannon
    sum-rate clears R_min. Returns the count, or max_sub+1 if infeasible."""
    order = np.argsort(-snr_per_sub)
    rate = 0.0
    for j, s in enumerate(order[:max_sub], start=1):
        # equal power split across the j allocated subchannels
        rate = j * sub_bw * np.log2(1.0 + snr_per_sub[order[:j]].mean() / j)
        if rate >= r_min:
            return j
    return max_sub + 1


def age_based_greedy(ages: np.ndarray, snr_matrix: np.ndarray, r_min: float,
                     sub_bw: float, n_subchannels: int, alpha: float = 1.0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Two-phase greedy of [58] for P2.

    snr_matrix: (N, W) per-device per-subchannel SNR. Iteratively add the
    device maximizing f_alpha(age)/|W_i| (eq. 45), removing its subchannels,
    until no device fits. Returns (scheduled mask, n_subchannels used per dev).
    """
    n = len(ages)
    available = np.ones(n_subchannels, dtype=bool)
    scheduled = np.zeros(n, dtype=bool)
    used = np.zeros(n, dtype=int)
    while True:
        best_dev, best_ratio, best_need = -1, -np.inf, 0
        n_avail = int(available.sum())
        if n_avail == 0:
            break
        for i in range(n):
            if scheduled[i]:
                continue
            need = min_subchannels(snr_matrix[i, available], r_min, sub_bw, n_avail)
            if need > n_avail:
                continue
            ratio = f_alpha(np.array([ages[i] + 1.0]), alpha)[0] / need
            if ratio > best_ratio:
                best_dev, best_ratio, best_need = i, ratio, need
        if best_dev < 0:
            break
        # P3 for the winner: take its best available subchannels
        avail_idx = np.nonzero(available)[0]
        order = np.argsort(-snr_matrix[best_dev, avail_idx])[:best_need]
        available[avail_idx[order]] = False
        scheduled[best_dev] = True
        used[best_dev] = best_need
    return scheduled, used


# ---------------------------------------------------------------------------
# Deadline-constrained selection P4 [61] (§III.2)
# ---------------------------------------------------------------------------
def deadline_greedy(comm_latency: np.ndarray, comp_latency: np.ndarray,
                    t_max: float, candidates: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    """Nishio-Yonetani greedy for P4 (eqs. 57-58): iteratively append the
    device adding the least extra round time, where computation overlaps the
    cumulative upload time of earlier devices (devices upload one-by-one)."""
    n = len(comm_latency)
    pool = list(np.nonzero(candidates)[0]) if candidates is not None else list(range(n))
    chosen: list[int] = []

    def round_time(order: list[int]) -> float:
        t_upload = 0.0
        for i in order:
            start = max(t_upload, comp_latency[i])  # can't upload before computed
            t_upload = start + comm_latency[i]
        return t_upload

    while pool:
        best, best_t = None, np.inf
        for i in pool:
            t = round_time(chosen + [i])
            if t < best_t:
                best, best_t = i, t
        if best is None or best_t > t_max:
            break
        chosen.append(best)
        pool.remove(best)
    return _mask(n, np.array(chosen, dtype=int))


# ===========================================================================
# The engine's policy registry
# ===========================================================================
class RoundState(NamedTuple):
    """Per-round inputs every policy sees."""
    t: int                       # round index
    key: torch.Tensor            # key for stochastic policies
    snr_lin: torch.Tensor        # (N,) instantaneous linear SNR
    avg_snr: torch.Tensor        # (N,) time-averaged SNR (EMA)
    rates: torch.Tensor          # (N,) Shannon rate, bits/s
    comm_lat: torch.Tensor       # (N,) upload latency, s
    comp_lat: torch.Tensor       # (N,) compute latency, s
    ages: torch.Tensor           # (N,) rounds since last scheduled
    update_norms: torch.Tensor   # (N,) observed update-norm proxies
    # (received power, noise power) whose quotient is snr_lin, where the
    # engine hands them over: the reference's compiled PF score folds
    # (rx / n0) / avg into rx / (n0 * avg), which breaks round 0's ties
    snr_parts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Static policy parameters."""
    n_devices: int
    n_scheduled: int
    model_bits: float = 1e6
    deadline_s: float = 5.0
    age_alpha: float = 1.0
    sub_bw: float = 1e6          # bandwidth_hz / n_subchannels
    n_subchannels: int = 20


PolicyFn = Callable[[PolicyConfig, RoundState], torch.Tensor]


def masked_round_state(st: RoundState, m: torch.Tensor,
                       key: torch.Tensor | None = None) -> RoundState:
    """View of the round state where devices outside the boolean mask ``m``
    look unschedulable to every score-based policy: zero SNR and norms,
    infinite comm/comp latency. Index-based policies (random /
    round_robin) ignore scores, so callers must still ``& m`` the mask."""
    st2 = st._replace(
        snr_lin=torch.where(m, st.snr_lin, 0.0),
        avg_snr=torch.where(m, st.avg_snr, 1.0),
        rates=torch.where(m, st.rates, 1e-9),
        comm_lat=torch.where(m, st.comm_lat, torch.inf),
        comp_lat=torch.where(m, st.comp_lat, torch.inf),
        # the reference scores this masked SNR (a select) unfolded
        update_norms=torch.where(m, st.update_norms, 0.0), snr_parts=None)
    return st2 if key is None else st2._replace(key=key)


def _mask_of(idx: torch.Tensor, n: int) -> torch.Tensor:
    mask = torch.zeros(n, dtype=torch.bool, device=idx.device)
    mask[idx] = True
    return mask


def topk_mask_jax(score: torch.Tensor, k: int) -> torch.Tensor:
    """Mask of the k highest scores (ties broken by index)."""
    return _mask_of(torch.argsort(-score, stable=True)[:k], score.shape[0])


def _random(pcfg: PolicyConfig, st: RoundState) -> torch.Tensor:
    perm = trandom.permutation(st.key, pcfg.n_devices)
    return _mask_of(perm[:pcfg.n_scheduled], pcfg.n_devices)


def _round_robin(pcfg: PolicyConfig, st: RoundState) -> torch.Tensor:
    n, k = pcfg.n_devices, pcfg.n_scheduled
    g = st.t % max(1, n // k)
    i = torch.arange(n, device=st.snr_lin.device)
    return (i >= g * k) & (i < (g + 1) * k)


def _best_channel(pcfg: PolicyConfig, st: RoundState) -> torch.Tensor:
    return topk_mask_jax(st.snr_lin, pcfg.n_scheduled)


def _latency(pcfg: PolicyConfig, st: RoundState) -> torch.Tensor:
    return topk_mask_jax(-(st.comm_lat + st.comp_lat), pcfg.n_scheduled)


def _pf(pcfg: PolicyConfig, st: RoundState) -> torch.Tensor:
    """Proportional fair (§III.2): instantaneous over time-averaged SNR."""
    avg = torch.clamp_min(st.avg_snr, 1e-12)
    if st.snr_parts is None:
        ratio = st.snr_lin / avg
    else:
        rx, n0 = st.snr_parts
        ratio = rx / (n0 * avg)
    return topk_mask_jax(ratio, pcfg.n_scheduled)


def _bn2(pcfg: PolicyConfig, st: RoundState) -> torch.Tensor:
    return topk_mask_jax(st.update_norms, pcfg.n_scheduled)


def _bc_bn2(pcfg: PolicyConfig, st: RoundState) -> torch.Tensor:
    pre = topk_mask_jax(st.snr_lin, min(2 * pcfg.n_scheduled,
                                        pcfg.n_devices))
    eff = torch.where(pre, st.update_norms,
                      torch.full_like(st.update_norms, -torch.inf))
    return topk_mask_jax(eff, pcfg.n_scheduled)


def _bn2_c(pcfg: PolicyConfig, st: RoundState) -> torch.Tensor:
    d_params = max(int(pcfg.model_bits / 32), 1)
    bits_per_param = torch.clamp_min(st.rates * pcfg.deadline_s / d_params,
                                     1e-3)
    fidelity = 1.0 - torch.pow(2.0, -torch.clamp_max(bits_per_param, 32.0))
    return topk_mask_jax(st.update_norms * fidelity, pcfg.n_scheduled)


def _deadline(pcfg: PolicyConfig, st: RoundState) -> torch.Tensor:
    """Nishio-Yonetani greedy (P4, eqs. 57-58): devices upload one by one;
    appending candidate i gives round time max(t_upload, L_comp_i) +
    L_comm_i; take the argmin while it meets the deadline."""
    n = pcfg.n_devices
    chosen = torch.zeros(n, dtype=torch.bool, device=st.snr_lin.device)
    t_cur = torch.zeros((), dtype=torch.float32, device=st.snr_lin.device)
    for _ in range(n):
        cand_t = torch.maximum(t_cur, st.comp_lat) + st.comm_lat
        cand_t = torch.where(chosen, torch.full_like(cand_t, torch.inf),
                             cand_t)
        best = torch.argmin(cand_t)
        if not bool(cand_t[best] <= pcfg.deadline_s):
            break
        chosen[best] = True
        t_cur = cand_t[best]
    return chosen


def _f_alpha(x: torch.Tensor, alpha: float) -> torch.Tensor:
    if alpha == 1.0:
        return torch.log1p(x)
    return (x ** (1.0 - alpha)) / (1.0 - alpha)


def age_greedy_jax(ages: torch.Tensor, snr_mat: torch.Tensor, r_min: float,
                   sub_bw: float, alpha: float = 1.0) -> torch.Tensor:
    """Two-phase greedy of [58] for P2/P3: each trip schedules the device
    with the best f_alpha(age+1)/need, where ``need`` is the number of its
    best available subchannels that clear ``r_min``; it takes them."""
    n, w = snr_mat.shape
    dev = snr_mat.device
    j = torch.arange(1, w + 1, dtype=torch.float32, device=dev)
    available = torch.ones(w, dtype=torch.bool, device=dev)
    scheduled = torch.zeros(n, dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(-torch.inf, device=dev)
    f_age = _f_alpha(ages + 1.0, alpha)
    for _ in range(w):
        n_avail = available.sum()
        snr_av = torch.where(available[None, :], snr_mat, neg_inf)
        s_sorted = -torch.sort(-snr_av, dim=1).values
        s_sorted = torch.where(torch.isfinite(s_sorted), s_sorted,
                               torch.zeros_like(s_sorted))
        csum = torch.cumsum(s_sorted, dim=1)
        rate_j = j * sub_bw * torch.log2(1.0 + csum / (j * j))
        feasible_j = (rate_j >= r_min) & (j <= n_avail)
        need = torch.where(feasible_j, j, torch.full_like(j, w + 1.0)
                           ).amin(dim=1)
        ratio = f_age / need
        eligible = (~scheduled) & (need <= n_avail)
        ratio = torch.where(eligible, ratio, neg_inf)
        best = torch.argmax(ratio)
        if not bool(torch.isfinite(ratio[best])):
            break
        score = torch.where(available, snr_mat[best], neg_inf)
        rank = torch.argsort(torch.argsort(-score, stable=True), stable=True)
        available = available & ~(rank < need[best])
        scheduled[best] = True
    return scheduled


def _age(pcfg: PolicyConfig, st: RoundState) -> torch.Tensor:
    n, w = pcfg.n_devices, pcfg.n_subchannels
    snr_mat = st.snr_lin[:, None] * trandom.exponential(st.key, (n, w))
    return age_greedy_jax(st.ages, snr_mat, pcfg.model_bits / pcfg.deadline_s,
                          pcfg.sub_bw, pcfg.age_alpha)


_POLICIES: Dict[str, PolicyFn] = {
    "random": _random,
    "round_robin": _round_robin,
    "best_channel": _best_channel,
    "latency": _latency,
    "pf": _pf,
    "bn2": _bn2,
    "bc_bn2": _bc_bn2,
    "bn2_c": _bn2_c,
    "deadline": _deadline,
    "age": _age,
}


def get_policy(name: str) -> PolicyFn:
    """Registry lookup: policy name -> mask function."""
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; known: {sorted(_POLICIES)}") from None


def policy_names() -> Tuple[str, ...]:
    return tuple(_POLICIES)


MixtureFn = Callable[[PolicyConfig, RoundState, torch.Tensor], torch.Tensor]


def get_policy_mixture(names: Tuple[str, ...]) -> MixtureFn:
    """One-hot policy mixture over the enabled set ``names``:
    ``mixture(pcfg, st, w) -> (N,) bool`` evaluates every enabled policy's
    mask and selects by the float32 weights ``w`` of shape ``(len(names),)``
    through ``einsum("p,pn->n", w, masks) > 0.5``. A one-hot ``w`` gives
    exactly ``get_policy(names[p])(pcfg, st)``."""
    names = tuple(names)
    if len(names) != len(set(names)):
        raise ValueError(f"duplicate policy names in mixture: {names}")
    fns = tuple(get_policy(n) for n in names)

    def mixture(pcfg: PolicyConfig, st: RoundState, w: torch.Tensor
                ) -> torch.Tensor:
        masks = torch.stack([fn(pcfg, st) for fn in fns])  # (P, N) bool
        sel = torch.einsum("p,pn->n", w.to(torch.float32),
                           masks.to(torch.float32))
        return sel > 0.5

    return mixture


def policy_onehot(name: str, names: Tuple[str, ...],
                  device=None) -> torch.Tensor:
    """float32 one-hot weights selecting ``name`` out of ``names``."""
    names = tuple(names)
    if name not in names:
        raise ValueError(f"policy {name!r} not in enabled set {names}")
    w = torch.zeros(len(names), dtype=torch.float32, device=device)
    w[names.index(name)] = 1.0
    return w


def update_ages_jax(ages: torch.Tensor, scheduled: torch.Tensor
                    ) -> torch.Tensor:
    """Age recursion: 0 if scheduled else age + 1."""
    return torch.where(scheduled, torch.zeros_like(ages), ages + 1.0)
