"""Sweep-native auto-tuner, port of ``repro/fl/tune.py``: "the best
schedule and compressor for this cell" as one call.

Candidates are (policy, compression, n_scheduled, k, lr). Policy, k, lr and
seed are per-variant axes of one :func:`runtime.run_sweep` call; the
``(n_scheduled, compression)`` pair keys an engine. So the tuner runs
successive halving over those static groups (each rung one sweep per
surviving group at a growing number of seeds, keeping the best
``1/reduction`` of the groups), then optionally a discrete bisection over
``n_scheduled`` around the winner (``score(m) <= score(m + 1)`` keeps the
left half).

Scoring: the loss at the last round whose cumulative latency fits
``budget_s`` and whose cumulative DP epsilon fits ``eps_budget`` (the final
loss with neither; ``inf`` when no round fits), averaged over seeds.
``TuneResult.n_traces`` counts ``runtime.ENGINE_STATS["traces"]``: what the
reference would compile for the same call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core import scheduling, wireless
from repro_torch.core.algorithms.registry import AlgoParams, algo_params
from repro_torch.core.compression.registry import (CompressionParams,
                                                   compression_params)
from repro_torch.fl import runtime as rt


class Candidate(NamedTuple):
    """One point of the tuning space. ``policy`` / ``k`` / ``lr`` are sweep
    axes; ``n_scheduled`` / ``compression`` key an engine. Its ``repr``
    breaks ties between equal scores, as the reference's does."""
    policy: str
    compression: str
    n_scheduled: int
    k: int
    lr: float


@dataclasses.dataclass
class RungRecord:
    rung: int
    n_seeds: int
    groups: List[Tuple[int, str]]        # surviving (n_scheduled, comp)
    best: Candidate
    best_score: float


@dataclasses.dataclass
class TuneResult:
    best: Candidate
    best_score: float
    history: List[RungRecord]
    scores: Dict[Candidate, float]       # last (highest-fidelity) score seen
    refined_n_scheduled: Optional[int]   # bisection result (None if off)
    n_traces: int                        # engine traces this tune() caused
    n_variants: int                      # total simulated variants run


def loss_at_budget(logs: rt.SimLogs, budget_s: Optional[float],
                   eps_budget: Optional[float] = None) -> np.ndarray:
    """Per-variant score: the loss at the last round whose cumulative
    latency fits ``budget_s`` and whose cumulative epsilon fits
    ``eps_budget`` (the final loss with neither, ``inf`` if no round fits).
    Both feasibility sets are prefixes of the rounds, so their AND is one
    too. Without a DP mechanism (epsilon +inf or ``None``) an
    ``eps_budget`` scores ``inf``."""
    loss = np.asarray(logs.loss)
    if budget_s is None and eps_budget is None:
        return loss[..., -1]
    fits = np.ones(loss.shape, dtype=bool)
    if budget_s is not None:
        fits &= np.asarray(logs.latency_s) <= budget_s
    if eps_budget is not None:
        eps = (np.asarray(logs.epsilon) if logs.epsilon is not None
               else np.full(loss.shape, np.inf))
        fits &= eps <= eps_budget
    idx = fits.cumsum(-1).argmax(-1)             # index of the last True
    picked = np.take_along_axis(loss, idx[..., None], axis=-1)[..., 0]
    return np.where(fits.any(-1), picked, np.inf)


def _score_group(cfg: rt.SimConfig, loss_fn, init_params, batches, *,
                 n_scheduled: int, comp: str, seeds: Sequence[int],
                 policies: Sequence[str], cps: Sequence[CompressionParams],
                 k_grid: Sequence[int], aps: Sequence[AlgoParams],
                 lr_grid: Sequence[float], wcfg, eval_batch, budget_s,
                 eps_budget, devices, mesh, device
                 ) -> Dict[Candidate, float]:
    """One sweep for an (n_scheduled, compression) group over policy x k x
    lr x seed, scored and averaged over the seeds."""
    cfg_g = dataclasses.replace(cfg, n_scheduled=n_scheduled,
                                compression=comp)
    out = rt.run_sweep(cfg_g, loss_fn, init_params, batches,
                       seeds=list(seeds),
                       wcfgs=[wcfg] if wcfg is not None else None,
                       policies=list(policies), cparams_grid=list(cps),
                       aparams_grid=list(aps), eval_batch=eval_batch,
                       devices=devices, mesh=mesh, device=device)
    scores: Dict[Candidate, float] = {}
    for pol in policies:
        s = loss_at_budget(out[pol], budget_s, eps_budget)
        s = s.reshape(len(seeds), len(cps), len(aps))
        s = np.where(np.isfinite(s), s, np.inf).mean(axis=0)
        for i, k in enumerate(k_grid):
            for j, lr in enumerate(lr_grid):
                scores[Candidate(pol, comp, n_scheduled, k, lr)] = float(
                    s[i, j])
    return scores


def _binsearch_n_scheduled(score_fn: Callable[[int], float], lo: int,
                           hi: int) -> Tuple[int, Dict[int, float]]:
    """Discrete bisection for a unimodal score (``score(m) <= score(m+1)``
    keeps the left half). Returns the argmin over every probed budget and
    the probes."""
    cache: Dict[int, float] = {}

    def s(n_s: int) -> float:
        if n_s not in cache:
            cache[n_s] = score_fn(n_s)
        return cache[n_s]

    while hi - lo > 1:
        mid = (lo + hi) // 2
        if s(mid) <= s(mid + 1):
            hi = mid
        else:
            lo = mid + 1
    s(lo), s(hi)
    best = min(cache, key=lambda n_s: (cache[n_s], n_s))
    return best, cache


def tune(cfg: rt.SimConfig, loss_fn, init_params: Dict[str, Any],
         batches, *, seeds: Sequence[int] = (0, 1, 2),
         wcfg: Optional[wireless.WirelessConfig] = None,
         policies: Optional[Sequence[str]] = None,
         compressions: Optional[Sequence[str]] = None,
         n_scheduled_grid: Optional[Sequence[int]] = None,
         k_grid: Optional[Sequence[int]] = None,
         lr_grid: Optional[Sequence[float]] = None,
         budget_s: Optional[float] = None,
         eps_budget: Optional[float] = None,
         eval_batch=None, reduction: int = 2,
         refine_n_scheduled: bool = False,
         devices=None, mesh=None, device="cuda") -> TuneResult:
    """Tune (policy, compression, n_scheduled, k, lr) for one cell on
    ``device``: successive halving over the ``(n_scheduled, compression)``
    groups at a growing seed count, then (``refine_n_scheduled=True``) a
    bisection of ``n_scheduled`` around the winner. Scores are
    seed-averaged :func:`loss_at_budget` values, lower is better."""
    policies = (list(policies) if policies
                else list(scheduling.policy_names()))
    compressions = (list(compressions) if compressions
                    else [cfg.compression])
    n_grid = (sorted(set(n_scheduled_grid)) if n_scheduled_grid
              else [cfg.n_scheduled])
    cpu = torch.device("cpu")
    k_grid = sorted(set(k_grid)) if k_grid else [
        int(rt._resolve_cparams(cfg, rt._on(init_params, cpu), cpu).k)]
    lr_grid = (list(lr_grid) if lr_grid
               else [float(rt._resolve_aparams(cfg, cpu).lr)])
    seeds = list(seeds)
    if reduction < 2:
        raise ValueError(f"reduction must be >= 2, got {reduction}")
    for n_s in n_grid:
        if not 1 <= n_s <= cfg.n_devices:
            raise ValueError(f"n_scheduled_grid entry {n_s} outside "
                             f"[1, n_devices={cfg.n_devices}]")
    cps = [compression_params(k=k) for k in k_grid]
    aps = [algo_params(lr=lr) for lr in lr_grid]
    common = dict(wcfg=wcfg, eval_batch=eval_batch, budget_s=budget_s,
                  eps_budget=eps_budget, devices=devices, mesh=mesh,
                  device=device)

    traces0 = rt.ENGINE_STATS["traces"]
    n_variants = 0
    groups: List[Tuple[int, str]] = [
        (n_s, c) for n_s in n_grid for c in compressions]
    scores: Dict[Candidate, float] = {}
    history: List[RungRecord] = []
    rung = 0
    while True:
        fidelity = (len(seeds) if len(groups) == 1
                    else min(len(seeds), reduction ** rung))
        rung_seeds = seeds[:fidelity]
        rung_scores: Dict[Candidate, float] = {}
        for n_s, comp in groups:
            rung_scores.update(_score_group(
                cfg, loss_fn, init_params, batches, n_scheduled=n_s,
                comp=comp, seeds=rung_seeds, policies=policies, cps=cps,
                k_grid=k_grid, aps=aps, lr_grid=lr_grid, **common))
            n_variants += len(rung_seeds) * len(policies) * len(cps) * len(aps)
        scores.update(rung_scores)
        best_c = min(rung_scores, key=lambda c: (rung_scores[c], repr(c)))
        history.append(RungRecord(rung=rung, n_seeds=fidelity,
                                  groups=list(groups), best=best_c,
                                  best_score=rung_scores[best_c]))
        if len(groups) == 1 or fidelity >= len(seeds):
            break

        # keep the top 1/reduction groups, ranked by their best candidate
        def group_score(g: Tuple[int, str]) -> float:
            return min(v for c, v in rung_scores.items()
                       if (c.n_scheduled, c.compression) == g)
        keep = max(1, math.ceil(len(groups) / reduction))
        groups = sorted(groups, key=group_score)[:keep]
        rung += 1

    best, best_score = history[-1].best, history[-1].best_score
    refined: Optional[int] = None
    if refine_n_scheduled:
        cp = [compression_params(k=best.k)]
        ap = [algo_params(lr=best.lr)]

        def probe(n_s: int) -> float:
            nonlocal n_variants
            got = _score_group(
                cfg, loss_fn, init_params, batches, n_scheduled=n_s,
                comp=best.compression, seeds=seeds, policies=[best.policy],
                cps=cp, k_grid=[best.k], aps=ap, lr_grid=[best.lr], **common)
            n_variants += len(seeds)
            return next(iter(got.values()))

        refined, probes = _binsearch_n_scheduled(probe, 1, cfg.n_devices)
        if probes[refined] < best_score:
            best = best._replace(n_scheduled=refined)
            best_score = probes[refined]
        for n_s, v in probes.items():
            scores[best._replace(n_scheduled=n_s)] = v

    return TuneResult(best=best, best_score=best_score, history=history,
                      scores=scores, refined_n_scheduled=refined,
                      n_traces=rt.ENGINE_STATS["traces"] - traces0,
                      n_variants=n_variants)
