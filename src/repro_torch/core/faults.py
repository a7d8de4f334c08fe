"""Fault injection for the engine, port of ``repro/core/faults.py``.

The source paper's devices are heterogeneous and stochastic: links fade and
fail, devices appear and vanish, compute is slow at times. With
``SimConfig.faults`` set the engine (``fl/runtime.py``) draws, per round:

* **dropout**: each scheduled client vanishes mid-round with probability
  ``drop_prob``; its EF / control-variate rows carry forward untouched;
* **churn**: a Gilbert-Elliott availability chain per device
  (``churn_p_off`` on->off, ``churn_p_on`` off->on) in the round state;
  unavailable devices look unschedulable (``scheduling.masked_round_state``);
* **stragglers**: with probability ``straggler_prob`` the compute latency is
  multiplied by a Pareto(``straggler_alpha``) draw >= 1;
* **decode failure + retransmissions**: an uplink below the linear SNR
  ``snr_min`` fails; up to ``SimConfig.max_retries`` retries each re-sample
  the channel and re-price the payload, and every failed attempt is billed;
* **correlated fading**: a complex Gauss-Markov state
  ``h_t = rho h_{t-1} + sqrt(1 - rho^2) w_t`` replaces the i.i.d. power draw
  (``fading_rho = 0`` is i.i.d. Rayleigh).

:class:`FaultParams` holds float32 0-d tensors (stacked along a leading
variant axis by :func:`stack_fault_params`). Every per-device draw is keyed
``fold_in(fold_in(kt, TAG), client_id)``, so a draw depends only on the
round, the tag and the client: it is invariant to client blocks and never
shifts the engine's five legacy round streams.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch import random as trandom
from repro_torch.core import chunking

# domain-separation tags: each fault draw folds the round key kt under its
# own constant, so adding a draw never shifts another stream
CHURN_FOLD = 0xC4A2
DROP_FOLD = 0xD209
STRAGGLER_FOLD = 0x57A6
FADING_FOLD = 0xFAD0
RETRY_FOLD = 0x2E72
DOWNLINK_FOLD = 0xD0DE
D2D_FOLD = 0xD2D0  # device-to-device (gossip/fog) edge channel stream


class FaultParams(NamedTuple):
    """Fault-model parameters as float32 0-d tensors. The defaults (zero
    probabilities, zero decode threshold, uncorrelated fading) make the
    fault machinery a no-op in expectation."""
    drop_prob: torch.Tensor        # per-round mid-round dropout probability
    churn_p_off: torch.Tensor      # Gilbert-Elliott on->off departure prob
    churn_p_on: torch.Tensor       # Gilbert-Elliott off->on arrival prob
    straggler_prob: torch.Tensor   # P(device straggles this round)
    straggler_alpha: torch.Tensor  # Pareto tail index of the slowdown (>1)
    snr_min: torch.Tensor          # linear SNR decode threshold (0 = always)
    fading_rho: torch.Tensor       # Gauss-Markov fading correlation in [0,1)

    def to(self, device) -> "FaultParams":
        return FaultParams(*(f.to(device) for f in self))


def fault_params(drop_prob: float = 0.0, churn_p_off: float = 0.0,
                 churn_p_on: float = 1.0, straggler_prob: float = 0.0,
                 straggler_alpha: float = 2.0, snr_min: float = 0.0,
                 fading_rho: float = 0.0, device=None) -> FaultParams:
    return FaultParams(*(torch.tensor(float(v), dtype=torch.float32,
                                      device=device) for v in (
        drop_prob, churn_p_off, churn_p_on, straggler_prob, straggler_alpha,
        snr_min, fading_rho)))


def default_fault_params(device=None) -> FaultParams:
    return fault_params(device=device)


def stack_fault_params(ps) -> FaultParams:
    """Stack params along a leading variant axis."""
    ps = list(ps)
    return FaultParams(*(torch.stack([getattr(p, f) for p in ps])
                         for f in FaultParams._fields))


# ---------------------------------------------------------------------------
# Per-client draws (chunk-invariant: fold_in(tagged key, client_id))
# ---------------------------------------------------------------------------
def _tagged_keys(key: torch.Tensor, tag: int, n: int) -> torch.Tensor:
    return chunking.client_keys(trandom.fold_in(key, tag),
                                torch.arange(n, device=key.device))


def _client_uniform(key: torch.Tensor, tag: int, n: int) -> torch.Tensor:
    return trandom.uniform(_tagged_keys(key, tag, n), ())


def _client_normal2(key: torch.Tensor, tag: int, n: int) -> torch.Tensor:
    return trandom.normal(_tagged_keys(key, tag, n), (2,))


def churn_step(fp: FaultParams, kt: torch.Tensor,
               avail: torch.Tensor) -> torch.Tensor:
    """One Gilbert-Elliott transition of the (N,) availability mask: an
    available device departs w.p. ``churn_p_off``, an unavailable one
    returns w.p. ``churn_p_on``; one uniform per device decides both."""
    u = _client_uniform(kt, CHURN_FOLD, avail.shape[0])
    return torch.where(avail, u >= fp.churn_p_off, u < fp.churn_p_on)


def gauss_markov_fading(fp: FaultParams, kt: torch.Tensor, fad: torch.Tensor,
                        t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance the (N, 2) complex Gauss-Markov fading state and return
    ``(new_state, power)``. Components are N(0, 1/2), so the power is
    marginally Exp(1); round 0 draws the stationary state."""
    w = _client_normal2(kt, FADING_FOLD, fad.shape[0])
    if t == 0:
        fad = math.sqrt(0.5) * w
    else:
        rho = fp.fading_rho
        fad = rho * fad + torch.sqrt((1.0 - rho * rho) * 0.5) * w
    return fad, (fad * fad).sum(dim=1)


def retry_fading(kt: torch.Tensor, attempt: int, n: int) -> torch.Tensor:
    """Fresh i.i.d. Rayleigh power for retransmission slot ``attempt``
    (>= 1), independent of the round's Gauss-Markov state."""
    k = trandom.fold_in(trandom.fold_in(kt, RETRY_FOLD), attempt)
    return trandom.exponential(
        chunking.client_keys(k, torch.arange(n, device=kt.device)), ())


def d2d_fading(kt: torch.Tensor, n_edges: int) -> torch.Tensor:
    """I.i.d. Rayleigh power per directed device-to-device edge, keyed per
    edge index under :data:`D2D_FOLD` (disjoint from the cell's streams)."""
    return trandom.exponential(_tagged_keys(kt, D2D_FOLD, n_edges), ())


def downlink_fading(kt: torch.Tensor, n: int) -> torch.Tensor:
    """I.i.d. Rayleigh power for the broadcast slot, one per-client key
    each, so the stream is invariant to how clients are batched."""
    return trandom.exponential(_tagged_keys(kt, DOWNLINK_FOLD, n), ())


def dropout_draw(fp: FaultParams, kt: torch.Tensor, n: int) -> torch.Tensor:
    """(N,) bool: True where the device vanishes mid-round."""
    return _client_uniform(kt, DROP_FOLD, n) < fp.drop_prob


def straggler_multiplier(fp: FaultParams, kt: torch.Tensor,
                         n: int) -> torch.Tensor:
    """(N,) compute-latency multiplier: 1.0 for healthy devices, a
    Pareto(``straggler_alpha``) draw >= 1 for the ``straggler_prob``
    fraction that straggle."""
    k = trandom.fold_in(kt, STRAGGLER_FOLD)
    u_sel = _client_uniform(k, 0, n)
    u_mag = _client_uniform(k, 1, n)
    pareto = (1.0 - u_mag) ** (-1.0 / torch.clamp_min(fp.straggler_alpha,
                                                      1e-3))
    return torch.where(u_sel < fp.straggler_prob, pareto,
                       torch.ones_like(pareto))


def staleness_weights(aparams, staleness: torch.Tensor) -> torch.Tensor:
    """FedBuff's polynomial staleness discount ``(1 + tau)^-pow``. With
    ``staleness_pow == 0`` it is exactly 1.0 (not ``x^-0``): multiplying a
    message by 1.0 is an IEEE identity, which keeps fedbuff with no
    discount bitwise equal to fedavg."""
    pw = aparams.staleness_pow
    return torch.where(pw > 0, (1.0 + staleness) ** (-pw),
                       torch.ones_like(staleness))
