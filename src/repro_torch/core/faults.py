"""The parts of ``repro/core/faults.py`` the fault-free engine uses: the
downlink's own fading stream and fedbuff's staleness discount. The rest of
the fault layer (churn, dropout, stragglers, retries) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch.core import chunking

# domain-separation tag of the downlink stream (``DOWNLINK_FOLD`` of the
# reference): folding the round key under it never shifts another stream
DOWNLINK_FOLD = 0xD0DE


def downlink_fading(kt: torch.Tensor, n: int) -> torch.Tensor:
    """I.i.d. Rayleigh power for the broadcast slot, one per-client key
    each, so the stream is invariant to how clients are batched."""
    keys = chunking.client_keys(trandom.fold_in(kt, DOWNLINK_FOLD),
                                torch.arange(n, device=kt.device))
    return trandom.exponential(keys, ())


def staleness_weights(aparams, staleness: torch.Tensor) -> torch.Tensor:
    """FedBuff's polynomial staleness discount ``(1 + tau)^-pow``. With
    ``staleness_pow == 0`` it is exactly 1.0 (not ``x^-0``): multiplying a
    message by 1.0 is an IEEE identity, which keeps fedbuff with no
    discount bitwise equal to fedavg."""
    pw = aparams.staleness_pow
    return torch.where(pw > 0, (1.0 + staleness) ** (-pw),
                       torch.ones_like(staleness))
