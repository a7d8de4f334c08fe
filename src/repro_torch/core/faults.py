"""Fault-layer draws the fault-free engine still makes, port of
``repro/core/faults.py``: the downlink's own fading stream. The rest of the
fault layer (churn, dropout, stragglers, retries) is not ported yet.
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
