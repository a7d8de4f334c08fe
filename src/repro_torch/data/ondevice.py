"""On-device synthetic batch generators for the fleet engine, port of
``repro/data/ondevice.py``.

A ``SimConfig.datagen`` is a function ``datagen(key, ids) -> dict`` with
``(len(ids), H, ...)`` tensors, evaluated one client block at a time on the
engine's device, so data residency is O(chunk * H * B) whatever the fleet
size. Row i depends only on ``(key, ids[i])``: each row draws from its own
``fold_in(key, client_id)`` key.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import chunking


def make_linear_datagen(w_star, *, local_steps: int = 2, batch: int = 8,
                        noise: float = 0.01, seed: Optional[int] = None
                        ) -> Callable:
    """Noisy linear-regression batches toward ``w_star``:
    ``datagen(key, ids) -> {"x": (n, H, B, d), "y": (n, H, B)}``. ``seed``
    (optional) folds a data-stream tag into every key."""
    w_star = (w_star.to(torch.float32) if isinstance(w_star, torch.Tensor)
              else torch.tensor(np.asarray(w_star), dtype=torch.float32))

    def datagen(key: torch.Tensor, ids: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        if seed is not None:
            key = trandom.fold_in(key, seed)
        ks = trandom.split(chunking.client_keys(key, ids))  # (n, 2, 2)
        w = w_star.to(key.device)
        x = trandom.normal(ks[:, 0], (local_steps, batch, w.shape[0]))
        y = x @ w + noise * trandom.normal(ks[:, 1], (local_steps, batch))
        return {"x": x, "y": y}

    return datagen


def make_token_datagen(vocab: int, *, local_steps: int = 2, batch: int = 16,
                       seq: int = 16, n_classes: int = 4,
                       seed: Optional[int] = None) -> Callable:
    """Uniform-token LM batches, ``tokens`` and ``labels`` (n, H, B, S)
    int32, where client class ``id mod n_classes`` draws half its tokens
    from its own band ``[c * vocab / n_classes, ...)`` of width ``vocab //
    n_classes``; labels are the tokens shifted one left (next-token
    targets, wrapping). Returns ``datagen(key, ids)``."""
    shape = (local_steps, batch, seq)
    band = vocab // n_classes

    def datagen(key: torch.Tensor, ids: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        if seed is not None:
            key = trandom.fold_in(key, seed)
        ks = trandom.split(chunking.client_keys(key, ids))  # (n, 2, 2)
        cids = torch.as_tensor(ids, device=key.device).to(
            torch.int64) % n_classes
        lo = ((cids * vocab) // n_classes).view(-1, 1, 1, 1)
        in_band = trandom.bernoulli(ks[:, 1], 0.5, shape)
        toks = trandom.randint(ks[:, 0], shape, 0, vocab).to(torch.int64)
        toks = torch.where(in_band, lo + toks % band, toks).to(torch.int32)
        return {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}

    return datagen
