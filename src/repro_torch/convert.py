"""Carry JAX-side values into the port, as numpy arrays: parameter dicts
and PRNG keys. The port never imports JAX; callers hand over what
``np.asarray`` makes of a JAX array."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree: Dict, device=None) -> Dict[str, torch.Tensor]:
    """A (flat) dict of arrays -> dict of tensors on ``device``, same
    dtypes and values."""
    return {k: torch.as_tensor(np.array(v)).to(device) for k, v in tree.items()}


def key_from_jax(key, device=None) -> torch.Tensor:
    """A raw ``jax.random.PRNGKey`` (uint32 words, shape (..., 2)) -> the
    port's int64 key tensor."""
    return torch.as_tensor(np.asarray(key).astype(np.int64), device=device)
