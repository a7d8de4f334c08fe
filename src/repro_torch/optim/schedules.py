"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM
arXiv:2404.06395), the port of ``repro/optim/schedules.py``.

float32 throughout, with the reference's CPU transcendentals: its ``cos``
is the C library's ``cosf`` (``wireless._cos_sin``), its ``exp`` and
``log`` XLA's polynomials (``models/xla_math.py``). The learning rate is a
0-d float32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import wireless
from repro_torch.models import xla_math


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = wireless._cos_sin(math.pi * prog)[0]
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + cos))
    return torch.where(step < warmup, warm, cos)


def wsd_schedule(step, base_lr: float, warmup: int, stable: int, decay: int,
                 min_frac: float = 0.01) -> torch.Tensor:
    """Warmup -> flat -> exponential-ish decay tail (MiniCPM WSD)."""
    step = _step(step)
    warm = base_lr * step / max(warmup, 1)
    in_decay = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
    log_min = xla_math.log(torch.tensor(min_frac, device=step.device))
    dec = base_lr * xla_math.exp(log_min * in_decay)
    flat = torch.where(step < warmup + stable,
                       torch.tensor(base_lr, device=step.device), dec)
    return torch.where(step < warmup, warm, flat)


def get_schedule(name: str, base_lr: float, total_steps: int):
    if name == "wsd":
        warm = max(1, total_steps // 100)
        decay = max(1, total_steps // 10)
        stable = max(1, total_steps - warm - decay)
        return lambda s: wsd_schedule(s, base_lr, warm, stable, decay)
    return lambda s: cosine_schedule(s, base_lr, max(1, total_steps // 100),
                                     total_steps)
