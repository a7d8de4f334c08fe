"""Chunked linear recurrences for the SSM and RG-LRU layers, and the causal
depthwise conv in front of them (whole sequences, and one decode step at a
time). Port of ``repro/models/scan_utils.py``.

h_t = a_t * h_{t-1} + b_t (elementwise) runs as a Python loop over
sequence chunks of ``chunk`` steps, carrying h, with a log-step
(Hillis-Steele) scan inside each chunk: ``ceil(log2(chunk))`` out-of-place
passes of the reference's combine, ``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 +
b2)``. The reference scans a chunk with ``jax.lax.associative_scan``, whose
combination tree differs, so the two agree to float32 rounding, not bit for
bit. Everything is plain PyTorch: the reference has no Pallas kernel here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def chunked_linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                              h0: torch.Tensor, chunk: int = 256
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run h_t = a_t*h_{t-1} + b_t along axis 1.

    a, b: (B, S, ...state dims...); h0: (B, ...state dims...).
    Returns (h_all (B,S,...), h_last (B,...)).
    """
    s = a.shape[1]
    if s <= chunk:
        return _recurrence_block(a, b, h0)
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    h, outs = h0, []
    for c0 in range(0, s, chunk):
        h_all, h = _recurrence_block(a[:, c0:c0 + chunk], b[:, c0:c0 + chunk],
                                     h)
        outs.append(h_all)
    return torch.cat(outs, dim=1), h


def _recurrence_block(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of one chunk along axis 1, folding in the carry h0:
    after the passes ``a`` holds prod_{i<=t} a_i and ``b`` the state from a
    zero start, so h_t = a_t h0 + b_t."""
    s, k = a.shape[1], 1
    while k < s:
        a, b = (torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1),
                torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1))
        k *= 2
    h_all = a * h0[:, None] + b
    return h_all, h_all[:, -1]


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv over time. x: (B,S,C); w: (K,C). A
    cross-correlation over a left pad of K-1, as the reference's."""
    k, c = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))
    out = F.conv1d(xp, w.T.reshape(c, 1, k), groups=c).transpose(1, 2)
    if b is not None:
        out = out + b
    return out


def conv_step(conv_state: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the causal depthwise conv.

    conv_state: (B, K-1, C) previous inputs; x_new: (B, C).
    Returns (new_conv_state, y (B, C)).
    """
    k = w.shape[0]
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)  # (B,K,C)
    y = torch.einsum("bkc,kc->bc", window, w)
    if b is not None:
        y = y + b
    new_state = window[:, 1:] if k > 1 else conv_state
    return new_state, y
