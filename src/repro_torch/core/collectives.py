"""Compressed collectives, the port of ``repro/core/collectives.py`` for an
axis of one member (one card).

The reference all-reduces a gradient leaf over a mesh axis inside
``shard_map`` with a compressed wire format: the uplink quantizes the local
leaf, all-to-alls its chunks and reduces them; the downlink requantizes
the reduced chunk, all-gathers it and dequantizes. On one member the
all-to-all and the all-gathers move nothing, but both quantizations still
happen, so the one-card trainer is not the identity: int8 rounds the leaf
to 127 levels of ``max|x|`` twice (the second scale from the dequantized
first), and scaled sign sends ``mean|x| * sign`` twice (the second scale
the mean over the leaf padded to a multiple of 8 rows). The error state is
what the uplink dropped: ``corrected - local_deq``. Scaled sign's local
copy takes ``torch.sign`` (0 at 0) while its wire packs ``x >= 0`` (+1 at
0), as the reference's does. Leaves under ``min_size`` elements take the
plain mean and return an error of zeros.

Methods: none (float32 mean), bf16 (the wire in bf16), int8, sign. An axis
of ``n > 1`` members (several cards over ``torch.distributed``) is ROADMAP
queue A item 5 and raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]

_POW2 = (1, 2, 4, 8, 16, 32, 64, 128)


def _one_member(axis: str, n: int) -> None:
    if n != 1:
        raise NotImplementedError(
            f"a compressed all-reduce over {n} members of axis {axis!r} runs "
            f"across cards: ROADMAP queue A item 5 (the port runs one card)")


def _pow2(like: torch.Tensor, ndim: int) -> torch.Tensor:
    return torch.tensor(_POW2, dtype=torch.uint8, device=like.device).reshape(
        1, 8, *([1] * (ndim - 1)))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bits: bool (d0, ...) with d0 % 8 == 0 -> uint8 (d0/8, ...)."""
    d0 = bits.shape[0]
    grouped = bits.reshape(d0 // 8, 8, *bits.shape[1:]).to(torch.uint8)
    return torch.sum(grouped * _pow2(bits, bits.dim()), dim=1,
                     dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (c, ...) -> bool (8c, ...)."""
    bits = (packed[:, None] & _pow2(packed, packed.dim())) > 0
    return bits.reshape(packed.shape[0] * 8, *packed.shape[1:])


def _pad_dim0(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    d0 = x.shape[0]
    pad = (-d0) % multiple
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return x, d0


def _sub_product(c: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 chunk: int = 1 << 24) -> torch.Tensor:
    """float32 ``c - q * scale`` rounded once, as the reference's compiled
    int8 path contracts its error into a fused multiply-subtract (the
    product of an int8 code and a float32 scale is exact in float64); a
    chunk of elements at a time, so that the float64 temporaries stay
    small beside a large leaf."""
    out = torch.empty_like(c)
    cf, qf, of = c.reshape(-1), q.reshape(-1), out.view(-1)
    s = scale.double()
    for i in range(0, cf.numel(), chunk):
        j = slice(i, i + chunk)
        of[j] = (cf[j].double() - qf[j].double() * s).float()
    return out


def _a2a_chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    """x: (n*c, ...) -> received (n, c, ...): on one member, the one
    chunk."""
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


def compressed_allreduce_leaf(
    g: torch.Tensor, axis: str = "data", method: str = "none",
    e: Optional[torch.Tensor] = None, min_size: int = 65_536, n: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """All-reduce-mean of ``g`` over the ``n`` members of ``axis`` with a
    compressed wire format. Returns (the mean as every member receives it,
    the new error state, or None without ``e``)."""
    _one_member(axis, n)
    gf = g.float()
    if method == "none" or g.numel() < min_size:
        if e is not None:
            gf = gf + e
        return gf, (gf - gf if e is not None else None)  # exact: no error
    if method == "bf16":
        if e is not None:
            gf = gf + e
        sent = gf.to(torch.bfloat16).float()  # the wire stays bf16
        return sent, (gf - sent if e is not None else None)

    corrected = gf + e if e is not None else gf
    del gf
    # flatten to 2D, so that padding dim 0 to a multiple of n stays small
    last = g.shape[-1] if g.dim() > 1 else 1
    corrected2d = corrected.reshape(-1, last)

    if method == "int8":
        scale = torch.clamp_min(corrected.abs().max(), 1e-20) / 127.0
        q = torch.clamp(torch.round(corrected2d / scale), -127, 127).to(
            torch.int8)
        e_new = _sub_product(corrected, q, scale) if e is not None else None
        del corrected, corrected2d
        # uplink: int8 chunks and the members' scales
        qp, d0 = _pad_dim0(q, n)
        del q
        recv = _a2a_chunks(qp, n)                              # (n, c, ...)
        sview = scale.reshape(n, *([1] * (recv.dim() - 1)))
        mean_chunk = torch.mean(recv.float() * sview, dim=0)
        del qp, recv
        # downlink: the reduced chunk requantized, one scale a member
        scale2 = torch.clamp_min(mean_chunk.abs().max(), 1e-20) / 127.0
        q2 = torch.clamp(torch.round(mean_chunk / scale2), -127, 127).to(
            torch.int8)
        del mean_chunk
        out = (q2.float() * scale2)[:d0]
        return out.reshape(g.shape), e_new

    if method == "sign":
        # scaled sign (eq. 29): c = mean|x| * sign(x)
        scale = torch.mean(corrected.abs())
        e_new = (corrected - scale * torch.sign(corrected)
                 if e is not None else None)
        cp, d0 = _pad_dim0(corrected2d, 8 * n)
        del corrected, corrected2d
        packed = pack_bits(cp >= 0)                            # (d0p/8, ...)
        del cp
        recv = _a2a_chunks(packed, n)                          # (n, c8, ...)
        signs = torch.stack([unpack_bits(p).float() * 2.0 - 1.0
                             for p in recv])                   # (n, c, ...)
        del packed, recv
        sview = scale.reshape(n, *([1] * (signs.dim() - 1)))
        mean_chunk = torch.mean(signs * sview, dim=0)
        del signs
        # downlink: scaled sign again (biased without PS-side EF)
        scale2 = torch.mean(mean_chunk.abs())
        full_signs = unpack_bits(pack_bits(mean_chunk >= 0)).float()
        full_signs = full_signs * 2.0 - 1.0
        del mean_chunk
        out = (full_signs * scale2)[:d0]
        return out.reshape(g.shape), e_new

    raise ValueError(f"unknown method {method!r}")


def tree_compressed_allreduce(tree: Tree, axis: str = "data",
                              method: str = "none",
                              e_tree: Optional[Tree] = None,
                              min_size: int = 65_536, n: int = 1
                              ) -> Tuple[Tree, Optional[Tree]]:
    outs, errs = {}, {}
    for k, g in tree.items():
        e = e_tree[k] if e_tree is not None else None
        outs[k], errs[k] = compressed_allreduce_leaf(g, axis, method, e,
                                                     min_size, n)
    return outs, (errs if e_tree is not None else None)


def hierarchical_allreduce(tree: Tree, axes: Tuple[str, ...],
                           method: str = "none",
                           e_tree: Optional[Tree] = None,
                           inner_method: Optional[str] = None,
                           min_size: int = 65_536,
                           sizes: Optional[Dict[str, int]] = None
                           ) -> Tuple[Tree, Optional[Tree]]:
    """Reduce over ``axes[-1]`` with ``method``, then over ``axes[:-1]``
    with ``inner_method`` (default: ``method``); EF applies to the first
    stage only. ``sizes`` gives each axis's members (default one each)."""
    inner_method = inner_method or method
    sizes = sizes or {}
    e_out = e_tree
    for i, ax in enumerate(reversed(axes)):
        if i == 0:
            tree, e_out = tree_compressed_allreduce(
                tree, ax, method, e_tree, min_size, sizes.get(ax, 1))
        else:
            tree, _ = tree_compressed_allreduce(
                tree, ax, inner_method, None, min_size, sizes.get(ax, 1))
    return tree, e_out
