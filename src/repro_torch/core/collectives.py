"""Compressed collectives, the port of ``repro/core/collectives.py``: a
gradient leaf all-reduced over a mesh axis (``launch/mesh.py``) with a
compressed wire format, one process a member over ``torch.distributed``.

The uplink quantizes the local leaf, all-to-alls its chunks (the
reduce-scatter phase) and reduces them; the downlink requantizes the
reduced chunk, all-gathers it and dequantizes. Every member receives the
same output bit for bit: the local arithmetic is the reference's
(``_sub_product``, the scales, pack and unpack), and a sum over members
adds them one by one in rank order (``_ordered_sum``), as the reference's
CPU ``psum`` does, so it does not depend on the backend's algorithm; a
plain ``psum`` is that sum as a reduce-scatter and an all-gather, which
moves what an all-reduce does, 2 (n - 1) / n of the leaf a member. On an
axis of one member nothing moves, but both quantizations still happen: int8
rounds the leaf to 127 levels of ``max|x|`` twice (the second scale from
the dequantized first), and scaled sign sends ``mean|x| * sign`` twice (the
second scale the mean over the leaf padded to a multiple of ``8 n`` rows).
The error state is what the uplink dropped: ``corrected - local_deq``.
Scaled sign's local copy takes ``torch.sign`` (0 at 0) while its wire packs
``x >= 0`` (+1 at 0), as the reference's does. Leaves under ``min_size``
elements take the plain mean and return an error of zeros.

Methods: none (float32 mean), bf16 (the wire in bf16, summed in float32
and rounded to bf16, as the reference's CPU ``psum`` of bf16 does), int8,
sign. ``WIRE`` counts the bytes a member sends; a gloo op that does not
take CUDA tensors copies its message through host memory
(``GLOO_CUDA_OPS``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

Tree = Dict[str, torch.Tensor]

_POW2 = (1, 2, 4, 8, 16, 32, 64, 128)
# XLA divides by a constant as a multiply by its float32 reciprocal
_INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))

# The gloo ops that take CUDA tensors, found on torch 2.11 with an H100
# (``chip_smoke.py`` phase 20 prints the table): the collectives copy
# through host memory inside gloo, but a point-to-point send reads the
# device pointer as host memory and aborts the process, so ``send_recv``
# stages its message through host memory here.
GLOO_CUDA_OPS = {"all_gather": True, "all_to_all": True, "send_recv": False}


class WireCounter:
    """Bytes this member sent, by op, and the ops that went through host
    memory (a message to each other member counted once).

    After ``record_calls()``, ``calls`` also lists each collective as
    (kind, bytes, group size) under the names of the reference's HLO
    (``launch/hlo_analysis.py``): ``all_gather`` an all-gather,
    ``all_to_all`` an all-to-all, ``reduce_scatter_sum`` a reduce-scatter,
    ``psum`` one all-reduce (its reduce-scatter and all-gather inside it),
    each of the ring's two sends a collective-permute."""

    def __init__(self):
        self.calls = None
        self.reset()

    def reset(self) -> None:
        self.bytes: Dict[str, int] = {}
        self.staged: set = set()
        if self.calls is not None:
            self.calls = []

    def record_calls(self, on: bool = True) -> None:
        self.calls = [] if on else None

    def add(self, op: str, nbytes: int, call=None) -> None:
        """``nbytes`` sent by ``op``; ``call`` (kind, group size) logs
        them as one call."""
        self.bytes[op] = self.bytes.get(op, 0) + int(nbytes)
        if call is not None:
            self.log(call[0], nbytes, call[1])

    def log(self, kind: str, nbytes: int, n: int) -> None:
        if self.calls is not None:
            self.calls.append((kind, int(nbytes), n))

    @property
    def total(self) -> int:
        return sum(self.bytes.values())


WIRE = WireCounter()


def _host_staged(op: str, x: torch.Tensor, group) -> bool:
    staged = (x.is_cuda and dist.get_backend(group) == "gloo"
              and not GLOO_CUDA_OPS[op])
    if staged:
        WIRE.staged.add(op)
    return staged


def _group(mesh, axis):
    return None if mesh is None else mesh.group(axis)


def all_gather(x: torch.Tensor, mesh=None, axis="data", log: bool = True
               ) -> torch.Tensor:
    """(n, *x.shape): every member's ``x`` along ``axis``, in rank order."""
    group = _group(mesh, axis)
    if group is None:
        return x[None]
    n = dist.get_world_size(group)
    host = _host_staged("all_gather", x, group)
    src = (x.cpu() if host else x).contiguous()
    # the members' messages land in the rows of one buffer
    out = src.new_empty((n,) + src.shape)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    WIRE.add("all_gather", (n - 1) * src.numel() * src.element_size(),
             ("all-gather", n) if log else None)
    return out.to(x.device)


def all_to_all(x: torch.Tensor, mesh=None, axis="data", log: bool = True
               ) -> torch.Tensor:
    """x: (n*c, ...) -> (n, c, ...), chunk i from member i: the
    reduce-scatter wire phase."""
    group = _group(mesh, axis)
    n = 1 if group is None else dist.get_world_size(group)
    if group is None:
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])
    host = _host_staged("all_to_all", x, group)
    src = (x.cpu() if host else x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    WIRE.add("all_to_all", (n - 1) * (src.numel() // n) * src.element_size(),
             ("all-to-all", n) if log else None)
    return out.to(x.device).reshape(n, x.shape[0] // n, *x.shape[1:])


def _ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """float32 sum over dim 0, one member after another from member 0 (a
    narrower part is widened exactly inside the add)."""
    s = parts[0].float()
    for p in parts[1:]:
        s = s + p
    return s


def reduce_scatter_sum(x: torch.Tensor, mesh=None, axis="data",
                       log: bool = True) -> torch.Tensor:
    """x: (n*c, ...) -> (c, ...) float32: the sum over ``axis`` of every
    member's chunk i on member i, added in rank order (``_ordered_sum``)."""
    sent = WIRE.total
    parts = all_to_all(x, mesh, axis, log=False)
    if log and parts.shape[0] > 1:
        WIRE.log("reduce-scatter", WIRE.total - sent, parts.shape[0])
    return _ordered_sum(parts)


def psum(x: torch.Tensor, mesh=None, axis="data") -> torch.Tensor:
    """The sum of ``x`` over ``axis`` in ``x``'s dtype (a bf16 sum is
    taken in float32 and rounded once). A reduce-scatter then an
    all-gather, as an all-reduce moves it (2 (n - 1) / n of the leaf a
    member), each element added in rank order, so that every member
    receives the same bits whatever the backend's algorithm."""
    group = _group(mesh, axis)
    if group is None:
        return x
    n = dist.get_world_size(group)
    sent = WIRE.total
    flat, numel = _pad_dim0(x.reshape(-1), n)
    part = reduce_scatter_sum(flat, mesh, axis, log=False).to(x.dtype)
    del flat
    out = all_gather(part, mesh, axis, log=False)
    WIRE.log("all-reduce", WIRE.total - sent, n)
    return out.reshape(-1)[:numel].reshape(x.shape)


def pmean(x: torch.Tensor, mesh=None, axis="data") -> torch.Tensor:
    """The reference's ``lax.pmean``: ``psum`` then a division by n in
    ``x``'s dtype."""
    n = 1 if mesh is None else mesh.n(axis)
    if n == 1:
        return x
    return psum(x, mesh, axis) / n


def ring_exchange(x: torch.Tensor, mesh, axis: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left, right): member i - 1's ``x`` and member i + 1's, around the
    ring of ``axis`` (the reference's two ``ppermute``s)."""
    group = _group(mesh, axis)
    if group is None:
        return x, x
    n = dist.get_world_size(group)
    i = mesh.index(axis)
    host = _host_staged("send_recv", x, group)
    src = (x.cpu() if host else x).contiguous()
    left, right = torch.empty_like(src), torch.empty_like(src)
    nxt = dist.get_global_rank(group, (i + 1) % n)
    prv = dist.get_global_rank(group, (i - 1) % n)
    ops = [dist.P2POp(dist.isend, src, nxt, group),
           dist.P2POp(dist.irecv, left, prv, group),
           dist.P2POp(dist.isend, src, prv, group),
           dist.P2POp(dist.irecv, right, nxt, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for _ in range(2):
        WIRE.add("send_recv", src.numel() * src.element_size(),
                 ("collective-permute", n))
    if host:
        left, right = left.to(x.device), right.to(x.device)
    return left, right


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


def _scaled_mean(recv: torch.Tensor, scales: torch.Tensor,
                 chunk: int = 1 << 24) -> torch.Tensor:
    """float32 mean over dim 0 of ``recv[i] * scales[i]`` (``recv`` int8
    codes or +-1 signs, (n, c, ...)) in the reference's compiled order: its
    fused reduction takes member 0's product, then adds each next one by a
    fused multiply-add (exact products in float64, one rounding a step), a
    chunk of elements at a time; then divides by n."""
    n = recv.shape[0]
    flat = recv.reshape(n, -1)
    out = torch.empty(flat.shape[1], dtype=torch.float32, device=recv.device)
    s64 = scales.double()
    for i in range(0, flat.shape[1], chunk):
        j = slice(i, i + chunk)
        acc = flat[0, j].float() * scales[0]
        for m in range(1, n):
            acc = (flat[m, j].double() * s64[m] + acc.double()).float()
        out[j] = acc
    return (out / n).reshape(recv.shape[1:])


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


def compressed_allreduce_leaf(
    g: torch.Tensor, axis: str = "data", method: str = "none",
    e: Optional[torch.Tensor] = None, min_size: int = 65_536, mesh=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """All-reduce-mean of ``g`` over the members of ``mesh``'s ``axis``
    (one member without a mesh) with a compressed wire format. Returns (the
    mean as every member receives it, the new error state, or None
    without ``e``)."""
    n = 1 if mesh is None else mesh.n(axis)
    gf = g.float()
    if method == "none" or g.numel() < min_size:
        if e is not None:
            gf = gf + e
        out = pmean(gf, mesh, axis)
        return out, (gf - gf if e is not None else None)  # exact: no error
    if method == "bf16":
        if e is not None:
            gf = gf + e
        sent = gf.to(torch.bfloat16)
        out = pmean(sent, mesh, axis).float()  # the wire stays bf16
        return out, (gf - sent.float() if e is not None else None)

    corrected = gf + e if e is not None else gf
    del gf
    # flatten to 2D, so that padding dim 0 to a multiple of n stays small
    last = g.shape[-1] if g.dim() > 1 else 1
    corrected2d = corrected.reshape(-1, last)

    if method == "int8":
        scale = torch.clamp_min(corrected.abs().max(), 1e-20) * _INV127
        q = torch.clamp(torch.round(corrected2d / scale), -127, 127).to(
            torch.int8)
        e_new = _sub_product(corrected, q, scale) if e is not None else None
        del corrected, corrected2d
        # uplink: int8 chunks and the members' scales
        qp, d0 = _pad_dim0(q, n)
        del q
        recv = all_to_all(qp, mesh, axis)                      # (n, c, ...)
        scales = all_gather(scale, mesh, axis)                 # (n,)
        mean_chunk = _scaled_mean(recv, scales)
        del qp, recv
        # downlink: the reduced chunk requantized, one scale a member
        scale2 = torch.clamp_min(mean_chunk.abs().max(), 1e-20) * _INV127
        q2 = torch.clamp(torch.round(mean_chunk / scale2), -127, 127).to(
            torch.int8)
        c = q2.shape[0]
        del mean_chunk
        full = all_gather(q2, mesh, axis).reshape(n * c, *q2.shape[1:])
        scales2 = all_gather(scale2, mesh, axis)               # (n,)
        s2view = scales2.repeat_interleave(c).reshape(
            n * c, *([1] * (full.dim() - 1)))
        out = (full.float() * s2view)[:d0]
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
        recv = all_to_all(packed, mesh, axis)                  # (n, c8, ...)
        scales = all_gather(scale, mesh, axis)                 # (n,)
        signs = torch.stack([unpack_bits(p).float() * 2.0 - 1.0
                             for p in recv])                   # (n, c, ...)
        del packed, recv
        mean_chunk = _scaled_mean(signs, scales)
        del signs
        # downlink: scaled sign again (biased without PS-side EF)
        scale2 = torch.mean(mean_chunk.abs())
        c = mean_chunk.shape[0]
        packed2 = pack_bits(mean_chunk >= 0)
        del mean_chunk
        full = all_gather(packed2, mesh, axis).reshape(
            n * packed2.shape[0], *packed2.shape[1:])
        full_signs = unpack_bits(full).float() * 2.0 - 1.0
        scales2 = all_gather(scale2, mesh, axis)               # (n,)
        s2view = scales2.repeat_interleave(c).reshape(
            n * c, *([1] * (full_signs.dim() - 1)))
        out = (full_signs * s2view)[:d0]
        return out.reshape(g.shape), e_new

    raise ValueError(f"unknown method {method!r}")


def tree_compressed_allreduce(tree: Tree, axis: str = "data",
                              method: str = "none",
                              e_tree: Optional[Tree] = None,
                              min_size: int = 65_536, mesh=None
                              ) -> Tuple[Tree, Optional[Tree]]:
    outs, errs = {}, {}
    for k, g in tree.items():
        e = e_tree[k] if e_tree is not None else None
        outs[k], errs[k] = compressed_allreduce_leaf(g, axis, method, e,
                                                     min_size, mesh)
    return outs, (errs if e_tree is not None else None)


def hierarchical_allreduce(tree: Tree, axes: Tuple[str, ...],
                           method: str = "none",
                           e_tree: Optional[Tree] = None,
                           inner_method: Optional[str] = None,
                           min_size: int = 65_536, mesh=None
                           ) -> Tuple[Tree, Optional[Tree]]:
    """HFL collective schedule (Alg. 9 on the mesh): reduce over
    ``axes[-1]`` (intra-pod ``data``) with ``method``, then over
    ``axes[:-1]`` (the ``pod`` axis) with ``inner_method`` (default:
    ``method``); EF applies to the first stage only."""
    inner_method = inner_method or method
    e_out = e_tree
    for i, ax in enumerate(reversed(axes)):
        if i == 0:
            tree, e_out = tree_compressed_allreduce(
                tree, ax, method, e_tree, min_size, mesh)
        else:
            tree, _ = tree_compressed_allreduce(
                tree, ax, inner_method, None, min_size, mesh)
    return tree, e_out
