"""The op account of a member's step, the counterpart of
``repro/launch/hlo_analysis.py``. The port has no HLO: these functions keep
the reference's names and output keys but read the **op log** of one
member's step run under fake tensors (``launch/dryrun.py``).

The log is a list of entries, each a JSON-able list:

* ``["op", name, operands, results, view]``: one aten op as the dispatcher
  ran it (``OpLog``, a ``TorchDispatchMode``), each operand and result a
  ``[dtype, dims]`` pair, in order; ``view`` 1 where the op's results alias
  its operands;
* ``["coll", kind, bytes, n]``: one collective of ``core/collectives.py``
  (``WIRE.calls``): its kind as the reference's HLO names it, the bytes
  this member sends, the group size.

``OpLog`` also keeps the peak of live storage bytes over the step, the
arguments included: every storage it sees is counted from the op that
made it until a ``weakref.finalize`` on it fires.

The rules follow the reference's, so that the records compare:

* flops: ``2 * numel(result) * contracted size`` for ``mm``, ``bmm``,
  ``addmm`` and ``baddbmm`` (``einsum``, ``matmul`` and ``linear`` reach
  the dispatcher as these); ``16 * numel`` of each result of a
  ``convolution`` or ``convolution_backward``;
* wire bytes: the collectives log their own, which are the reference's
  model per kind for a group of n (ring algorithms): all-reduce
  ``2 |result| (n-1)/n``, all-gather ``|result| (n-1)/n``, reduce-scatter
  ``|result| (n-1)``, all-to-all ``|result| (n-1)/n``,
  collective-permute ``|result|``. The port's ``psum`` (a reduce-scatter
  then an all-gather, with an all-reduce's bytes) is filed as one
  all-reduce;
* ``hbm_bytes``: operand plus result bytes of every op but views and
  allocations. The eager program has no fusion, so this is its own
  traffic, one pass an op, not the traffic of XLA's fused program.

There are no loop multipliers: the eager log is already unrolled.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

Log = List[list]

_DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}   # the lhs operand
_CONVS = {"convolution", "convolution_backward"}
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided"}


def _spec(t: torch.Tensor) -> list:
    return [str(t.dtype).replace("torch.", ""), list(t.shape)]


def _numel(dims) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


def _bytes(spec) -> int:
    return _numel(spec[1]) * getattr(torch, spec[0]).itemsize


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class OpLog(TorchDispatchMode):
    """Records every aten op below autograd (``log``) and the live storage
    bytes (``live``, their ``peak``). Enter it inside the
    ``FakeTensorMode`` of the step's arguments, after ``track(args)``."""

    def __init__(self):
        super().__init__()
        self.log: Log = []
        self._sizes: Dict[int, int] = {}
        self.live = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def track(self, tree) -> None:
        """Count the storages under ``tree`` as live."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._sizes:
                self._sizes[key] = st.nbytes()
                self.live += self._sizes[key]
                weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.log.append(["op", str(func), [_spec(t) for t in ins],
                         [_spec(t) for t in outs], int(func.is_view)])
        self.track(outs)
        return out


def _base(name: str) -> str:
    """``aten.mm.default`` -> ``mm``."""
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else name


def collective_stats(log: Log) -> Dict[str, Dict[str, float]]:
    """{kind: {count, bytes}} of the collectives in ``log``."""
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0.0, "bytes": 0.0})
    for e in log:
        if e[0] == "coll":
            stats[e[1]]["count"] += 1
            stats[e[1]]["bytes"] += e[2]
    return dict(stats)


def total_collective_bytes(log: Log) -> float:
    return sum(v["bytes"] for v in collective_stats(log).values())


def hlo_compute_stats(log: Log) -> Dict[str, float]:
    """{"flops", "hbm_bytes"} of this member's step (see the module's
    docstring for the rules)."""
    flops = 0.0
    hbm = 0.0
    for e in log:
        if e[0] != "op":
            continue
        _, name, ins, outs, view = e
        op = _base(name)
        if op in _DOTS and outs:
            lhs = ins[_DOTS[op]][1]
            flops += 2.0 * _numel(outs[0][1]) * lhs[-1]
        elif op in _CONVS:
            flops += 16.0 * sum(_numel(o[1]) for o in outs)
        if not view and op not in _ALLOCS:
            hbm += sum(_bytes(s) for s in ins) + sum(_bytes(s) for s in outs)
    return {"flops": flops, "hbm_bytes": hbm}
