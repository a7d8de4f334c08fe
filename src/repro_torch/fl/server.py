"""Server-side round logic (paper Algs. 6, 7), port of ``repro/fl/server.py``.

``fl_round`` runs one FL round: every client's local update (``torch.func``
vmap over the client axis), error feedback and compression of the flat
(N, D) client-message matrix, the participation-masked canonical sum, an
optional downlink EF, and the algorithm's server update.

With ``chunk_size`` (a power of two) clients go through the pass in blocks,
a Python loop in place of the reference's ``lax.scan``: peak temporary memory
is O(chunk * D), and the result is *bitwise* the unchunked pass, because
every cross-client sum is the canonical pairwise tree and all per-client
randomness comes from ``fold_in(key, client_id)``.

Not in this slice: privacy mechanisms, staleness weights and control-variate
algorithms (the reference's SCAFFOLD path).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch import random as trandom
from repro_torch.core import chunking
from repro_torch.core.algorithms import registry as algorithms
from repro_torch.core.algorithms.registry import Algorithm, AlgoParams
from repro_torch.core.compression import error_feedback
from repro_torch.core.compression import registry as compression_lib
from repro_torch.core.compression.error_feedback import SparseEF
from repro_torch.core.compression.registry import CompressionParams
from repro_torch.kernels import ops as kernel_ops

Params = Dict[str, torch.Tensor]

flat_dim = algorithms.flat_dim


def flatten_clients(tree: Params) -> Tuple[torch.Tensor, Callable]:
    """Stacked (N, ...) leaves -> one (N, D) float32 message matrix, plus the
    inverse (which restores shapes and dtypes)."""
    keys = sorted(tree)
    n = tree[keys[0]].shape[0]
    flat = torch.cat([tree[k].to(torch.float32).reshape(n, -1)
                      for k in keys], dim=1)

    def unflatten(mat: torch.Tensor) -> Params:
        out, off = {}, 0
        for k in keys:
            leaf = tree[k]
            size = leaf[0].numel()
            out[k] = mat[:, off:off + size].reshape(leaf.shape).to(leaf.dtype)
            off += size
        return out

    return flat, unflatten


@dataclasses.dataclass
class FLState:
    params: Params
    client_error: Any  # (N, D) uplink EF matrix | SparseEF (N, S) | None
    server_error: Optional[torch.Tensor]  # (D,) downlink EF state, or None
    server_opt: Any    # algorithm server state (None for fedavg)
    round: int = 0


def default_ef_slots(d: int) -> int:
    """Default sparse-EF slot count: twice the default 1% top-k budget."""
    return min(d, max(1, d // 50))


def init_fl_state(params: Params, n_clients: int, *,
                  algo: Union[str, Algorithm] = "fedavg",
                  use_ef: bool = False, double_ef: bool = False,
                  ef_mode: str = "dense", ef_slots: Optional[int] = None,
                  state_dtype=torch.float32,
                  n_rows: Optional[int] = None) -> FLState:
    """``use_ef`` allocates per-client EF state (dense (rows, D), or a
    :class:`SparseEF` of ``ef_slots`` pairs per row with ``ef_mode="sparse"``)
    in ``state_dtype``; ``double_ef`` the (D,) downlink EF vector; ``n_rows``
    over-allocates to the chunk-padded client count. Tensors go to the
    device of ``params``."""
    if ef_mode not in ("dense", "sparse"):
        raise ValueError(f"unknown ef_mode {ef_mode!r}; use 'dense'/'sparse'")
    a = algorithms.get_algorithm(algo)
    d = flat_dim(params)
    dev = next(iter(params.values())).device
    rows = n_clients if n_rows is None else n_rows
    if use_ef and ef_mode == "sparse":
        slots = default_ef_slots(d) if ef_slots is None else ef_slots
        client_error = error_feedback.init_sparse_error(rows, d, slots,
                                                        state_dtype, dev)
    elif use_ef:
        client_error = torch.zeros((rows, d), dtype=state_dtype, device=dev)
    else:
        client_error = None
    server_error = (torch.zeros(d, dtype=torch.float32, device=dev)
                    if double_ef else None)
    return FLState(params, client_error, server_error,
                   a.init_algo_state(params), 0)


def _rows(state_rows, lo: int, hi: int):
    """Rows [lo, hi) of per-client state (tensor, SparseEF or None)."""
    if state_rows is None:
        return None
    if isinstance(state_rows, SparseEF):
        return SparseEF(state_rows.values[lo:hi], state_rows.indices[lo:hi])
    return state_rows[lo:hi]


def _cat_rows(blocks):
    if blocks[0] is None:
        return None
    if isinstance(blocks[0], SparseEF):
        return SparseEF(torch.cat([b.values for b in blocks]),
                        torch.cat([b.indices for b in blocks]))
    return torch.cat(blocks)


def _select_rows(keep: torch.Tensor, new, old):
    """Row-select between two per-client states of one kind."""
    if isinstance(new, SparseEF):
        return SparseEF(*(_select_rows(keep, a, b) for a, b in zip(new, old)))
    return torch.where(keep.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _check_state_rows(ef, rows: int, why: str) -> None:
    if ef is None:
        return
    got = (ef.values if isinstance(ef, SparseEF) else ef).shape[0]
    if got != rows:
        raise ValueError(
            f"FLState.client_error has {got} rows but {why} requires {rows}; "
            "allocate it with init_fl_state(n_rows=...) matching the "
            "chunk-padded client count")


def fl_round(state: FLState, stacked_batches, loss_fn, *,
             algo: Union[str, Algorithm] = "fedavg",
             aparams: Optional[AlgoParams] = None,
             participation: Optional[torch.Tensor] = None,
             compression_name: Optional[str] = None,
             cparams: Optional[CompressionParams] = None,
             key: Optional[torch.Tensor] = None,
             chunk_size: Optional[int] = None,
             n_clients: Optional[int] = None,
             privacy=None,
             gate_ef: bool = False, guard_empty: bool = False
             ) -> Tuple[FLState, Dict[str, torch.Tensor]]:
    """One FL round.

    ``stacked_batches``: a dict of (N, H, ...) tensors, or a callable
    ``ids -> dict`` of (len(ids), H, ...) tensors (on-device data; needs
    ``n_clients``). ``compression_name`` (a registry name) with ``cparams``
    and ``key`` turns on compression with EF in message space: client rows
    go through :func:`compression_lib.rows_compressor`, whose kernel-backed
    operators take the CUDA kernels once N * D reaches
    ``KERNEL_DISPATCH_MIN_ELEMS`` (scaled sign with dense EF then runs the
    fused scaled-sign + EF kernel), and the downlink EF through the
    one-message operator. ``gate_ef`` freezes non-participants' EF
    rows; ``guard_empty`` makes a round with no participant a no-op. With
    ``chunk_size`` the EF state needs ``init_fl_state(n_rows=ceil(N/chunk) *
    chunk)``. Returns the new state and metrics ``loss``, ``delta_norm`` and,
    with compression, the participation-weighted ``uplink_bits``.
    """
    if privacy is not None and privacy != "none":
        raise NotImplementedError("privacy mechanisms are not ported to "
                                  "PyTorch yet")
    a = algorithms.get_algorithm(algo)
    ap = aparams if aparams is not None else algorithms.default_algo_params()
    batch_fn = stacked_batches if callable(stacked_batches) else None
    if batch_fn is not None:
        if n_clients is None:
            raise ValueError("fl_round needs n_clients= when batches come "
                             "from a callable (on-device) generator")
        n = n_clients
    else:
        n = next(iter(stacked_batches.values())).shape[0]
    d = flat_dim(state.params)
    dev = next(iter(state.params.values())).device
    comp_active = compression_name is not None

    ef = state.client_error
    sparse_ef = isinstance(ef, SparseEF)
    if sparse_ef:
        state_dt, ef_slots = ef.values.dtype, ef.values.shape[1]
    else:
        state_dt = ef.dtype if ef is not None else torch.float32
        ef_slots = 0

    fused_sign = False
    if comp_active:
        k_up, k_down, _ = trandom.split(key, 3)
        # dispatch keys on the FULL pass size N * D, never the block size
        rows_fn = compression_lib.rows_compressor(compression_name, n * d)
        fused_sign = (compression_name == "scaled_sign"
                      and ef is not None and not sparse_ef
                      and compression_lib.kernel_dispatch(compression_name,
                                                          n * d))
    part = (participation.to(torch.float32)
            if participation is not None else None)
    if gate_ef and part is None:
        raise ValueError("fl_round(gate_ef=True) needs participation= "
                         "(the gate freezes non-participants' EF rows)")

    def one(b):
        delta, _, loss = a.client_update(loss_fn, ap, state.params, b, None)
        return delta, loss

    client_pass = torch.func.vmap(one)

    # --- one block of the client pass (Alg. 6/7 lines 4-11) ---------------
    # Every client compresses (and accrues EF error) whether or not it is
    # scheduled; participation gates the sums (and, under gate_ef, the EF).
    def client_block(ids, batches_b, part_b, ef_b):
        valid = (ids < n).to(torch.float32)
        deltas, losses = client_pass(batches_b)
        flat, _ = flatten_clients(deltas)            # (c, D) message space

        new_ef_b, bits = ef_b, None
        if comp_active:
            keys_up = chunking.client_keys(k_up, ids)
            if ef_b is None:
                flat, bits = rows_fn(cparams, keys_up, flat)
            elif fused_sign:
                flat, e_new = kernel_ops.sign_ef_rows(flat, ef_b)
                new_ef_b = e_new.to(state_dt)
                bits = compression_lib.uplink_bits_jax(
                    "scaled_sign", cparams, d).expand(flat.shape[0])
            else:
                e_dense = (error_feedback.densify_rows(ef_b, d) if sparse_ef
                           else ef_b.to(torch.float32))
                corrected = flat + e_dense
                flat, bits = rows_fn(cparams, keys_up, corrected)
                resid = corrected - flat
                new_ef_b = (error_feedback.sparsify_rows(resid, ef_slots,
                                                         state_dt)
                            if sparse_ef else resid.to(state_dt))
            if gate_ef and ef_b is not None:
                new_ef_b = _select_rows(part_b != 0, new_ef_b, ef_b)

        w = valid if part_b is None else part_b
        psums = {"delta": chunking.canonical_sum(flat, w),
                 "loss": chunking.canonical_sum(losses, valid)}
        if bits is not None:
            psums["bits"] = chunking.canonical_sum(bits, w)
        return psums, new_ef_b

    if chunk_size is not None and chunk_size < n:
        chunk = chunk_size
        m = chunking.n_blocks(n, chunk)
        npad = m * chunk
        _check_state_rows(ef, npad, "chunk_size")
        part_pad = (None if part is None else torch.cat(
            [part, part.new_zeros(npad - n)]))
        psums_m, ef_m = [], []
        for b in range(m):
            lo, hi = b * chunk, (b + 1) * chunk
            ids = chunking.block_ids(b, chunk, dev)
            if batch_fn is not None:
                batches_b = batch_fn(ids)
            else:  # padded ids read the last client (a gather that clamps)
                src = ids.clamp_max(n - 1)
                batches_b = {k: v[src] for k, v in stacked_batches.items()}
            psums_b, ef_b = client_block(
                ids, batches_b, None if part_pad is None else part_pad[lo:hi],
                _rows(ef, lo, hi))
            psums_m.append(psums_b)
            ef_m.append(ef_b)
        # block partials are aligned subtrees of the full canonical tree, so
        # folding them canonically reproduces the unchunked sum bit for bit
        totals = {k: chunking.canonical_sum(torch.stack([p[k] for p in
                                                         psums_m]))
                  for k in psums_m[0]}
        client_error = _cat_rows(ef_m)
    else:
        _check_state_rows(ef, n, "the client count")
        ids = torch.arange(n, device=dev)
        batches = batch_fn(ids) if batch_fn is not None else stacked_batches
        totals, client_error = client_block(ids, batches, part, ef)

    # --- aggregation (Alg. 6 line 12): participation-masked mean ----------
    nsched = part.sum() if part is not None else None
    denom = (torch.tensor(float(n), device=dev) if part is None
             else torch.clamp_min(nsched, 1.0))
    mean_delta = algorithms.unflatten_vec(totals["delta"] / denom,
                                          state.params)

    # --- downlink (PS-side) EF compression (Alg. 6 lines 15-17) -----------
    server_error = state.server_error
    if comp_active and server_error is not None:
        corrected = algorithms.flatten_vec(mean_delta) + server_error
        c, _ = compression_lib.get_compressor(compression_name)(
            cparams, k_down, corrected)
        server_error = corrected - c
        mean_delta = algorithms.unflatten_vec(c, mean_delta)

    new_params, new_opt = a.server_update(ap, state.params, mean_delta,
                                          state.server_opt, None)

    if guard_empty and part is not None:
        # an all-failed round is bitwise a no-op: model, server state and
        # downlink EF carry forward
        alive = nsched > 0
        new_params = {k: torch.where(alive, v, state.params[k])
                      for k, v in new_params.items()}
        if server_error is not None:
            server_error = torch.where(alive, server_error,
                                       state.server_error)

    metrics = {"loss": totals["loss"] / n,
               "delta_norm": _global_norm(mean_delta)}
    if "bits" in totals:
        metrics["uplink_bits"] = totals["bits"]
    return FLState(new_params, client_error, server_error, new_opt,
                   state.round + 1), metrics


def _global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in algorithms.leaves(tree)))
