"""Server-side round logic (paper Algs. 6, 7), port of ``repro/fl/server.py``.

``fl_round`` runs one FL round: every client's local update (``torch.func``
vmap over the client axis), error feedback and compression of the flat
(N, D) client-message matrix, the participation-masked canonical sum, an
optional downlink EF, and the algorithm's server update. Control-variate
algorithms (SCAFFOLD) carry an (N, D) matrix of per-client variates
(``FLState.ctrl``) and uplink their ctrl delta as a second message.

With ``chunk_size`` (a power of two) clients go through the pass in blocks,
a Python loop in place of the reference's ``lax.scan``: peak temporary memory
is O(chunk * D), and the result is *bitwise* the unchunked pass, because
every cross-client sum is the canonical pairwise tree and all per-client
randomness comes from ``fold_in(key, client_id)``.

With a privacy mechanism (``core/privacy``) each client's wire row is
clipped, field-encoded, noised and masked after EF and compression; the
server decodes the modular sum or adds central noise before the mean.

``pssgd_round`` is one synchronous gradient-averaging step (Alg. 1).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch import random as trandom
from repro_torch.core import aggregation as agg
from repro_torch.core import chunking
from repro_torch.core.algorithms import registry as algorithms
from repro_torch.core.algorithms.registry import Algorithm, AlgoParams
from repro_torch.core.compression import error_feedback
from repro_torch.core.compression import registry as compression_lib
from repro_torch.core.compression.error_feedback import SparseEF
from repro_torch.core.compression.coding import FIELD_MASK
from repro_torch.core.compression.registry import CompressionParams
from repro_torch.core.privacy import registry as privacy_lib
from repro_torch.core.privacy.registry import PrivacyParams
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
    server_opt: Any    # algorithm server state: SlowMoState | ServerOptState
    #                    | (D,) SCAFFOLD server control variate | fedbuff's
    #                    (buffer, count) | None
    ctrl: Optional[torch.Tensor] = None  # (N, D) SCAFFOLD client variates
    round: int = 0


def default_ef_slots(d: int) -> int:
    """Default sparse-EF slot count: twice the default 1% top-k budget."""
    return min(d, max(1, d // 50))


def init_fl_state(params: Params, n_clients: int, *,
                  algo: Union[str, Algorithm] = "fedavg",
                  use_ef: bool = False, double_ef: bool = False,
                  server: Optional[str] = None, ef_mode: str = "dense",
                  ef_slots: Optional[int] = None, state_dtype=torch.float32,
                  n_rows: Optional[int] = None) -> FLState:
    """``use_ef`` allocates per-client EF state (dense (rows, D), or a
    :class:`SparseEF` of ``ef_slots`` pairs per row with ``ef_mode="sparse"``)
    in ``state_dtype``; ``double_ef`` the (D,) downlink EF vector; the
    algorithm its server state and, for control-variate algorithms, the
    (rows, D) ctrl matrix in ``state_dtype``. ``n_rows`` over-allocates the
    per-client state to the chunk-padded client count. Tensors go to the
    device of ``params``. ``server=`` is the deprecated spelling of
    ``algo=``."""
    if server is not None:
        warnings.warn(
            "init_fl_state(server=...) is deprecated; pass algo="
            "<algorithm registry name> instead", DeprecationWarning,
            stacklevel=2)
        algo = algorithms.from_server_name(server)
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
    ctrl = (torch.zeros((rows, d), dtype=state_dtype, device=dev)
            if a.uses_ctrl else None)
    return FLState(params, client_error, server_error,
                   a.init_algo_state(params), ctrl, 0)


def _rows(state_rows, lo: int, hi: int):
    """Rows [lo, hi) of per-client state (tensor, SparseEF or None)."""
    if state_rows is None:
        return None
    if isinstance(state_rows, SparseEF):
        return SparseEF(state_rows.values[lo:hi], state_rows.indices[lo:hi])
    return state_rows[lo:hi]


def _clone_rows(state_rows):
    """A copy of per-client state (tensor, SparseEF or None)."""
    if state_rows is None:
        return None
    if isinstance(state_rows, SparseEF):
        return SparseEF(*(t.clone() for t in state_rows))
    return state_rows.clone()


def _write_rows(state_rows, lo: int, block) -> None:
    """Write a block's rows into per-client state from row ``lo`` on."""
    if state_rows is None:
        return
    if isinstance(state_rows, SparseEF):
        for dst, src in zip(state_rows, block):
            dst[lo:lo + src.shape[0]].copy_(src)
    else:
        state_rows[lo:lo + block.shape[0]].copy_(block)


def _select_rows(keep: torch.Tensor, new, old):
    """Row-select between two per-client states of one kind."""
    if isinstance(new, SparseEF):
        return SparseEF(*(_select_rows(keep, a, b) for a, b in zip(new, old)))
    return torch.where(keep.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _tree_where(cond: torch.Tensor, new, old):
    """Select ``new`` where ``cond`` else ``old``, leaf by leaf, through
    tensors, dicts, tuples and NamedTuples (server states)."""
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        return torch.where(cond, new, old)
    if isinstance(new, dict):
        return {k: _tree_where(cond, new[k], old[k]) for k in new}
    leaves = [_tree_where(cond, a, b) for a, b in zip(new, old)]
    return type(new)(*leaves) if hasattr(new, "_fields") else tuple(leaves)


def _check_state_rows(ef, ctrl, rows: int, why: str) -> None:
    for name, st in (("client_error", ef), ("ctrl", ctrl)):
        if st is None:
            continue
        got = (st.values if isinstance(st, SparseEF) else st).shape[0]
        if got != rows:
            raise ValueError(
                f"FLState.{name} has {got} rows but {why} requires {rows}; "
                "allocate it with init_fl_state(n_rows=...) matching the "
                "chunk-padded client count")


def _resolve_algo(algo, aparams, lr, server, server_lr, slowmo_beta,
                  momentum, device) -> Tuple[Algorithm, AlgoParams]:
    """The algorithm and its params, with the deprecated ``lr=``,
    ``server=``, ``server_lr=``, ``slowmo_beta=`` and ``momentum=`` mapped
    onto the registry as the reference maps them."""
    legacy = {"lr": lr, "server": server, "server_lr": server_lr,
              "slowmo_beta": slowmo_beta, "momentum": momentum}
    if any(v is not None for v in legacy.values()):
        given = sorted(k for k, v in legacy.items() if v is not None)
        warnings.warn(
            f"fl_round({'/'.join(given)}=...) is deprecated; pass "
            "algo=<registry name> + aparams=AlgoParams(...) instead "
            "(core.algorithms.get_algorithm)", DeprecationWarning,
            stacklevel=3)
        algo_name = algorithms.get_algorithm(algo).name
        if server is not None:
            mapped = algorithms.from_server_name(server)
            if algo_name not in ("fedavg", mapped):
                raise ValueError(
                    f"fl_round sets both algo={algo_name!r} and the "
                    f"deprecated server={server!r} (-> {mapped!r}); drop "
                    "server=")
            algo = algo_name = mapped
        if momentum is not None:
            # the old path always ran momentum-SGD clients; only the
            # fedavg_m client update reads AlgoParams.momentum
            if algo_name == "fedavg":
                algo = "fedavg_m"
            elif algo_name != "fedavg_m":
                raise ValueError(
                    f"fl_round(momentum=...) has no registry equivalent for "
                    f"algo={algo_name!r} (its client update ignores "
                    "momentum); compose your own Algorithm triple instead")
        ap = (aparams if aparams is not None
              else algorithms.default_algo_params(device))
        aparams = ap._replace(**{
            k: torch.tensor(float(v), dtype=torch.float32, device=device)
            for k, v in legacy.items() if v is not None and k != "server"})
    return algorithms.get_algorithm(algo), (
        aparams if aparams is not None
        else algorithms.default_algo_params(device))


def fl_round(state: FLState, stacked_batches, loss_fn, *,
             algo: Union[str, Algorithm] = "fedavg",
             aparams: Optional[AlgoParams] = None,
             participation: Optional[torch.Tensor] = None,
             compression_name: Optional[str] = None,
             cparams: Optional[CompressionParams] = None,
             key: Optional[torch.Tensor] = None,
             chunk_size: Optional[int] = None,
             n_clients: Optional[int] = None,
             staleness_weights: Optional[torch.Tensor] = None,
             privacy=None, pparams: Optional[PrivacyParams] = None,
             privacy_key: Optional[torch.Tensor] = None,
             gate_ef: bool = False, guard_empty: bool = False,
             donate: bool = False,
             lr=None, server=None, server_lr=None, slowmo_beta=None,
             momentum=None) -> Tuple[FLState, Dict[str, torch.Tensor]]:
    """One FL round.

    ``stacked_batches``: a dict of (N, H, ...) tensors, or a callable
    ``ids -> dict`` of (len(ids), H, ...) tensors (on-device data; needs
    ``n_clients``). ``compression_name`` (a registry name) with ``cparams``
    and ``key`` turns on compression with EF in message space: client rows
    go through :func:`compression_lib.rows_compressor`, whose kernel-backed
    operators take the CUDA kernels once N * D reaches
    ``KERNEL_DISPATCH_MIN_ELEMS`` (scaled sign with dense EF then runs the
    fused scaled-sign + EF kernel), and the downlink EF through the
    one-message operator. Control-variate algorithms uplink their ctrl delta
    as a second message through the same operator (no EF, keys from its own
    stream), billed in ``uplink_bits``; scheduled clients advance ``c_i`` by
    the transmitted delta.

    ``staleness_weights`` (N,) multiplies each client's wire message in the
    sum only (EF accrues the true residual; all-ones weights are bitwise no
    weights). ``gate_ef`` freezes non-participants' EF rows; ``guard_empty``
    makes a round with no participant a no-op: params, server state and
    downlink EF carry forward. ``privacy`` (a registry name or
    :class:`privacy_lib.Privacy`) with ``pparams`` and a fresh
    ``privacy_key`` privatizes the wire rows: in the field modes they are
    int64 field elements summed mod 2^32, masked by the survivors' pairwise
    masks, and bill ``field_bits * D`` each. With ``chunk_size`` the
    per-client state needs ``init_fl_state(n_rows=ceil(N/chunk) * chunk)``;
    ``donate=True`` (the caller gives ``state`` up, as the engine's carry is)
    then writes each block's EF and ctrl rows into ``state``'s own tensors,
    so a round holds one (N, D) EF matrix, not two; without it they go into
    a copy. The deprecated ``lr=``,
    ``server=``, ``server_lr=``, ``slowmo_beta=`` and ``momentum=`` map onto
    the registry with a warning. Returns the new state and metrics ``loss``,
    ``delta_norm`` and, with compression, the participation-weighted
    ``uplink_bits``.
    """
    dev = next(iter(state.params.values())).device
    a, ap = _resolve_algo(algo, aparams, lr, server, server_lr, slowmo_beta,
                          momentum, dev)
    batch_fn = stacked_batches if callable(stacked_batches) else None
    if batch_fn is not None:
        if n_clients is None:
            raise ValueError("fl_round needs n_clients= when batches come "
                             "from a callable (on-device) generator")
        n = n_clients
    else:
        n = next(iter(stacked_batches.values())).shape[0]
    d = flat_dim(state.params)
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
        k_up, k_down, k_ctrl = trandom.split(key, 3)
        # dispatch keys on the FULL pass size N * D, never the block size
        rows_fn = compression_lib.rows_compressor(compression_name, n * d)
        fused_sign = (compression_name == "scaled_sign"
                      and ef is not None and not sparse_ef
                      and compression_lib.kernel_dispatch(compression_name,
                                                          n * d))
    c_tree = (algorithms.unflatten_vec(state.server_opt, state.params)
              if a.uses_ctrl else None)
    part = (participation.to(torch.float32)
            if participation is not None else None)
    sw = (staleness_weights.to(torch.float32)
          if staleness_weights is not None else None)
    if gate_ef and part is None:
        raise ValueError("fl_round(gate_ef=True) needs participation= "
                         "(the gate freezes non-participants' EF rows)")

    priv = None
    if privacy is not None:
        priv = (privacy_lib.get_privacy(privacy) if isinstance(privacy, str)
                else privacy)
        if priv.name == "none":
            priv = None
    if priv is not None:
        if privacy_key is None:
            raise ValueError(
                f"fl_round(privacy={priv.name!r}) needs privacy_key= — mask "
                "PRG seeds and DP noise must be fresh every round")
        if pparams is None:
            pparams = privacy_lib.default_privacy_params(dev)
        if a.uses_ctrl:
            raise ValueError(
                f"privacy={priv.name!r} does not cover algo={a.name!r}: the "
                "control-variate uplink would be a per-client plaintext "
                "side channel")
        if priv.uses_field and sw is not None:
            raise ValueError(
                f"privacy={priv.name!r} is incompatible with "
                "staleness_weights=: fractional weights cannot scale uint32 "
                "field elements")
        if (priv.uses_field and compression_name is not None
                and compression_name not in privacy_lib.FIELD_COMPATIBLE):
            raise ValueError(
                f"privacy={priv.name!r} cannot ship "
                f"compression={compression_name!r} messages through a masked "
                f"field sum; legal: {'/'.join(privacy_lib.FIELD_COMPATIBLE)}")
    field = priv is not None and priv.uses_field
    mask_env = None
    if priv is not None and priv.uses_masks:
        mask_env = _mask_prepass(privacy_key, n, d, part, chunk_size)

    def one(b):
        delta, _, loss = a.client_update(loss_fn, ap, state.params, b, None)
        return delta, loss

    def one_ctrl(b, ci):
        return a.client_update(loss_fn, ap, state.params, b, (ci, c_tree))

    client_pass = torch.func.vmap(one_ctrl if a.uses_ctrl else one)

    # --- one block of the client pass (Alg. 6/7 lines 4-11) ---------------
    # Every client compresses (and accrues EF error) whether or not it is
    # scheduled; participation gates the sums (and, under gate_ef, the EF).
    def client_block(ids, batches_b, part_b, sw_b, ef_b, ctrl_b):
        valid = (ids < n).to(torch.float32)
        ctrl_flat = None
        if a.uses_ctrl:
            ci_tree = algorithms.unflatten_rows(ctrl_b.to(torch.float32),
                                                state.params)
            deltas, ctrl_deltas, losses = client_pass(batches_b, ci_tree)
            ctrl_flat, _ = flatten_clients(ctrl_deltas)
        else:
            deltas, losses = client_pass(batches_b)
        flat, _ = flatten_clients(deltas)            # (c, D) message space
        del deltas

        new_ef_b, ctrl_wire, bits = ef_b, ctrl_flat, None
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
            if ctrl_flat is not None:
                # the control-variate delta is a second message on the same
                # uplink: compressed by the same operator (no EF), billed
                keys_c = chunking.client_keys(k_ctrl, ids)
                ctrl_wire, cbits = rows_fn(cparams, keys_c, ctrl_flat)
                bits = bits + cbits
            if gate_ef and ef_b is not None:
                new_ef_b = _select_rows(part_b != 0, new_ef_b, ef_b)

        w = valid if part_b is None else part_b
        if priv is not None:
            # privacy acts on the wire message (after EF and compression):
            # clip, field-encode, local noise, then the cohort's pairwise
            # masks; rows with w == 0 are selected away by canonical_sum
            flat = priv.client_transform(pparams, privacy_key, ids, flat)
            if mask_env is not None:
                gsum, cnt = mask_env
                flat = (flat + privacy_lib.pairwise_masks(
                    privacy_key, ids, d, gsum, cnt)) & FIELD_MASK
            if field and bits is not None:
                # a masked field message is dense: field_bits a coordinate
                bits = (pparams.field_bits * float(d)).expand(bits.shape)
        # the staleness discount multiplies the wire message in the sum only
        dsrc = flat if sw_b is None else flat * sw_b[:, None]
        delta_sum = chunking.canonical_sum(dsrc, w)
        psums = {"delta": delta_sum & FIELD_MASK if field else delta_sum,
                 "loss": chunking.canonical_sum(losses, valid)}
        if bits is not None:
            psums["bits"] = chunking.canonical_sum(bits, w)
        new_ctrl_b = ctrl_b
        if ctrl_wire is not None:
            psums["ctrl"] = chunking.canonical_sum(ctrl_wire, w)
            # only scheduled clients advance their control variate
            new_ctrl_b = (ctrl_b.to(torch.float32)
                          + ctrl_wire * w[:, None]).to(state_dt)
        return psums, new_ef_b, new_ctrl_b

    if chunk_size is not None and chunk_size < n:
        chunk = chunk_size
        m = chunking.n_blocks(n, chunk)
        npad = m * chunk
        _check_state_rows(ef, state.ctrl, npad, "chunk_size")
        part_pad, sw_pad = (None if v is None else torch.cat(
            [v, v.new_zeros(npad - n)]) for v in (part, sw))
        # each block's new rows are written over its old ones: into the
        # given state under donate, else into a copy of it
        client_error, new_ctrl = ef, state.ctrl
        if not donate:
            client_error, new_ctrl = _clone_rows(ef), _clone_rows(state.ctrl)
        folds = {}
        for b in range(m):
            lo, hi = b * chunk, (b + 1) * chunk
            ids = chunking.block_ids(b, chunk, dev)
            if batch_fn is not None:
                batches_b = batch_fn(ids)
            else:  # padded ids read the last client (a gather that clamps)
                src = ids.clamp_max(n - 1)
                batches_b = {k: v[src] for k, v in stacked_batches.items()}
            psums_b, ef_b, ctrl_b = client_block(
                ids, batches_b, _rows(part_pad, lo, hi), _rows(sw_pad, lo, hi),
                _rows(client_error, lo, hi), _rows(new_ctrl, lo, hi))
            # block partials are aligned subtrees of the full canonical
            # tree, so folding them canonically reproduces the unchunked sum
            # bit for bit
            for k, v in psums_b.items():
                folds.setdefault(k, chunking.CanonicalFold()).add(v)
            _write_rows(client_error, lo, ef_b)
            _write_rows(new_ctrl, lo, ctrl_b)
        totals = {k: f.total() for k, f in folds.items()}
        if field:  # int64 adds mod 2^32: the reference's wrapping uint32
            totals["delta"] = totals["delta"] & FIELD_MASK
    else:
        _check_state_rows(ef, state.ctrl, n, "the client count")
        ids = torch.arange(n, device=dev)
        batches = batch_fn(ids) if batch_fn is not None else stacked_batches
        totals, client_error, new_ctrl = client_block(ids, batches, part, sw,
                                                      ef, state.ctrl)

    # --- aggregation (Alg. 6 line 12): participation-masked mean ----------
    nsched = part.sum() if part is not None else None
    denom = (torch.tensor(float(n), device=dev) if part is None
             else torch.clamp_min(nsched, 1.0))
    tot_delta = totals["delta"]
    if priv is not None:
        # decode the field sum / add central noise, to the sum (the noise is
        # calibrated to the clipped per-client sensitivity)
        tot_delta = priv.server_transform(pparams, privacy_key, tot_delta)
    mean_delta = algorithms.unflatten_vec(tot_delta / denom, state.params)

    # --- downlink (PS-side) EF compression (Alg. 6 lines 15-17) -----------
    server_error = state.server_error
    if comp_active and server_error is not None:
        corrected = algorithms.flatten_vec(mean_delta) + server_error
        c, _ = compression_lib.get_compressor(compression_name)(
            cparams, k_down, corrected)
        server_error = corrected - c
        mean_delta = algorithms.unflatten_vec(c, mean_delta)

    # --- control-variate bookkeeping (SCAFFOLD): clients advanced c_i by the
    # transmitted ctrl delta, the quantity the server integrates into c, so
    # c = mean(c_i) holds under lossy compression
    ctrl_aux = None
    if a.uses_ctrl:
        part_frac = (torch.tensor(1.0, device=dev) if part is None
                     else nsched / n)
        ctrl_aux = (totals["ctrl"] / denom, part_frac)

    new_params, new_opt = a.server_update(ap, state.params, mean_delta,
                                          state.server_opt, ctrl_aux)

    if guard_empty and part is not None:
        # an all-failed round is bitwise a no-op: the model, the server
        # optimizer state (momentum, Adam moments, the fedbuff buffer and
        # its counter would advance on a zero delta) and the downlink EF
        # carry forward
        alive = nsched > 0
        new_params = _tree_where(alive, new_params, state.params)
        new_opt = _tree_where(alive, new_opt, state.server_opt)
        if server_error is not None:
            server_error = torch.where(alive, server_error,
                                       state.server_error)

    metrics = {"loss": totals["loss"] / n,
               "delta_norm": _global_norm(mean_delta)}
    if "bits" in totals:
        metrics["uplink_bits"] = totals["bits"]
    return FLState(new_params, client_error, server_error, new_opt,
                   new_ctrl, state.round + 1), metrics


def _mask_prepass(privacy_key: torch.Tensor, n: int, d: int,
                  part: Optional[torch.Tensor], chunk_size: Optional[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cohort aggregate every pairwise mask needs: ``(gsum, cnt)``, with
    ``gsum = sum_{j in S} g_j`` mod 2^32 and ``cnt = |S|`` over the survivor
    set S (participation != 0; everyone when ``part is None``). Addition mod
    2^32 is associative, so accumulating per block is bitwise the one-shot
    sum. The client pass draws the PRG rows again: twice the PRG work for
    O(chunk * D) memory instead of O(N * D)."""
    dev = privacy_key.device
    if chunk_size is not None and chunk_size < n:
        gsum = torch.zeros(d, dtype=torch.int64, device=dev)
        cnt = torch.zeros((), dtype=torch.int64, device=dev)
        for b in range(chunking.n_blocks(n, chunk_size)):
            ids = chunking.block_ids(b, chunk_size, dev)
            surv = ids < n
            if part is not None:
                surv &= part[ids.clamp_max(n - 1)] != 0
            g = privacy_lib.mask_rows(privacy_key, ids, d)
            gsum = (gsum + torch.where(surv[:, None], g, 0).sum(0)
                    ) & FIELD_MASK
            cnt = cnt + surv.sum()
        return gsum, cnt
    ids = torch.arange(n, device=dev)
    surv = (torch.ones(n, dtype=torch.bool, device=dev) if part is None
            else part != 0)
    g = privacy_lib.mask_rows(privacy_key, ids, d)
    return torch.where(surv[:, None], g, 0).sum(0) & FIELD_MASK, surv.sum()


def _global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in algorithms.leaves(tree)))


# ---------------------------------------------------------------------------
# PSSGD (Alg. 1): one synchronous gradient-averaging step
# ---------------------------------------------------------------------------
def pssgd_round(params: Params, stacked_batches: Params, loss_fn, *,
                lr: float, compression: str = "none",
                cparams: Optional[CompressionParams] = None,
                key: Optional[torch.Tensor] = None
                ) -> Tuple[Params, torch.Tensor]:
    """``theta <- theta - lr * mean_i g_i`` (eq. 6), with optional registry
    compression of each client's flattened gradient message (keys
    ``split(key, N)``, one per client, as the reference draws them)."""
    grad_fn = torch.func.grad_and_value(lambda p, b: loss_fn(p, b)[0])
    grads, losses = torch.func.vmap(grad_fn, in_dims=(None, 0))(
        params, stacked_batches)
    if compression != "none":
        if cparams is None:
            cparams = compression_lib.default_compression_params(
                flat_dim(params), next(iter(params.values())).device)
        if key is None:
            # a silently fixed key would reuse the same dither every round
            raise ValueError(
                "pssgd_round needs key= when compression != 'none' "
                "(stochastic compressors must see fresh randomness each "
                "round)")
        flat, unflatten = flatten_clients(grads)
        comp, _ = compression_lib.rows_compressor(compression)(
            cparams, trandom.split(key, flat.shape[0]), flat)
        grads = unflatten(comp)
    mean_g = agg.average_gradients(grads)
    new_params = {k: (p.to(torch.float32) - lr * mean_g[k].to(torch.float32))
                  .to(p.dtype) for k, p in params.items()}
    return new_params, losses.mean()
