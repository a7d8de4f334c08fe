"""Decentralized learning on the engine (paper §I.B, Alg. 2), port of
``repro/fl/decentralized.py``.

A gossip run steps rounds on one device, as the flat and HFL engines of
``fl/runtime.py`` do (whose trace counter, ``message_bits_jax`` payload
pricing and batch stacking this module shares):

* the mixing matrix ``W`` (eqs. 7-8) is a per-run input: topology is a
  sweep axis, and a grid of ring/torus/ER/MH matrices runs through
  :func:`run_gossip_sweep` on one engine;
* every directed D2D edge is priced through the channel layer: per-edge
  Rayleigh fading (``faults.d2d_fading``; Gauss-Markov when faults are on),
  pairwise path loss from the xy deployment, the sender's bandwidth split
  over its out-degree, and ``wireless.comm_latency_jax`` per edge; the
  synchronous gossip round costs the **slowest active edge**;
* gossip messages go through the compression registry's plain row
  operators (one batch of N * N edge messages, as the reference's vmapped
  compressor; no kernel is on this path) with per-edge-*direction* error
  feedback in an ``(N, N, D)`` residual: what i failed to tell j stays
  between i and j. ``compression="none"`` reduces the exchange to exactly
  ``W @ X``;
* time-varying graphs compose with ``core/faults.py``: the Gilbert-Elliott
  availability mask gates edges and ``topology.gate_mixing_jax``
  renormalizes the effective ``W`` each round; an isolated node's row is
  exactly one-hot, so it keeps its own model bitwise;
* the fog hybrid ("From Federated to Fog Learning", arXiv 2006.03594)
  composes this with the HFL geometry: cluster members run
  ``gossip_steps`` D2D consensus steps per round over an intra-cluster
  graph built from ``hierarchy.hfl_geometry_xy_jax`` (mixing via the torch
  twins of ``core/topology.py``), and every ``hcfg.inter_cluster_period``
  rounds the members sync through their SBS up to the MBS over priced
  uplink, backhaul and downlink hops.

One round is :meth:`_GossipEngine.step` (the fog round
:meth:`_FogEngine.step`), shared by the scan, the host loop and the sweep,
so ``engine="host"`` is bitwise the scan. Entry points run on the CUDA
device unless ``device=`` says otherwise, and raise when CUDA is absent.

``consensus_step`` and ``gossip_round`` are the seed-era building blocks;
``ring_gossip_shard_map`` mixes each member's params with its two ring
neighbours over a mesh axis of processes (``launch/mesh.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import collectives
from repro_torch.core import faults as faults_lib
from repro_torch.core import hierarchy, topology, wireless
from repro_torch.core.algorithms import registry as algo_registry
from repro_torch.core.algorithms.registry import AlgoParams
from repro_torch.core.compression import registry as compression
from repro_torch.core.compression.registry import CompressionParams
from repro_torch.core.faults import FaultParams
from repro_torch.fl import runtime
from repro_torch.fl import server as fl_server
from repro_torch.models import xla_math

Params = Dict[str, torch.Tensor]

# gossip has no server step: only the pure-local client updates make sense
# on the decentralized path (control-variate/staleness algorithms assume a
# coordinator holding global state)
GOSSIP_ALGORITHMS = ("fedavg", "fedavg_m", "fedprox")


# ---------------------------------------------------------------------------
# Config + logs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Static shape of a gossip/fog run (the engine-cache key).

    Continuous knobs (channel, compression levels, lr, fault rates, the
    mixing matrix itself) are per-run inputs of the engine; only the
    fields here change what the reference compiles.
    """
    n_nodes: int = 16
    rounds: int = 50
    algorithm: str = "fedavg"            # local update from the registry
    algo_params: Optional[AlgoParams] = None
    seed: int = 0
    model_bits: float = 1e6              # simulated payload of one message
    comp_latency_s: float = 0.05         # mean exponential compute time
    compression: str = "none"            # D2D message compressor (registry)
    compression_params: Optional[CompressionParams] = None
    faults: Optional[FaultParams] = None  # None = static graph, no churn
    # --- fog hybrid (run_fog) --------------------------------------------
    gossip_steps: int = 1                # k D2D consensus steps per round
    d2d_radius_m: Optional[float] = None  # None: all same-cluster pairs
    mixing: str = "laplacian"            # in-program builder: laplacian | mh

    def __post_init__(self):
        if self.algorithm not in GOSSIP_ALGORITHMS:
            raise ValueError(
                f"gossip supports server-free algorithms "
                f"{GOSSIP_ALGORITHMS}; got {self.algorithm!r}")
        compression.get_compressor(self.compression)  # raises on unknown
        if self.mixing not in ("laplacian", "mh"):
            raise ValueError(f"mixing must be 'laplacian' or 'mh'; "
                             f"got {self.mixing!r}")
        if self.gossip_steps < 1:
            raise ValueError("gossip_steps must be >= 1")
        if self.n_nodes < 2:
            raise ValueError("need at least 2 nodes to gossip")
        if self.faults is not None and not isinstance(self.faults,
                                                      FaultParams):
            raise TypeError("GossipConfig.faults must be a FaultParams "
                            "(see repro_torch.core.faults.fault_params)")

    def static_key(self) -> Tuple:
        """Hashable engine-cache key: per-run leaves (algo/compression/fault
        params) participate only through their *presence*."""
        return (self.n_nodes, self.rounds, self.algorithm, self.seed,
                self.model_bits, self.comp_latency_s, self.compression,
                self.faults is not None, self.gossip_steps,
                self.d2d_radius_m, self.mixing)


@dataclasses.dataclass
class GossipLogs:
    """Per-round engine outputs; leading axes = (variants?, rounds)."""
    loss: np.ndarray            # mean training loss (eval loss with a batch)
    latency_s: np.ndarray       # cumulative simulated wall clock
    comm_s: np.ndarray          # this round's slowest-active-edge airtime
    comp_s: np.ndarray          # this round's slowest node compute
    uplink_bits: np.ndarray     # D2D (+ fog sync) bits on the wire
    backhaul_bits: np.ndarray   # fog SBS<->MBS bits (zero for pure gossip)
    consensus_err: np.ndarray   # RMS deviation of node models from the mean
    n_edges: np.ndarray         # active directed D2D edges this round
    n_online: np.ndarray        # available nodes (== n_nodes, faults off)


def _logs_from_outs(outs: List[Tuple]) -> GossipLogs:
    """One run's per-round outputs -> float32 ``(rounds,)`` columns."""
    return GossipLogs(*(torch.stack(c).cpu().numpy() for c in zip(*outs)))


def _stack_logs(logs: Sequence[GossipLogs]) -> GossipLogs:
    """Variants' logs with a leading variant axis."""
    return GossipLogs(*(np.stack([getattr(g, f.name) for g in logs])
                        for f in dataclasses.fields(GossipLogs)))


def _resolve_aparams(cfg: GossipConfig, dev: torch.device) -> AlgoParams:
    if cfg.algo_params is not None:
        return cfg.algo_params.to(dev)
    return algo_registry.default_algo_params(dev)


def _resolve_cparams(cfg: GossipConfig, params: Params,
                     dev: torch.device) -> CompressionParams:
    if cfg.compression_params is not None:
        return cfg.compression_params.to(dev)
    return compression.default_compression_params(fl_server.flat_dim(params),
                                                  dev)


def _check_w(w, n: int) -> np.ndarray:
    """A mixing matrix as float32, checked for shape and (at tol 1e-5)
    double stochasticity with the reference's messages."""
    w = np.asarray(w, dtype=np.float32)
    if w.shape != (n, n):
        raise ValueError(f"mixing matrix must be ({n}, {n}) for "
                         f"n_nodes={n}; got {w.shape}")
    if not topology.is_doubly_stochastic(w, tol=1e-5):
        raise ValueError(
            "mixing matrix is not doubly stochastic; build it with "
            "topology.laplacian_mixing / metropolis_hastings_mixing")
    return w


# ---------------------------------------------------------------------------
# Engine internals
# ---------------------------------------------------------------------------
def _edge_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """(N * N, 2) per-directed-edge subkeys in row-major (sender, receiver)
    order: the reference's (N, N) grid, flattened for the row operator."""
    return trandom.split(key, n * n)


class _GossipVariant(NamedTuple):
    """One run's inputs and what the engine derives from them once."""
    chan: wireless.ChannelParams
    cparams: CompressionParams
    aparams: AlgoParams
    fparams: Optional[FaultParams]
    w: torch.Tensor                 # (N, N) mixing matrix, (dst, src)
    dist_nn: torch.Tensor           # (N, N) pairwise distances
    k_rounds: torch.Tensor
    bits_msg: torch.Tensor          # priced bits of one D2D message
    template: Params                # the initial params (shapes, dtypes)
    # fog only: the SBS<->MBS rate and the device->SBS geometry
    bh_rate: Optional[torch.Tensor] = None
    cluster_ids: Optional[torch.Tensor] = None  # (N,) int64
    dist_sbs: Optional[torch.Tensor] = None     # (N,)


@dataclasses.dataclass
class _GossipCarry:
    """The round state: the reference's gossip scan carry."""
    x: torch.Tensor                 # (N, D) per-node models
    ef: Optional[torch.Tensor]      # (src, dst, D) per-edge-direction EF
    clock: torch.Tensor
    avail: Optional[torch.Tensor] = None   # (N,) bool, faults on
    fad: Optional[torch.Tensor] = None     # (N * N, 2) Gauss-Markov state


class _GossipEngine:
    """The static half of a gossip run, the counterpart of the reference's
    ``_make_gossip_fns``. One round (Alg. 2): churn gates W, every active
    directed edge is priced over its own fading draw, the nodes exchange
    (compressed, error-fed-back) models, then each takes its local update
    on the mixed model."""

    def __init__(self, cfg: GossipConfig, loss_fn, has_eval: bool):
        self.cfg, self.loss_fn, self.has_eval = cfg, loss_fn, has_eval
        self.n = cfg.n_nodes
        self.algo = algo_registry.get_algorithm(cfg.algorithm)
        self.comp_active = cfg.compression != "none"
        # the registry's plain row operator (no kernel dispatch)
        self.compress = (compression.rows_compressor(cfg.compression)
                         if self.comp_active else None)
        self.faults_on = cfg.faults is not None

    def _variant(self, chan: wireless.ChannelParams,
                 cparams: CompressionParams, aparams: AlgoParams,
                 fparams: Optional[FaultParams], params: Params,
                 **geom) -> _GossipVariant:
        """The variant with its D2D message price; ``geom`` holds the
        mixing matrix, the distances and the round-key root."""
        return _GossipVariant(
            chan=chan, cparams=cparams, aparams=aparams, fparams=fparams,
            bits_msg=runtime.message_bits_jax(
                self.cfg.compression, cparams, self.cfg.model_bits,
                fl_server.flat_dim(params)),
            template=params, **geom)

    def variant(self, key: torch.Tensor, chan: wireless.ChannelParams,
                cparams: CompressionParams, aparams: AlgoParams,
                w: torch.Tensor, fparams: Optional[FaultParams],
                params: Params) -> _GossipVariant:
        """A run's inputs with its xy deployment (from the seed's
        ``k_pos``) and round-key root."""
        k_pos, k_rounds = trandom.split(key)
        pos = wireless.sample_positions_xy_jax(k_pos, chan, self.n)
        return self._variant(chan, cparams, aparams, fparams, params, w=w,
                             dist_nn=wireless.pairwise_dist_jax(pos),
                             k_rounds=k_rounds)

    def init(self, params: Params) -> _GossipCarry:
        """Every node at ``params``, zero EF, the clock at 0."""
        x = algo_registry.flatten_vec(params)[None, :].repeat(self.n, 1)
        dev = x.device
        carry = _GossipCarry(
            x, (torch.zeros((self.n,) + tuple(x.shape), dtype=torch.float32,
                            device=dev) if self.comp_active else None),
            torch.zeros((), dtype=torch.float32, device=dev))
        if self.faults_on:
            carry.avail = torch.ones(self.n, dtype=torch.bool, device=dev)
            carry.fad = torch.zeros((self.n * self.n, 2),
                                    dtype=torch.float32, device=dev)
        return carry

    # --- the parts of a round, shared with the fog engine ------------------
    def _open(self, t: int, carry: _GossipCarry, v: _GossipVariant):
        """Round keys, churn-gated W and the slowest active edge's airtime:
        ``(kt, kc, kz, avail, fad, w_eff, act_ds, edge_air)``."""
        n = self.n
        kt = trandom.fold_in(v.k_rounds, t)
        kc, kz = trandom.split(trandom.fold_in(kt, 1))
        avail, fad = carry.avail, carry.fad
        if self.faults_on:
            avail = faults_lib.churn_step(v.fparams, kt, avail)
            w_eff = topology.gate_mixing_jax(v.w, avail)
        else:
            w_eff = v.w
        eye = torch.eye(n, dtype=torch.bool, device=w_eff.device)
        act_ds = (w_eff > 0.0) & ~eye                  # (dst, src) edges
        if self.faults_on:
            fad, fpow = faults_lib.gauss_markov_fading(
                v.fparams, trandom.fold_in(kt, faults_lib.D2D_FOLD), fad, t)
            fading_nn = fpow.reshape(n, n)
        else:
            fading_nn = faults_lib.d2d_fading(kt, n * n).reshape(n, n)
        # slowest active edge: each sender splits its bandwidth over its
        # active out-edges; an outage edge (non-positive rate) costs inf
        snr = wireless.snr_jax(v.dist_nn, fading_nn, v.chan)   # (dst, src)
        deg_out = act_ds.to(torch.float32).sum(dim=0)          # (src,)
        rates = wireless.shannon_rate_jax(
            snr, v.chan.bandwidth_hz / torch.clamp_min(deg_out, 1.0)[None, :])
        lat = wireless.comm_latency_jax(v.bits_msg, rates)
        edge_air = torch.where(act_ds, lat, 0.0).amax()
        return kt, kc, kz, avail, fad, w_eff, act_ds, edge_air

    def _exchange(self, v: _GossipVariant, w_eff: torch.Tensor,
                  act_ds: torch.Tensor, x: torch.Tensor,
                  ef: Optional[torch.Tensor], key: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             torch.Tensor]:
        """One consensus exchange x_i <- sum_j W_ij m_{j->i} (eq. 7) with
        compressed per-edge messages and per-edge-direction error feedback.
        ``w_eff`` is (dst, src); ``ef`` is (src, dst, D). Returns ``(mixed,
        new_ef, uplink_bits)``; with ``"none"`` it is exactly ``w_eff @
        x``."""
        n, d = x.shape
        ubits = v.bits_msg * act_ds.to(torch.float32).sum()
        if not self.comp_active:
            return w_eff @ x, ef, ubits
        inp = x[:, None, :] + ef                       # (src, dst, D)
        wire, _ = self.compress(v.cparams, _edge_keys(key, n),
                                inp.reshape(n * n, d))
        wire = wire.reshape(n, n, d)
        ef = torch.where(act_ds.T[:, :, None], inp - wire, ef)
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        w_off = torch.where(eye, 0.0, w_eff)
        # the self term uses the node's own uncompressed model; neighbours
        # get the compressed wire message of their edge direction
        mixed = (torch.diagonal(w_eff)[:, None] * x
                 + torch.einsum("ds,sdk->dk", w_off, wire))
        return mixed, ef, ubits

    def _local(self, v: _GossipVariant, mixed: torch.Tensor,
               batches: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        """Alg. 2 line 5: every node's local update on its mixed model:
        ``(deltas (N, D), losses (N,))``."""
        algo, loss_fn, ap = self.algo, self.loss_fn, v.aparams

        def one(p, b):  # (delta, loss): vmap outputs no None
            delta, _, loss = algo.client_update(loss_fn, ap, p, b, None)
            return delta, loss

        deltas, losses = torch.func.vmap(one)(
            algo_registry.unflatten_rows(mixed, v.template), batches)
        return fl_server.flatten_clients(deltas)[0], losses

    def _comp_lat(self, v: _GossipVariant, kt: torch.Tensor,
                  kc: torch.Tensor) -> torch.Tensor:
        lat = self.cfg.comp_latency_s * trandom.exponential(kc, (self.n,))
        if self.faults_on:
            lat = lat * faults_lib.straggler_multiplier(v.fparams, kt,
                                                        self.n)
        return lat

    @staticmethod
    def _drift(x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(((x - x.mean(dim=0)) ** 2).mean())

    def step(self, t: int, carry: _GossipCarry, v: _GossipVariant,
             batches: Params, eval_batch: Optional[Params]
             ) -> Tuple[_GossipCarry, Tuple]:
        """Round ``t``: the new round state and the round's log values in
        :class:`GossipLogs` order. ``batches`` are the round's (N, H, ...)
        tensors."""
        (kt, kc, kz, avail, fad, w_eff, act_ds,
         comm_s) = self._open(t, carry, v)
        x = carry.x
        mixed, ef, ubits = self._exchange(v, w_eff, act_ds, x, carry.ef, kz)
        n_act = act_ds.to(torch.float32).sum()
        delta, losses = self._local(v, mixed, batches)
        comp_lat = self._comp_lat(v, kt, kc)
        if self.faults_on:
            # an offline node neither computes nor moves: its mixed row is
            # already bitwise its own model (one-hot W_eff row), and the
            # local delta is withheld
            x = torch.where(avail[:, None], mixed + delta, x)
            comp_s = torch.where(avail, comp_lat, 0.0).amax()
            n_online = avail.to(torch.float32).sum()
            loss_train = ((losses * avail).sum()
                          / torch.clamp_min(n_online, 1.0))
        else:
            x = mixed + delta
            comp_s = comp_lat.amax()
            n_online = torch.full((), float(self.n), device=x.device)
            loss_train = losses.mean()
        clock = carry.clock + comm_s + comp_s
        loss = (self.loss_fn(algo_registry.unflatten_vec(x.mean(dim=0),
                                                         v.template),
                             eval_batch)[0]
                if self.has_eval else loss_train)
        zero = torch.zeros((), device=x.device)
        outs = (loss, clock, comm_s, comp_s, ubits, zero, self._drift(x),
                n_act, n_online)
        return _GossipCarry(x, ef, clock, avail, fad), outs

    def run(self, v: _GossipVariant, params: Params, batches: Params,
            eval_batch: Optional[Params]
            ) -> Tuple[torch.Tensor, List[Tuple]]:
        """``cfg.rounds`` steps from ``params``: the final (N, D) node
        models and each round's log values."""
        carry, outs = self.init(params), []
        for t in range(self.cfg.rounds):
            carry, out = self.step(t, carry, v,
                                   {k: b[t] for k, b in batches.items()},
                                   eval_batch)
            outs.append(out)
        return carry.x, outs


def _gossip_key(cfg: GossipConfig, loss_fn, has_eval: bool,
                tag: str) -> Tuple:
    return ("gossip", tag, cfg.static_key(), loss_fn, has_eval)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def run_gossip(cfg: GossipConfig, loss_fn, init_params: Params,
               sample_client_batches, w, *,
               wcfg: Optional[wireless.WirelessConfig] = None,
               eval_batch: Optional[Params] = None, engine: str = "scan",
               device="cuda") -> Tuple[Params, GossipLogs]:
    """Run one decentralized (gossip) simulation on ``device``.

    ``w`` is the doubly-stochastic mixing matrix (a per-run input: rerunning
    with a different same-shape W reuses the engine). Returns ``(stacked
    per-node params (leading axis N), GossipLogs)``. ``engine="host"``
    samples each round's batches as it goes; both engines step the same
    round, so they agree bitwise.
    """
    if engine not in ("scan", "host"):
        raise ValueError(f"engine must be 'scan' or 'host'; got {engine!r}")
    dev = runtime.resolve_device(device)
    wcfg = wcfg or wireless.WirelessConfig(n_devices=cfg.n_nodes)
    w = torch.tensor(_check_w(w, cfg.n_nodes), device=dev)
    has_eval = eval_batch is not None
    params, eval_batch = (runtime._on(init_params, dev),
                          runtime._on(eval_batch, dev))
    eng = _GossipEngine(cfg, loss_fn, has_eval)
    v = eng.variant(trandom.PRNGKey(cfg.seed, dev),
                    wireless.channel_params(wcfg, dev),
                    _resolve_cparams(cfg, params, dev),
                    _resolve_aparams(cfg, dev), w,
                    cfg.faults.to(dev) if cfg.faults is not None else None,
                    params)
    if engine == "scan":
        batches = runtime._on(runtime.stack_batches(
            sample_client_batches, cfg.rounds, cfg.n_nodes), dev)
        runtime._count_trace(_gossip_key(cfg, loss_fn, has_eval, "single"),
                             runtime._shapes(params, batches, eval_batch))
        x, outs = eng.run(v, params, batches, eval_batch)
    else:
        x, outs = _run_gossip_host(eng, v, params, sample_client_batches,
                                   eval_batch, dev)
    return algo_registry.unflatten_rows(x, params), _logs_from_outs(outs)


def _run_host_loop(eng, v, params: Params, sample_client_batches,
                   eval_batch, dev, key: Tuple
                   ) -> Tuple[torch.Tensor, List[Tuple]]:
    """Round by round over the scan's own step, each round's batches
    sampled when it starts; ``key`` counts the host step's trace."""
    carry, outs = eng.init(params), []
    for t in range(eng.cfg.rounds):
        bt = runtime._on(sample_client_batches(t, eng.n), dev)
        if t == 0:
            runtime._count_trace(key, runtime._shapes(params, bt,
                                                      eval_batch))
        carry, out = eng.step(t, carry, v, bt, eval_batch)
        outs.append(out)
    return carry.x, outs


def _run_gossip_host(eng: _GossipEngine, v: _GossipVariant, params: Params,
                     sample_client_batches, eval_batch, dev):
    """The host loop of :func:`run_gossip` (bitwise the scan)."""
    return _run_host_loop(
        eng, v, params, sample_client_batches, eval_batch, dev,
        _gossip_key(eng.cfg, eng.loss_fn, eval_batch is not None, "host"))


def run_gossip_sweep(cfg: GossipConfig, loss_fn, init_params: Params,
                     sample_client_batches, *,
                     wgrid: Sequence, seeds: Sequence[int] = (0,),
                     wcfgs: Optional[Sequence] = None,
                     cparams_grid: Optional[Sequence] = None,
                     aparams_grid: Optional[Sequence] = None,
                     fparams_grid: Optional[Sequence] = None,
                     eval_batch: Optional[Params] = None,
                     device="cuda") -> GossipLogs:
    """Topology (x seed x channel x compression x lr x fault) grid on one
    engine, the variants one after another.

    The variant axis is the cross product ``seeds x wcfgs x wgrid x
    cparams_grid x aparams_grid x fparams_grid`` in row-major order; logs
    come back with a leading variant axis of that length. ``wgrid`` entries
    must share ``(n_nodes, n_nodes)`` shape (one engine). Counts one trace
    for the grid, as the reference's one vmapped program.
    """
    dev = runtime.resolve_device(device)
    wcfgs = list(wcfgs) if wcfgs is not None else [
        wireless.WirelessConfig(n_devices=cfg.n_nodes)]
    ws = [torch.tensor(_check_w(w, cfg.n_nodes), device=dev) for w in wgrid]
    params, eval_batch = (runtime._on(init_params, dev),
                          runtime._on(eval_batch, dev))
    cps = ([p.to(dev) for p in cparams_grid] if cparams_grid is not None
           else [_resolve_cparams(cfg, params, dev)])
    aps = ([p.to(dev) for p in aparams_grid] if aparams_grid is not None
           else [_resolve_aparams(cfg, dev)])
    if fparams_grid is not None:
        fps = [p.to(dev) for p in fparams_grid]
    elif cfg.faults is not None:
        fps = [cfg.faults.to(dev)]
    else:
        fps = [None]
    if fps[0] is not None and cfg.faults is None:
        # the engine's fault machinery keys on cfg.faults being set
        cfg = dataclasses.replace(cfg, faults=fps[0])

    grid = list(itertools.product(range(len(seeds)), range(len(wcfgs)),
                                  range(len(ws)), range(len(cps)),
                                  range(len(aps)), range(len(fps))))
    has_eval = eval_batch is not None
    batches = runtime._on(runtime.stack_batches(
        sample_client_batches, cfg.rounds, cfg.n_nodes), dev)
    runtime._count_trace(_gossip_key(cfg, loss_fn, has_eval, "vmap"),
                         (len(grid),) + runtime._shapes(params, batches,
                                                        eval_batch))
    eng = _GossipEngine(cfg, loss_fn, has_eval)
    logs = []
    for si, wi, gi, ci, ai, fi in grid:
        v = eng.variant(trandom.PRNGKey(seeds[si], dev),
                        wireless.channel_params(wcfgs[wi], dev), cps[ci],
                        aps[ai], ws[gi], fps[fi], params)
        _, outs = eng.run(v, params, batches, eval_batch)
        logs.append(_logs_from_outs(outs))
    return _stack_logs(logs)


# ---------------------------------------------------------------------------
# Fog hybrid: intra-cluster D2D gossip between SBS sync rounds (2006.03594)
# ---------------------------------------------------------------------------
class _FogEngine(_GossipEngine):
    """Like :class:`_GossipEngine`, but the graph comes from the HFL
    deployment (same-cluster D2D edges, optionally radius-limited), the
    mixing matrix is built by the torch topology twins, each round runs
    ``gossip_steps`` exchanges, and every ``hcfg.inter_cluster_period``
    rounds the clusters sync through SBS -> MBS -> broadcast with each hop
    priced (device uplink over the cell channel, wired backhaul at
    ``hcfg.backhaul_rate_bps``, downlink broadcast at SBS power)."""

    def __init__(self, cfg: GossipConfig, hcfg, loss_fn, has_eval: bool):
        super().__init__(cfg, loss_fn, has_eval)
        self.hcfg = hcfg
        self.period = hcfg.inter_cluster_period
        self.mix = (topology.laplacian_mixing_jax if cfg.mixing == "laplacian"
                    else topology.metropolis_hastings_mixing_jax)

    def variant(self, key: torch.Tensor, chan: wireless.ChannelParams,
                cparams: CompressionParams, aparams: AlgoParams,
                bh_rate: float, fparams: Optional[FaultParams],
                params: Params) -> _GossipVariant:
        """A run's inputs with its hex deployment, its same-cluster D2D
        graph and that graph's mixing matrix."""
        n, dev = self.n, key.device
        k_pos, k_rounds = trandom.split(key)
        pos, cluster_ids, dist_sbs, _, _ = hierarchy.hfl_geometry_xy_jax(
            k_pos, self.hcfg, n)
        dist_nn = wireless.pairwise_dist_jax(pos)
        adj = ((cluster_ids[:, None] == cluster_ids[None, :])
               & ~torch.eye(n, dtype=torch.bool, device=dev))
        if self.cfg.d2d_radius_m is not None:
            adj = adj & (dist_nn <= self.cfg.d2d_radius_m)
        return self._variant(
            chan, cparams, aparams, fparams, params, w=self.mix(adj),
            dist_nn=dist_nn, k_rounds=k_rounds,
            bh_rate=torch.as_tensor(bh_rate, dtype=torch.float32,
                                    device=dev),
            cluster_ids=cluster_ids.to(torch.int64), dist_sbs=dist_sbs)

    def step(self, t: int, carry: _GossipCarry, v: _GossipVariant,
             batches: Params, eval_batch: Optional[Params]
             ) -> Tuple[_GossipCarry, Tuple]:
        cfg, n = self.cfg, self.n
        (kt, kc, kz, avail, fad, w_eff, act_ds,
         edge_air) = self._open(t, carry, v)
        # --- k D2D gossip steps, one fading block per round ---------------
        comm_s = cfg.gossip_steps * edge_air
        n_act = act_ds.to(torch.float32).sum()
        x, mixed, ef = carry.x, carry.x, carry.ef
        ubits = None
        for s in range(cfg.gossip_steps):
            mixed, ef, ub = self._exchange(v, w_eff, act_ds, mixed, ef,
                                           trandom.fold_in(kz, s))
            ubits = ub if ubits is None else ubits + ub

        # --- local update -------------------------------------------------
        delta, losses = self._local(v, mixed, batches)
        comp_lat = self._comp_lat(v, kt, kc)
        if self.faults_on:
            x = torch.where(avail[:, None], mixed + delta, x)
            comp_s = torch.where(avail, comp_lat, 0.0).amax()
            online = avail.to(torch.float32)
        else:
            x = mixed + delta
            comp_s = comp_lat.amax()
            online = torch.ones(n, dtype=torch.float32, device=x.device)
        n_online = online.sum()
        denom = torch.clamp_min(n_online, 1.0)
        loss_train = (losses * online).sum() / denom

        # --- SBS -> MBS sync every `period` rounds ------------------------
        zero = torch.zeros((), device=x.device)
        bh_bits = zero
        if (t + 1) % self.period == 0:
            # online nodes reset to the global (online-weighted) mean; the
            # sync payload ships the raw model state (EF applies to the
            # D2D messages, not to absolute-model sync messages)
            gmean = (x * online[:, None]).sum(dim=0) / denom
            x = torch.where(online[:, None] > 0.0, gmean[None, :], x)
            comm_s, ubits, bh_bits = self._sync(kt, v, online, n_online,
                                                comm_s, ubits)
        clock = carry.clock + comm_s + comp_s
        if self.has_eval:
            avg = algo_registry.unflatten_vec(
                (x * online[:, None]).sum(dim=0) / denom, v.template)
            loss = self.loss_fn(avg, eval_batch)[0]
        else:
            loss = loss_train
        outs = (loss, clock, comm_s, comp_s, ubits, bh_bits,
                self._drift(x), n_act, n_online)
        return _GossipCarry(x, ef, clock, avail, fad), outs

    def _sync(self, kt, v: _GossipVariant, online, n_online, comm_s, ubits):
        """The sync round's pricing: member uplink over the fading SBS
        channel with the cell's bandwidth split over its online members,
        wired SBS<->MBS backhaul both ways, SBS->member broadcast at BS
        power. Returns ``(comm_s, uplink_bits, backhaul_bits)``."""
        mb, chan = self.cfg.model_bits, v.chan
        ksync = trandom.fold_in(kt, faults_lib.DOWNLINK_FOLD)
        cnt = torch.zeros(self.hcfg.n_clusters, dtype=torch.float32,
                          device=online.device).index_add_(
            0, v.cluster_ids, online)
        share = chan.bandwidth_hz / torch.clamp_min(cnt[v.cluster_ids], 1.0)
        up_rate = wireless.shannon_rate_jax(wireless.snr_jax(
            v.dist_sbs, faults_lib.downlink_fading(ksync, self.n), chan),
            share)
        up_lat = wireless.comm_latency_jax(mb, up_rate)
        dl_rate = wireless.shannon_rate_jax(wireless.downlink_snr_jax(
            v.dist_sbs, faults_lib.d2d_fading(ksync, self.n), chan),
            chan.bandwidth_hz)
        dl_lat = wireless.comm_latency_jax(mb, dl_rate)
        bh_lat = 2.0 * mb / torch.clamp_min(v.bh_rate, 1.0)
        sync_s = (torch.where(online > 0.0, up_lat + dl_lat, 0.0).amax()
                  + bh_lat)
        n_live = (cnt > 0.0).to(torch.float32).sum()
        return (comm_s + sync_s, ubits + mb * n_online,
                2.0 * mb * n_live)


def _fog_key(cfg: GossipConfig, hcfg, loss_fn, has_eval: bool,
             tag: str) -> Tuple:
    return ("fog", tag, cfg.static_key(), hcfg.static_key(), loss_fn,
            has_eval)


def run_fog(cfg: GossipConfig, hcfg, loss_fn, init_params: Params,
            sample_client_batches, *,
            wcfg: Optional[wireless.WirelessConfig] = None,
            eval_batch: Optional[Params] = None, engine: str = "scan",
            device="cuda") -> Tuple[Params, GossipLogs]:
    """Fog learning hybrid on ``device``: every round each node takes a
    local step and runs ``cfg.gossip_steps`` D2D consensus exchanges with
    its cluster peers; every ``hcfg.inter_cluster_period`` rounds the
    clusters sync globally through SBS/MBS with every hop priced. Returns
    ``(stacked per-node params, GossipLogs)``.
    """
    if engine not in ("scan", "host"):
        raise ValueError(f"engine must be 'scan' or 'host'; got {engine!r}")
    dev = runtime.resolve_device(device)
    wcfg = wcfg or wireless.WirelessConfig(n_devices=cfg.n_nodes)
    has_eval = eval_batch is not None
    params, eval_batch = (runtime._on(init_params, dev),
                          runtime._on(eval_batch, dev))
    eng = _FogEngine(cfg, hcfg, loss_fn, has_eval)
    v = eng.variant(trandom.PRNGKey(cfg.seed, dev),
                    wireless.channel_params(wcfg, dev),
                    _resolve_cparams(cfg, params, dev),
                    _resolve_aparams(cfg, dev), hcfg.backhaul_rate_bps,
                    cfg.faults.to(dev) if cfg.faults is not None else None,
                    params)
    if engine == "scan":
        batches = runtime._on(runtime.stack_batches(
            sample_client_batches, cfg.rounds, cfg.n_nodes), dev)
        runtime._count_trace(_fog_key(cfg, hcfg, loss_fn, has_eval, "scan"),
                             runtime._shapes(params, batches, eval_batch))
        x, outs = eng.run(v, params, batches, eval_batch)
    else:
        x, outs = _run_fog_host(eng, v, params, sample_client_batches,
                                eval_batch, dev)
    return algo_registry.unflatten_rows(x, params), _logs_from_outs(outs)


def _run_fog_host(eng: _FogEngine, v: _GossipVariant, params: Params,
                  sample_client_batches, eval_batch, dev):
    """The host loop of :func:`run_fog` (bitwise the scan)."""
    return _run_host_loop(
        eng, v, params, sample_client_batches, eval_batch, dev,
        _fog_key(eng.cfg, eng.hcfg, eng.loss_fn, eval_batch is not None,
                 "host"))


# ---------------------------------------------------------------------------
# Seed-era building blocks (numpy-reference style)
# ---------------------------------------------------------------------------
def consensus_step(client_params: Params, w) -> Params:
    """theta_i <- sum_j W_ij theta_j (eq. 7); client_params leaves are
    (N, ...)."""
    def leaf(x):
        flat = x.reshape(x.shape[0], -1).to(torch.float32)
        wt = torch.as_tensor(w, device=x.device).to(torch.float32)
        return (wt @ flat).reshape(x.shape).to(x.dtype)
    return {k: leaf(v) for k, v in client_params.items()}


def gossip_round(client_params: Params, w, stacked_batches: Params, loss_fn,
                 lr: float) -> Tuple[Params, torch.Tensor]:
    """Alg. 2: consensus then one local SGD step on each device."""
    mixed = consensus_step(client_params, w)
    grad_and_loss = torch.func.grad_and_value(lambda p, b: loss_fn(p, b)[0])

    def one(p, batch):
        g, loss = grad_and_loss(p, batch)
        return {k: (p[k].to(torch.float32) - lr * g[k].to(torch.float32))
                .to(p[k].dtype) for k in p}, loss

    new_params, losses = torch.func.vmap(one)(mixed, stacked_batches)
    return new_params, losses.mean()


def ring_gossip_shard_map(mesh, axis: str = "data",
                          self_weight: float = 1.0 / 3.0):
    """Returns a function mixing each member's params with its two ring
    neighbours over ``mesh``'s ``axis``: theta_i <- w*theta_i +
    w_n*theta_{i-1} + w_n*theta_{i+1}, w_n = (1 - w) / 2 (the ring
    Laplacian W of eq. 8 with d_max=2).

    It takes and returns this member's block of leaves whose leading device
    axis is split over ``axis``. The two neighbours arrive by two
    point-to-point exchanges around the ring; the mix is float32 in the
    reference's compiled order: LLVM contracts its two adds into FMAs,
    ``fma(w_n, right, fma(w, x, w_n * left))`` for a float32 leaf and
    ``fma(w_n, right, fma(w_n, left, w * x))`` for a bf16 one (read off
    the compiled reference on the CPU), cast back to the leaf's dtype.
    """
    w = float(torch.tensor(self_weight, dtype=torch.float32))
    w_n = float(torch.tensor((1.0 - self_weight) / 2.0, dtype=torch.float32))

    def mix(x: torch.Tensor) -> torch.Tensor:
        left, right = collectives.ring_exchange(x, mesh, axis)
        xf, lf = x.float(), left.float()
        if x.dtype == torch.float32:
            inner = xla_math.fma64(xf.double(), w, lf * w_n)
        else:
            inner = xla_math.fma64(lf.double(), w_n, xf * w)
        return xla_math.fma64(right.double(), w_n, inner).to(x.dtype)

    def apply(stacked: Params) -> Params:
        return {k: mix(x) for k, x in stacked.items()}

    return apply
