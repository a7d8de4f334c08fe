"""Wireless FL simulation engine (paper §III experiments), port of the flat
engine of ``repro/fl/runtime.py``.

Each round: draw fading, price the uplink and downlink through the
Shannon-rate channel, schedule clients with a registry policy, run
``fl_round`` (local SGD, EF + compression, canonical sum), and account the
synchronous round's wall clock. The reference compiles the rounds into one
``lax.scan``; here they are a Python loop over rounds on one device, with
the round key ``fold_in(k_rounds, t)`` split into the same five streams
(fading, compute, policy, norms, compression), so every draw matches the
reference bit for bit.

One round is :meth:`_Engine.step`, shared by the three entry points:

* :func:`run_simulation_scan` steps ``cfg.rounds`` rounds over pre-stacked
  batches (or ``SimConfig.datagen``) and returns stacked :class:`SimLogs`;
* the host loop, ``run_simulation(engine="host")`` or an opaque
  ``eval_fn``, samples each round's batches as it goes and logs
  ``eval_fn(params)`` as the loss;
* :func:`run_sweep` runs a seed x channel x compression x algorithm x fault
  x privacy x policy grid, one variant after another, each with its own
  parameters, and returns ``(variants, rounds)`` logs (with ``hcfg=`` the
  hierarchical engine's); with ``devices=`` / ``mesh=`` the variants are
  split over the members of a process group. The reference's
  ``policy_mode="mixture"`` shares one compiled program across policies;
  eager PyTorch compiles nothing, so here both modes run each policy's
  variants through that policy alone, and differ only in what they count
  as traced.

The static half of a run (what the reference's compiled program specializes
on) is an :class:`_Engine`, built per run; ``ENGINE_STATS["traces"]``
counts what the reference would trace: each new (static key, argument
shapes) pair a scan or sweep runs, with the reference's bounded cache.

Entry points run on the CUDA device unless ``device=`` says otherwise, and
raise when CUDA is absent: they never fall back to the CPU.

Every algorithm of the registry runs here: SCAFFOLD's (N, D) control
variates ride in the round state, and fedbuff's staleness discount reads the
scheduling age before each round's update (the true per-client staleness
under faults).

``SimConfig.faults`` (``core/faults.py``) adds churn, Gauss-Markov fading,
stragglers, dropout and decode failure with up to ``max_retries`` re-priced
retransmissions; ``SimConfig.privacy`` (``core/privacy``) adds secure
aggregation and DP with a Renyi accountant. Both draw from streams folded
under their own tags, so with them off every stream is the legacy one.

:func:`run_hfl` is the hierarchical engine (Alg. 9): devices in clusters
around small-cell base stations, cluster models averaged every round and
synced through the macro BS every H rounds. Its round is
:meth:`_HFLEngine.step`, shared by its scan, its host loop and
``run_sweep(hcfg=, hcfgs=)``.

Gossip and fog are ``fl/decentralized.py``. Not ported: sharding a sweep
over several cards.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import warnings
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import chunking, faults as faults_lib
from repro_torch.core import hierarchy, scheduling, wireless
from repro_torch.core.algorithms import registry as algo_registry
from repro_torch.core.algorithms.registry import AlgoParams
from repro_torch.core.compression import registry as compression
from repro_torch.core.compression.coding import FIELD_MASK
from repro_torch.core.compression.registry import CompressionParams
from repro_torch.core.faults import FaultParams
from repro_torch.core.privacy import registry as privacy_lib
from repro_torch.core.privacy.registry import PrivacyParams
from repro_torch.fl import server as fl_server
from repro_torch.launch.members import member_device
from repro_torch.launch.mesh import Mesh

Params = Dict[str, torch.Tensor]

# the reference's trace counter: bumped once per new (engine, argument
# shapes) pair that a scan or a sweep runs, so tests and the tuner can count
# what the reference would compile
ENGINE_STATS = {"traces": 0}

# domain-separation tag of the on-device data stream: the datagen key is a
# fold_in of the round key under it, so it never shifts another stream
DATAGEN_FOLD = 0x0DA7A


def resolve_device(device) -> torch.device:
    """The engine's device. CUDA is the default and is required when asked
    for: there is no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


def datagen_round_key(seed: int, t: int, device=None) -> torch.Tensor:
    """The key the engine hands ``SimConfig.datagen`` on round ``t`` of a run
    with ``SimConfig.seed == seed``."""
    _, k_rounds = trandom.split(trandom.PRNGKey(seed, device))
    return trandom.fold_in(trandom.fold_in(k_rounds, t), DATAGEN_FOLD)


@dataclasses.dataclass
class SimConfig:
    n_devices: int = 40
    # one global budget on the flat engine; a per-cluster tuple is the
    # hierarchical engine's (run_hfl), and the flat engine rejects it
    n_scheduled: Any = 8
    rounds: int = 100
    local_steps: int = 1
    algorithm: str = "fedavg"
    algo_params: Optional[AlgoParams] = None
    policy: str = "random"  # see scheduling.policy_names()
    seed: int = 0
    model_bits: float = 1e6          # uplink payload per round (per message)
    comp_latency_s: float = 0.05     # per-device compute time (mean)
    deadline_s: float = 5.0          # for the P4 policy
    age_alpha: float = 1.0
    compression: str = "none"
    compression_params: Optional[CompressionParams] = None
    double_ef: bool = False          # downlink (PS-side) EF too (Alg. 3/6)
    # fleet scale: power-of-two client blocks (bitwise equal to the
    # unchunked pass), sparse and/or bf16 EF state, on-device batches
    # (datagen(key, ids) -> (len(ids), H, ...) tensors)
    chunk_size: Optional[int] = None
    ef_mode: str = "dense"               # "dense" | "sparse"
    ef_slots: Optional[int] = None       # sparse-EF slots (default d // 50)
    state_dtype: str = "float32"         # "float32" | "bfloat16"
    datagen: Optional[Callable] = None
    # fault mode: churn, dropout, stragglers, decode failure with up to
    # max_retries re-priced retransmissions, Gauss-Markov fading
    faults: Optional[FaultParams] = None
    max_retries: int = 0
    # privacy mechanism (core.privacy registry name) and its parameters;
    # illegal (privacy, compression, algorithm) triples raise here
    privacy: str = "none"
    privacy_params: Optional[PrivacyParams] = None
    # deprecated spellings, mapped onto algorithm / algo_params with a
    # DeprecationWarning as the reference maps them
    lr: Optional[float] = None
    server: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.n_scheduled, list):
            self.n_scheduled = tuple(self.n_scheduled)
        if self.chunk_size is not None and not chunking.is_pow2(
                self.chunk_size):
            raise ValueError(f"SimConfig.chunk_size must be a power of two "
                             f"(canonical-tree alignment), got "
                             f"{self.chunk_size}")
        if self.ef_mode not in ("dense", "sparse"):
            raise ValueError(f"unknown ef_mode {self.ef_mode!r}; use "
                             "'dense'/'sparse'")
        if self.ef_mode == "sparse" and self.compression not in (
                "topk", "randk", "rtopk"):
            raise ValueError(
                "ef_mode='sparse' stores a truncated top-|slots| residual, "
                "which only approximates EF for the sparsifying compressor "
                f"family (topk/randk/rtopk), not {self.compression!r}")
        if self.state_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown state_dtype {self.state_dtype!r}; "
                             "use 'float32'/'bfloat16'")
        if self.max_retries < 0:
            raise ValueError(f"SimConfig.max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.faults is not None and not isinstance(self.faults,
                                                      FaultParams):
            raise ValueError(
                "SimConfig.faults must be a core.faults.FaultParams "
                f"(see fault_params(...)), got {type(self.faults).__name__}")
        if self.server is not None:
            mapped = algo_registry.from_server_name(self.server)
            warnings.warn(
                f"SimConfig.server={self.server!r} is deprecated; use "
                f"SimConfig.algorithm={mapped!r} (core.algorithms registry)",
                DeprecationWarning, stacklevel=3)
            if self.algorithm not in ("fedavg", mapped):
                raise ValueError(
                    f"SimConfig sets both algorithm={self.algorithm!r} and "
                    f"the deprecated server={self.server!r} (-> {mapped!r}); "
                    "drop SimConfig.server")
            self.algorithm = mapped
            self.server = None
        if self.lr is not None:
            warnings.warn(
                "SimConfig.lr is deprecated; pass algo_params="
                "algo_params(lr=...)", DeprecationWarning, stacklevel=3)
            ap = (self.algo_params if self.algo_params is not None
                  else algo_registry.default_algo_params())
            self.algo_params = ap._replace(
                lr=torch.tensor(float(self.lr), dtype=torch.float32))
            self.lr = None
        if self.privacy_params is not None and not isinstance(
                self.privacy_params, PrivacyParams):
            raise ValueError(
                "SimConfig.privacy_params must be a core.privacy."
                "PrivacyParams (see privacy_params(...)), got "
                f"{type(self.privacy_params).__name__}")
        # after the deprecated-server mapping, so the resolved algorithm is
        # what gets checked
        privacy_lib.validate_privacy_config(
            self.privacy, compression=self.compression,
            algorithm=self.algorithm)


@dataclasses.dataclass
class RoundLog:
    round: int
    latency_s: float
    loss: float
    n_scheduled: int
    participation: np.ndarray
    uplink_bits: float = 0.0   # total scheduled uplink payload this round
    comm_s: float = 0.0        # bottleneck device's upload time
    comp_s: float = 0.0        # bottleneck device's compute time
    downlink_bits: float = 0.0  # broadcast payload priced this round
    n_survived: int = 0        # scheduled clients whose update decoded
    n_dropped: int = 0         # scheduled clients lost to faults
    retransmissions: float = 0.0   # extra uplink attempts this round
    staleness_mean: float = 0.0    # mean per-client staleness (fault mode)
    epsilon: float = float("inf")  # cumulative DP epsilon after this round
    delta: float = 1.0             # the delta the epsilon is reported at
    mask_bits: float = 0.0         # secagg key-agreement overhead bits


@dataclasses.dataclass
class SimLogs:
    """Stacked per-round logs, each with a leading ``(rounds,)`` axis, or
    ``(variants, rounds)`` from :func:`run_sweep`. Without faults
    ``n_survived`` is ``n_scheduled`` and ``n_dropped``, ``retransmissions``
    and ``staleness_mean`` are 0; without DP ``epsilon`` is +inf and
    ``delta`` 1.0; without masks ``mask_bits`` is 0. The fields after
    ``comp_s`` may be ``None`` (logs built positionally from seven fields,
    as persisted tuning studies are)."""
    loss: np.ndarray
    latency_s: np.ndarray
    n_scheduled: np.ndarray
    participation: np.ndarray  # (..., rounds, n_devices) bool
    uplink_bits: np.ndarray
    comm_s: np.ndarray
    comp_s: np.ndarray
    downlink_bits: Optional[np.ndarray] = None
    n_survived: Optional[np.ndarray] = None
    n_dropped: Optional[np.ndarray] = None
    retransmissions: Optional[np.ndarray] = None
    staleness_mean: Optional[np.ndarray] = None
    epsilon: Optional[np.ndarray] = None       # cumulative, non-decreasing
    delta: Optional[np.ndarray] = None
    mask_bits: Optional[np.ndarray] = None

    def to_round_logs(self) -> List[RoundLog]:
        if self.loss.ndim != 1:
            raise ValueError("to_round_logs needs unbatched (rounds,) logs")

        def opt(field, t, cast, default=0):
            return cast(field[t]) if field is not None else cast(default)
        return [RoundLog(t, float(self.latency_s[t]), float(self.loss[t]),
                         int(self.n_scheduled[t]), self.participation[t],
                         float(self.uplink_bits[t]), float(self.comm_s[t]),
                         float(self.comp_s[t]),
                         opt(self.downlink_bits, t, float),
                         opt(self.n_survived, t, int),
                         opt(self.n_dropped, t, int),
                         opt(self.retransmissions, t, float),
                         opt(self.staleness_mean, t, float),
                         opt(self.epsilon, t, float, float("inf")),
                         opt(self.delta, t, float, 1.0),
                         opt(self.mask_bits, t, float))
                for t in range(self.loss.shape[0])]


# the SimLogs fields of one round, in the order the engine emits them, and
# their types (the reference's)
_LOG_FIELDS = ("loss", "latency_s", "participation", "n_scheduled",
               "uplink_bits", "comm_s", "comp_s", "downlink_bits",
               "n_survived", "n_dropped", "retransmissions", "staleness_mean",
               "epsilon", "delta", "mask_bits")
_LOG_INT32 = ("n_scheduled", "n_survived", "n_dropped")


def _log_columns(outs: List[Tuple], n: int) -> Dict[str, np.ndarray]:
    """One run's per-round outputs -> ``{field: (rounds, ...) array}``; no
    rounds give ``(0,)`` columns and ``(0, n)`` participation."""
    if not outs:
        return {f: np.zeros((0, n) if f == "participation" else (0,),
                            bool if f == "participation" else
                            np.int32 if f in _LOG_INT32 else np.float32)
                for f in _LOG_FIELDS}
    return {f: torch.stack(c).cpu().numpy()
            for f, c in zip(_LOG_FIELDS, zip(*outs))}


def stack_batches(sample_client_batches: Callable[[int, int], Dict],
                  rounds: int, n_devices: int) -> Params:
    """Pre-sample every round's client batches (array-likes: numpy, or
    tensors on any one device); leaves get a leading ``(rounds,)`` axis."""
    per_round = [sample_client_batches(t, n_devices) for t in range(rounds)]
    return {k: torch.stack([b[k] if isinstance(b[k], torch.Tensor)
                            else torch.tensor(np.asarray(b[k]))
                            for b in per_round])
            for k in per_round[0]}


def message_bits_jax(compression_name: str, cparams: CompressionParams,
                     model_bits: float, d_model: int) -> torch.Tensor:
    """Simulated bits on the wire of one model-sized message: ``model_bits``
    scaled by the compressor's bits-per-parameter rate on the d-dim
    message; ``"none"`` sends exactly ``model_bits``."""
    if compression_name == "none":
        return torch.tensor(float(model_bits), dtype=torch.float32,
                            device=cparams.k.device)
    payload_scale = model_bits / (32.0 * d_model)
    return payload_scale * compression.uplink_bits_jax(
        compression_name, cparams, d_model)


def _on(tree: Optional[Dict], dev: torch.device) -> Optional[Params]:
    """A dict of array-likes (tensors, numpy arrays) as tensors on ``dev``."""
    if tree is None:
        return None
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.tensor(np.asarray(v))).to(dev)
            for k, v in tree.items()}


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the reference's compiled step
    contracts the bill of a per-client price times a count into a fused
    multiply-add. ``a`` is float32 and ``b`` a count, so the product is
    exact in float64 and only the final rounding to float32 remains."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _policy_cfg(cfg: SimConfig, wcfg: wireless.WirelessConfig
                ) -> scheduling.PolicyConfig:
    return scheduling.PolicyConfig(
        n_devices=cfg.n_devices, n_scheduled=cfg.n_scheduled,
        model_bits=cfg.model_bits, deadline_s=cfg.deadline_s,
        age_alpha=cfg.age_alpha,
        sub_bw=wcfg.bandwidth_hz / wcfg.n_subchannels,
        n_subchannels=wcfg.n_subchannels)


def _resolve_cparams(cfg: SimConfig, params: Params,
                     dev: torch.device) -> CompressionParams:
    if cfg.compression_params is not None:
        return cfg.compression_params.to(dev)
    return compression.default_compression_params(fl_server.flat_dim(params),
                                                  dev)


def _resolve_aparams(cfg: SimConfig, dev: torch.device) -> AlgoParams:
    return (cfg.algo_params.to(dev) if cfg.algo_params is not None
            else algo_registry.default_algo_params(dev))


def _resolve_pparams(cfg: SimConfig, dev: torch.device) -> PrivacyParams:
    return (cfg.privacy_params if cfg.privacy_params is not None
            else privacy_lib.default_privacy_params()).to(dev)


class _Decode(NamedTuple):
    """A fault round's uplink outcome per device."""
    dropped: torch.Tensor     # scheduled and gone mid-round
    ok: torch.Tensor          # decoded on the first try or a retry
    comm_eff: torch.Tensor    # upload time with every retry's airtime
    n_retx: torch.Tensor      # retries
    survived: torch.Tensor    # scheduled, not dropped, decoded
    sent: torch.Tensor        # scheduled, not dropped


def _decode_with_retries(fparams: FaultParams, kt: torch.Tensor,
                         mask: torch.Tensor, snr_lin: torch.Tensor,
                         comm_lat: torch.Tensor, dist: torch.Tensor,
                         chan: wireless.ChannelParams, bits_dev,
                         rate_fn: Callable, max_retries: int) -> _Decode:
    """Dropout, then decode failure with up to ``max_retries`` re-priced
    retransmissions, each on a fresh channel draw."""
    n = mask.shape[0]
    dropped = faults_lib.dropout_draw(fparams, kt, n) & mask
    ok = snr_lin >= fparams.snr_min
    comm_eff = comm_lat
    n_retx = torch.zeros_like(snr_lin)
    for r in range(1, max_retries + 1):
        snr_r = wireless.snr_jax(dist, faults_lib.retry_fading(kt, r, n),
                                 chan)
        lat_r = wireless.comm_latency_jax(bits_dev, rate_fn(snr_r))
        need = ~ok
        comm_eff = comm_eff + torch.where(need, lat_r, 0.0)
        n_retx = n_retx + need.to(torch.float32)
        ok = ok | (snr_r >= fparams.snr_min)
    return _Decode(dropped, ok, comm_eff, n_retx, mask & ~dropped & ok,
                   mask & ~dropped)


def _slowest(mask: torch.Tensor, comm_lat: torch.Tensor,
             comp_lat: torch.Tensor, dec: Optional[_Decode],
             zero: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The synchronous round's ``(comm_s, comp_s)``: the slowest scheduled
    device's; a dropped client stops consuming the round, a decode-failed
    one still burns its airtime."""
    if dec is not None:
        comm_c = torch.where(dec.dropped, 0.0, dec.comm_eff)
        comp_c = torch.where(dec.dropped, 0.0, comp_lat)
    else:
        comm_c, comp_c = comm_lat, comp_lat
    slowest = torch.argmax(torch.where(mask, comm_c + comp_c, -torch.inf))
    any_sched = mask.any()
    return (torch.where(any_sched, comm_c[slowest], zero),
            torch.where(any_sched, comp_c[slowest], zero))


def _fault_log(mask: torch.Tensor, n_sched: torch.Tensor,
               dec: Optional[_Decode], stal_pre: Optional[torch.Tensor],
               zero: torch.Tensor) -> Tuple:
    """``(n_survived, n_dropped, retransmissions, staleness_mean)``."""
    if dec is None:
        return (n_sched, torch.zeros_like(n_sched), zero, zero)
    return (dec.survived.sum().to(torch.int32),
            (mask & ~dec.survived).sum().to(torch.int32),
            torch.where(dec.sent, dec.n_retx, 0.0).sum(), stal_pre.mean())


class _Variant(NamedTuple):
    """One run's traced inputs (the reference's per-variant arguments) and
    what the engine derives from them once per run."""
    chan: wireless.ChannelParams
    cparams: CompressionParams
    aparams: AlgoParams
    fparams: Optional[FaultParams]
    pparams: Optional[PrivacyParams]
    dist: torch.Tensor              # (N,) device distances to the BS
    k_rounds: torch.Tensor          # the round-key root
    bits_dev: torch.Tensor          # one client's priced uplink bits
    dl_bits: torch.Tensor           # the broadcast's bits
    mask_over: torch.Tensor         # secagg key-agreement bits a client
    payload_scale: float
    zero: torch.Tensor              # constants on the run's device, made
    no_dp: Tuple[torch.Tensor, torch.Tensor]  # once: (epsilon, delta)
    dp_delta: torch.Tensor          # without DP, and DP's delta


@dataclasses.dataclass
class _Carry:
    """The round state: the reference's scan carry."""
    state: fl_server.FLState
    clock: torch.Tensor
    ages: torch.Tensor
    norms: torch.Tensor
    avg_snr: torch.Tensor
    avail: Optional[torch.Tensor] = None   # churn availability (faults)
    fad: Optional[torch.Tensor] = None     # Gauss-Markov fading (faults)
    stal: Optional[torch.Tensor] = None    # per-client staleness (faults)
    rdp: Optional[torch.Tensor] = None     # the Renyi ledger (DP)


class _Engine:
    """The static half of a run, the counterpart of the reference's
    ``_make_sim_fns``: the policy, the algorithm, the compressor,
    chunking, state types and the fault and privacy switches. The policy's static bandwidth comes from ``wcfg``; the
    rate's from each variant's ``ChannelParams``."""

    def __init__(self, cfg: SimConfig, wcfg: wireless.WirelessConfig,
                 loss_fn, has_eval: bool):
        if isinstance(cfg.n_scheduled, tuple):
            raise ValueError(
                "per-cluster n_scheduled tuples are a hierarchical-engine "
                "feature (run_hfl); the flat engine takes one global budget")
        n = self.n = cfg.n_devices
        self.cfg, self.loss_fn, self.has_eval = cfg, loss_fn, has_eval
        self.pcfg = _policy_cfg(cfg, wcfg)
        self.policy_fn = scheduling.get_policy(cfg.policy)
        self.algo = algo_registry.get_algorithm(cfg.algorithm)
        self.comp_active = cfg.compression != "none"
        self.faults_on = cfg.faults is not None
        self.priv_on = cfg.privacy != "none"
        self.priv = (privacy_lib.get_privacy(cfg.privacy) if self.priv_on
                     else None)
        self.dp_on = self.priv_on and self.priv.uses_dp
        # chunk >= N is the unchunked pass; EF rows pad to the chunk multiple
        self.chunk = (cfg.chunk_size if cfg.chunk_size is not None
                      and cfg.chunk_size < n else None)
        self.n_rows = (chunking.n_blocks(n, self.chunk) * self.chunk
                       if self.chunk else n)
        self.state_dt = (torch.bfloat16 if cfg.state_dtype == "bfloat16"
                         else torch.float32)
        self.round_fn = functools.partial(
            fl_server.fl_round, loss_fn=loss_fn, algo=self.algo,
            compression_name=(cfg.compression if self.comp_active else None),
            chunk_size=self.chunk, n_clients=n, privacy=self.priv,
            donate=True)

    def variant(self, key: torch.Tensor, chan: wireless.ChannelParams,
                cparams: CompressionParams, aparams: AlgoParams,
                fparams: Optional[FaultParams],
                pparams: Optional[PrivacyParams], d_model: int) -> _Variant:
        """A run's inputs, with its positions, round-key root and prices."""
        cfg, priv, dev = self.cfg, self.priv, key.device
        k_pos, k_rounds = trandom.split(key)
        dist = wireless.sample_positions_jax(k_pos, chan, self.n)
        payload_scale = cfg.model_bits / (32.0 * d_model)
        uf = self.algo.uplink_factor
        if self.comp_active:
            bits_dev = message_bits_jax(cfg.compression, cparams,
                                        cfg.model_bits, d_model) * uf
            dl_bits = (payload_scale * compression.uplink_bits_jax(
                cfg.compression, cparams, d_model) if cfg.double_ef
                else torch.tensor(float(cfg.model_bits), device=dev))
        else:
            bits_dev = torch.tensor(cfg.model_bits * uf, dtype=torch.float32,
                                    device=dev)
            dl_bits = torch.tensor(float(cfg.model_bits), device=dev)
        mask_over = torch.zeros((), device=dev)
        if self.priv_on:
            # field modes send dense field_bits a coordinate (a masked
            # message is incompressible); the pairwise key agreement adds
            # raw bits
            if priv.uses_field:
                bits_dev = payload_scale * privacy_lib.uplink_bits_jax(
                    cfg.privacy, pparams, d_model, 0.0) * uf
            if priv.uses_masks:
                mask_over = privacy_lib.mask_bits_jax(cfg.privacy,
                                                      self.n - 1, dev)
                bits_dev = bits_dev + mask_over
        return _Variant(chan, cparams, aparams, fparams, pparams, dist, k_rounds, bits_dev, dl_bits, mask_over,
                        payload_scale, torch.zeros((), device=dev),
                        (torch.tensor(torch.inf, device=dev),
                         torch.tensor(1.0, device=dev)),
                        torch.tensor(privacy_lib.DELTA, dtype=torch.float32,
                                     device=dev))

    def init(self, params: Params) -> _Carry:
        """The round state before round 0, around a copy of ``params``."""
        cfg, n = self.cfg, self.n
        params = {k: v.clone() for k, v in params.items()}
        dev = next(iter(params.values())).device
        state = fl_server.init_fl_state(
            params, n, algo=self.algo, use_ef=self.comp_active,
            double_ef=self.comp_active and cfg.double_ef,
            ef_mode=cfg.ef_mode, ef_slots=cfg.ef_slots,
            state_dtype=self.state_dt, n_rows=self.n_rows)
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        carry = _Carry(state, torch.zeros((), dtype=torch.float32,
                                          device=dev),
                       zeros, torch.ones_like(zeros), zeros)
        if self.faults_on:
            # everyone starts online, with zero fading state and staleness
            carry.avail = torch.ones(n, dtype=torch.bool, device=dev)
            carry.fad = torch.zeros((n, 2), dtype=torch.float32, device=dev)
            carry.stal = zeros
        if self.dp_on:  # one slot per order in ALPHAS
            carry.rdp = torch.zeros(len(privacy_lib.ALPHAS),
                                    dtype=torch.float32, device=dev)
        return carry

    def step(self, t: int, carry: _Carry, v: _Variant,
             batches: Optional[Params], eval_batch: Optional[Params]
             ) -> Tuple[_Carry, Tuple]:
        """Round ``t``: the new round state and the round's log values in
        ``_LOG_FIELDS`` order. ``batches`` are the round's (N, H, ...)
        tensors, or ``None`` with ``SimConfig.datagen``."""
        cfg, n, priv, chan = self.cfg, self.n, self.priv, v.chan
        faults_on, fparams = self.faults_on, v.fparams
        zero = v.zero
        state, clock, ages, norms = (carry.state, carry.clock, carry.ages,
                                     carry.norms)
        avail, fad, stal, rdp = carry.avail, carry.fad, carry.stal, carry.rdp

        kt = trandom.fold_in(v.k_rounds, t)
        kf, kc, kp, kn, kz = trandom.split(kt, 5)
        if cfg.datagen is not None:
            batches = functools.partial(
                cfg.datagen, trandom.fold_in(kt, DATAGEN_FOLD))

        if faults_on:
            # correlated fading replaces the i.i.d. draw
            fad, fading = faults_lib.gauss_markov_fading(fparams, kt, fad, t)
        else:
            fading = wireless.sample_fading_jax(kf, n)
        rx, n0 = wireless.snr_parts_jax(v.dist, fading, chan)
        snr_lin = rx / n0
        rates = wireless.shannon_rate_jax(
            snr_lin, chan.bandwidth_hz / cfg.n_scheduled)
        comp_lat = cfg.comp_latency_s * trandom.exponential(kc, (n,))
        if faults_on:
            comp_lat = comp_lat * faults_lib.straggler_multiplier(
                fparams, kt, n)
        comm_lat = wireless.comm_latency_jax(v.bits_dev, rates)
        # per-device time-averaged SNR (PF's denominator), seeded with the
        # first observation
        avg_snr = (snr_lin if t == 0
                   else 0.9 * carry.avg_snr + 0.1 * snr_lin)

        rstate = scheduling.RoundState(
            t=t, key=kp, snr_lin=snr_lin, avg_snr=avg_snr, rates=rates,
            comm_lat=comm_lat, comp_lat=comp_lat, ages=ages,
            update_norms=norms, snr_parts=(rx, n0))
        if faults_on:
            # churn after pricing: offline devices are invisible to the
            # policy, and index-based policies are intersected with avail
            avail = faults_lib.churn_step(fparams, kt, avail)
            rstate = scheduling.masked_round_state(rstate, avail)
        mask = self.policy_fn(self.pcfg, rstate)
        if faults_on:
            mask = mask & avail
        # staleness before this round's resets: fedbuff's discount reads the
        # true per-client staleness under faults, else the scheduling age
        stal_pre = stal if faults_on else ages
        ages = scheduling.update_ages_jax(ages, mask)
        n_sched = mask.sum().to(torch.int32)

        dec = (_decode_with_retries(
            fparams, kt, mask, snr_lin, comm_lat, v.dist, chan, v.bits_dev,
            lambda snr: wireless.shannon_rate_jax(
                snr, chan.bandwidth_hz / cfg.n_scheduled), cfg.max_retries)
            if faults_on else None)
        part = (dec.survived if faults_on else mask).to(torch.float32)
        sw = (faults_lib.staleness_weights(v.aparams, stal_pre)
              if self.algo.uses_staleness else None)
        kw = dict(aparams=v.aparams, participation=part,
                  staleness_weights=sw)
        if faults_on:
            kw.update(gate_ef=True, guard_empty=True)
        if self.priv_on:
            kw.update(pparams=v.pparams,
                      privacy_key=trandom.fold_in(kt,
                                                  privacy_lib.PRIVACY_FOLD))
        if self.comp_active:
            state, metrics = self.round_fn(state, batches, cparams=v.cparams,
                                           key=kz, **kw)
            ubits = v.payload_scale * metrics["uplink_bits"]
            if self.priv_on and priv.uses_masks:
                # key agreement for every scheduled client (it precedes the
                # transmission that may fail)
                ubits = _fma(v.mask_over, n_sched, ubits)
            if faults_on:
                # undecoded attempts' airtime: the retries, plus the final
                # failed payload of clients never decoded
                ubits = _fma(v.bits_dev, torch.where(
                    dec.sent, dec.n_retx + (~dec.ok).to(torch.float32),
                    0.0).sum(), ubits)
        else:
            state, metrics = self.round_fn(state, batches, **kw)
            ubits = (v.bits_dev * torch.where(dec.sent, 1.0 + dec.n_retx,
                                              0.0).sum()
                     if faults_on else v.bits_dev * n_sched)

        # downlink: the broadcast opens the round at BS power over the full
        # band with its own fading; the slowest scheduled device gates it
        dl_rate = wireless.shannon_rate_jax(
            wireless.downlink_snr_jax(
                v.dist, faults_lib.downlink_fading(kt, n), chan),
            chan.bandwidth_hz)
        dl_lat = wireless.comm_latency_jax(v.dl_bits, dl_rate)
        dl_s = torch.where(mask, dl_lat, zero).amax()
        dl_bits_out = torch.where(mask.any(), v.dl_bits, zero)

        comm_s, comp_s = _slowest(mask, comm_lat, comp_lat, dec, zero)
        clock = clock + dl_s + comm_s + comp_s

        fault_log = _fault_log(mask, n_sched, dec, stal_pre, zero)
        if faults_on:
            stal = torch.where(dec.survived, 0.0, stal + 1.0)
        if self.dp_on:
            # one subsampled-Gaussian round at sampling fraction
            # survivors / N; local field noise aggregates to an effective
            # multiplier sigma * sqrt(survivors)
            n_surv_f = part.sum()
            z_eff = (v.pparams.sigma * torch.sqrt(torch.clamp_min(n_surv_f,
                                                                  1.0))
                     if priv.dp_local else v.pparams.sigma)
            rdp = rdp + privacy_lib.rdp_increment(n_surv_f / n, z_eff)
            dp_log = (privacy_lib.epsilon_of(rdp), v.dp_delta)
        else:
            dp_log = v.no_dp

        loss = metrics["loss"]
        if self.has_eval:
            loss = self.loss_fn(state.params, eval_batch)[0]
        # update-aware policies observe last-round delta norms (proxy)
        norms = 0.9 * norms + 0.1 * trandom.exponential(kn, (n,))
        carry = _Carry(state, clock, ages, norms, avg_snr, avail, fad, stal,
                       rdp)
        return carry, ((loss, clock, mask, n_sched, ubits, comm_s, comp_s,
                        dl_bits_out) + fault_log + dp_log
                       + (v.mask_over * n_sched,))

    def run(self, v: _Variant, params: Params, batches: Optional[Params],
            eval_batch: Optional[Params]) -> Tuple[Params, List[Tuple]]:
        """``cfg.rounds`` steps from ``params``: the final params and each
        round's log values."""
        carry, outs = self.init(params), []
        for t in range(self.cfg.rounds):
            bt = (None if batches is None
                  else {k: x[t] for k, x in batches.items()})
            carry, out = self.step(t, carry, v, bt, eval_batch)
            outs.append(out)
        return carry.state.params, outs


def _engine_key(cfg: SimConfig, wcfg: wireless.WirelessConfig, loss_fn,
                has_eval: bool, tag: str,
                policy_axis: Optional[Tuple[str, ...]] = None) -> Tuple:
    """Everything an engine specializes on (the reference's
    ``_engine_key``): continuous channel, compression, algorithm, fault and
    privacy parameters are per-variant inputs and stay out."""
    return (tag,
            ("mix",) + tuple(policy_axis) if policy_axis is not None
            else cfg.policy,
            cfg.rounds, cfg.n_devices, cfg.n_scheduled,
            cfg.model_bits, cfg.comp_latency_s, cfg.deadline_s,
            cfg.age_alpha, cfg.algorithm, cfg.compression, cfg.double_ef,
            cfg.chunk_size, cfg.ef_mode, cfg.ef_slots, cfg.state_dtype,
            cfg.datagen, cfg.faults is not None, cfg.max_retries,
            cfg.privacy,
            wcfg.n_subchannels, wcfg.bandwidth_hz, loss_fn, has_eval)


# engine key -> the argument shapes the reference would have traced it at;
# a FIFO with the reference's bound on its compiled engines, so an evicted
# key counts its traces again
_ENGINE_CACHE: Dict[Tuple, set] = {}
_ENGINE_CACHE_MAX = 64


def _shapes(*trees: Optional[Params]) -> Tuple:
    return tuple(None if tree is None else
                 tuple((k, tuple(v.shape), str(v.dtype))
                       for k, v in sorted(tree.items()))
                 for tree in trees)


def _count_trace(key: Tuple, shapes: Tuple) -> None:
    """Bump ``ENGINE_STATS["traces"]`` the first time the static ``key``
    meets these argument ``shapes``, as the reference's compile would."""
    seen = _ENGINE_CACHE.get(key)
    if seen is None:
        while len(_ENGINE_CACHE) >= _ENGINE_CACHE_MAX:
            _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
        seen = _ENGINE_CACHE[key] = set()
    if shapes not in seen:
        seen.add(shapes)
        ENGINE_STATS["traces"] += 1


def _single_variant(engine: _Engine, cfg: SimConfig,
                    wcfg: wireless.WirelessConfig, params: Params,
                    dev: torch.device) -> _Variant:
    """The variant of a single run: ``cfg``'s seed and parameters."""
    return engine.variant(
        trandom.PRNGKey(cfg.seed, dev), wireless.channel_params(wcfg, dev),
        _resolve_cparams(cfg, params, dev), _resolve_aparams(cfg, dev),
        cfg.faults.to(dev) if cfg.faults is not None else None,
        _resolve_pparams(cfg, dev) if cfg.privacy != "none" else None,
        fl_server.flat_dim(params))


def run_simulation_scan(cfg: SimConfig, loss_fn, init_params: Params,
                        batches: Optional[Params] = None, *,
                        eval_batch: Optional[Params] = None,
                        wcfg: Optional[wireless.WirelessConfig] = None,
                        device="cuda") -> Tuple[Params, SimLogs]:
    """Run ``cfg.rounds`` rounds on ``device``.

    ``batches``: dict of ``(rounds, n_devices, H, ...)`` tensors (see
    :func:`stack_batches`), or ``None`` when ``cfg.datagen`` makes batches
    on the device one client block at a time. ``eval_batch`` (optional)
    makes the logged loss ``loss_fn(params, eval_batch)``. Returns (final
    params, stacked logs).
    """
    if batches is None and cfg.datagen is None:
        raise ValueError("run_simulation_scan needs batches= (stack_batches) "
                         "or a SimConfig.datagen")
    dev = resolve_device(device)
    wcfg = wcfg or wireless.WirelessConfig(n_devices=cfg.n_devices)
    params = _on(init_params, dev)
    batches, eval_batch = _on(batches, dev), _on(eval_batch, dev)
    has_eval = eval_batch is not None
    _count_trace(_engine_key(cfg, wcfg, loss_fn, has_eval, "single"),
                 _shapes(params, batches, eval_batch))
    engine = _Engine(cfg, wcfg, loss_fn, has_eval)
    v = _single_variant(engine, cfg, wcfg, params, dev)
    params, outs = engine.run(v, params, batches, eval_batch)
    return params, SimLogs(**_log_columns(outs, cfg.n_devices))


def run_simulation(cfg: SimConfig, loss_fn, init_params: Params,
                   sample_client_batches: Callable[[int, int], Dict],
                   eval_fn: Optional[Callable] = None,
                   wcfg: Optional[wireless.WirelessConfig] = None,
                   engine: Optional[str] = None,
                   device="cuda") -> List[RoundLog]:
    """Per-round ``RoundLog`` entry point.

    ``engine=None`` picks :func:`run_simulation_scan`, or the host loop for
    an opaque ``eval_fn``; ``"scan"`` / ``"host"`` force one. An ``eval_fn``
    with an ``eval_batch`` attribute makes the logged loss ``loss_fn(params,
    eval_batch)`` without calling it; without one the host loop logs
    ``eval_fn(params)``. The host loop samples each round's batches as it
    goes instead of stacking them all first.
    """
    if engine not in (None, "scan", "host"):
        raise ValueError(f"unknown engine {engine!r}; use 'scan' or 'host'")
    if cfg.rounds == 0:
        return []
    wcfg = wcfg or wireless.WirelessConfig(n_devices=cfg.n_devices)
    eval_batch = getattr(eval_fn, "eval_batch", None) if eval_fn else None
    opaque_eval = eval_fn is not None and eval_batch is None
    if engine == "scan" and opaque_eval:
        raise ValueError(
            "engine='scan' needs an in-program eval: attach eval_fn."
            "eval_batch (logged loss becomes loss_fn(params, eval_batch)) "
            "or drop engine= to let the host loop serve the opaque eval_fn")
    if engine == "host" or opaque_eval:
        return _run_simulation_host(cfg, loss_fn, init_params,
                                    sample_client_batches, eval_fn,
                                    eval_batch, wcfg, device)
    batches = (None if cfg.datagen is not None else
               stack_batches(sample_client_batches, cfg.rounds,
                             cfg.n_devices))
    _, logs = run_simulation_scan(cfg, loss_fn, init_params, batches,
                                  eval_batch=eval_batch, wcfg=wcfg,
                                  device=device)
    return logs.to_round_logs()


def _run_simulation_host(cfg: SimConfig, loss_fn, init_params: Params,
                         sample_client_batches, eval_fn, eval_batch,
                         wcfg: wireless.WirelessConfig,
                         device) -> List[RoundLog]:
    """Round-by-round loop over the scan's own step, with each round's
    batches sampled when it starts and its log read back at once."""
    dev = resolve_device(device)
    has_eval = eval_batch is not None
    params, eval_batch = _on(init_params, dev), _on(eval_batch, dev)
    engine = _Engine(cfg, wcfg, loss_fn, has_eval)
    v = _single_variant(engine, cfg, wcfg, params, dev)
    carry = engine.init(params)
    logs: List[RoundLog] = []
    for t in range(cfg.rounds):
        bt = (None if cfg.datagen is not None
              else _on(sample_client_batches(t, cfg.n_devices), dev))
        carry, (loss, clock, mask, nsched, ubits, comm_s, comp_s, dl_bits,
                n_surv, n_drop, retx, stal, eps, dlt, mbits) = engine.step(
            t, carry, v, bt, eval_batch)
        lv = float(loss)
        if eval_fn is not None and not has_eval:
            lv = eval_fn(carry.state.params)
        logs.append(RoundLog(t, float(clock), lv, int(nsched),
                             mask.cpu().numpy(), float(ubits), float(comm_s),
                             float(comp_s), float(dl_bits), int(n_surv),
                             int(n_drop), float(retx), float(stal),
                             float(eps), float(dlt), float(mbits)))
    return logs


# ---------------------------------------------------------------------------
# Sweeps: seed x channel x compression x algorithm x fault x privacy x
# policy variants, one after another on one device
# ---------------------------------------------------------------------------
# Policies whose decision reads the static per-subchannel bandwidth
# (PolicyConfig.sub_bw) or whose latency/deadline math specializes on the
# cell's static bandwidth: a bandwidth grid cannot vary under them.
_BW_STATIC_POLICIES = ("age", "deadline", "bn2", "bn2_c")


def _validate_sweep_wcfgs(wcfgs: Sequence[wireless.WirelessConfig],
                          policies: Sequence[str]) -> None:
    """Static fields must match across every entry, and latency-sensitive
    policies also pin ``bandwidth_hz``."""
    ref = wcfgs[0]
    bw_pols = sorted(set(policies) & set(_BW_STATIC_POLICIES))
    for i, w in enumerate(wcfgs):
        if (w.n_devices, w.n_subchannels) != (ref.n_devices,
                                              ref.n_subchannels):
            raise ValueError(
                f"sweep wcfgs must share static fields (n_devices, "
                f"n_subchannels): wcfgs[{i}] has "
                f"({w.n_devices}, {w.n_subchannels}), wcfgs[0] has "
                f"({ref.n_devices}, {ref.n_subchannels})")
        if bw_pols and w.bandwidth_hz != ref.bandwidth_hz:
            raise ValueError(
                f"sweep wcfgs must share static bandwidth_hz for the "
                f"latency-sensitive policies {bw_pols} (their sub-band "
                f"bandwidth / deadline pricing compiles in statically): "
                f"wcfgs[{i}].bandwidth_hz={w.bandwidth_hz} != "
                f"wcfgs[0].bandwidth_hz={ref.bandwidth_hz}")


def _resolve_sweep_mesh(devices, mesh):
    """The ``devices=`` / ``mesh=`` knob -> a 1-D mesh of members
    (``launch/mesh.py``), or None for one device. ``devices`` is
    ``"auto"`` (every member of the process group), an int or a sequence
    (that many members: the whole group, or one); ``mesh`` a mesh with one
    axis. More than one member needs a process group of exactly that many:
    outside one, or beside a group of another size, it raises."""
    if devices is not None and mesh is not None:
        raise ValueError("pass devices= or mesh=, not both")
    if mesh is not None:
        if len(mesh.axis_names) != 1:
            raise ValueError(f"run_sweep shards the flattened variant axis "
                             f"over a 1-D mesh; got axes {mesh.axis_names}")
        return mesh if mesh.size > 1 else None
    if devices is None:
        return None
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    if devices == "auto":
        count = world
    elif isinstance(devices, int):
        if devices > world:
            raise ValueError(
                f"devices={devices} but only {world} member(s) are in the "
                "process group: launch that many (torchrun, or "
                "launch/members.py)")
        count = devices
    else:
        count = len(list(devices))
    if count <= 1:
        return None
    return Mesh((count,), ("variants",))


def _block_of(grid: list, mesh) -> list:
    """This member's contiguous block of the variants, padded with copies
    of variant 0 up to a multiple of the members (the ragged-grid filler;
    the logs are cut back)."""
    n = mesh.size
    padded = grid + [grid[0]] * ((-len(grid)) % n)
    b = len(padded) // n
    return padded[mesh.rank * b:(mesh.rank + 1) * b]


def _gather_variants(cols: Dict[str, np.ndarray], mesh, v: int
                     ) -> Dict[str, np.ndarray]:
    """Every member's block of logs, in rank order, cut back to ``v``."""
    parts = [None] * mesh.size
    torch.distributed.all_gather_object(parts, cols,
                                        group=mesh.group(mesh.axis_names[0]))
    return {f: np.concatenate([p[f] for p in parts])[:v] for f in cols}


def run_sweep(cfg: SimConfig, loss_fn, init_params: Params, batches: Params,
              *, seeds: Sequence[int],
              wcfgs: Optional[Sequence[wireless.WirelessConfig]] = None,
              policies: Optional[Sequence[str]] = None,
              compressions: Optional[Sequence[str]] = None,
              cparams_grid: Optional[Sequence[CompressionParams]] = None,
              algorithms: Optional[Sequence[str]] = None,
              aparams_grid: Optional[Sequence[AlgoParams]] = None,
              fparams_grid: Optional[Sequence[FaultParams]] = None,
              privacies: Optional[Sequence[str]] = None,
              pparams_grid: Optional[Sequence[PrivacyParams]] = None,
              eval_batch: Optional[Params] = None,
              hcfg=None, hcfgs=None, policy_mode: str = "mixture",
              devices=None, mesh=None, device="cuda"
              ) -> Dict[Any, SimLogs]:
    """Sweep policies x compressor names x algorithm names x privacy names
    x seeds x channels x compression levels x algorithm hyperparameters x
    fault and privacy parameters, on ``device``.

    Returns ``{policy: SimLogs}``, the key growing to ``(policy,
    compression)``, ``(policy, algorithm)``, ``(policy, privacy)`` and their
    combinations (in that order) when the ``compressions`` / ``algorithms``
    / ``privacies`` name axes are given. Arrays have shape ``(variants,
    rounds, ...)``, variants ordered ``itertools.product(seeds, wcfgs,
    cparams_grid, aparams_grid, fparams_grid, pparams_grid)``.

    ``policy_mode="mixture"`` (with more than one policy) counts one trace
    for the whole policy set, as the reference compiles one program for it;
    ``"loop"`` counts one per policy. Both run each policy's variants
    through that policy alone, so the results are bitwise equal.
    ``fparams_grid`` makes the fault model an axis (omitted, ``cfg.faults``
    is the one point, or there are no faults); ``pparams_grid`` the privacy
    parameters, passed only to mechanisms other than ``"none"``. All ``wcfgs`` share ``n_devices`` and
    ``n_subchannels`` (and ``bandwidth_hz`` under ``_BW_STATIC_POLICIES``);
    the policy's static sub-band comes from ``wcfgs[0]``, each variant's
    rate from its own channel.

    ``hcfg`` switches the sweep onto the hierarchical engine: every variant
    runs :func:`run_hfl`'s engine (per-cluster scheduling, compressed
    intra-cluster and backhaul pricing; each seed deploys its own geometry),
    one trace counted per (policy, compression, algorithm, privacy) name
    combination; HFL never uses mixture mode. ``hcfgs`` makes the backhaul
    rate a trailing product axis: every entry shares the static fields
    (``HFLConfig.static_key()``), and each variant runs at its own rate.
    ``devices=`` / ``mesh=`` split the variants over the members of a
    process group, one process each (``"auto"``: all of them; an int or a
    sequence: that many, which must be all of them; ``mesh``: a 1-D
    ``launch/mesh.py`` mesh): the grid is padded with copies of variant 0
    up to a multiple of the members, each member runs its contiguous block
    one variant after another, and the logs are all-gathered and cut back,
    so every member returns the whole dict. More members than the group
    has, or any outside a group, raise.
    """
    sweep_mesh = _resolve_sweep_mesh(devices, mesh)
    if sweep_mesh is not None:
        device = member_device(device, sweep_mesh.rank)
    dev = resolve_device(device)
    params = _on(init_params, dev)
    wcfgs = list(wcfgs) if wcfgs else [
        wireless.WirelessConfig(n_devices=cfg.n_devices)]
    policies = list(policies) if policies else [cfg.policy]
    comp_names = list(compressions) if compressions is not None else None
    algo_names = list(algorithms) if algorithms is not None else None
    cparams_list = (list(cparams_grid) if cparams_grid
                    else [_resolve_cparams(cfg, params, dev)])
    aparams_list = (list(aparams_grid) if aparams_grid
                    else [_resolve_aparams(cfg, dev)])
    if policy_mode not in ("mixture", "loop"):
        raise ValueError(f"unknown policy_mode {policy_mode!r}; "
                         "use 'mixture' or 'loop'")
    _validate_sweep_wcfgs(wcfgs, policies)
    if hcfg is not None and hcfgs is not None:
        raise ValueError("pass hcfg= or hcfgs=, not both")
    hlist = (list(hcfgs) if hcfgs is not None
             else ([hcfg] if hcfg is not None else None))
    if hlist is not None:
        if not hlist:
            raise ValueError("hcfgs= needs at least one HFLConfig")
        ref = hlist[0].static_key()
        for i, h in enumerate(hlist):
            if h.static_key() != ref:
                raise ValueError(
                    f"sweep hcfgs must share static fields (everything but "
                    f"the per-variant backhaul_rate_bps): hcfgs[{i}] differs "
                    "from hcfgs[0]")
    fparams_list = (list(fparams_grid) if fparams_grid is not None
                    else ([cfg.faults] if cfg.faults is not None else None))
    faults_on = fparams_list is not None
    if faults_on and not fparams_list:
        raise ValueError("fparams_grid= needs at least one FaultParams")
    priv_iter = list(privacies) if privacies is not None else [cfg.privacy]
    if not priv_iter:
        raise ValueError("privacies= needs at least one mechanism name")
    any_priv = any(p != "none" for p in priv_iter)
    # the pparams axis stays in the grid even when "none" rides along
    # (uniform variant counts across the name axis); its params are only
    # passed to privacy-enabled engines
    pparams_list = (list(pparams_grid) if pparams_grid is not None
                    else ([_resolve_pparams(cfg, dev)] if any_priv
                          else None))
    if pparams_list is not None and not pparams_list:
        raise ValueError("pparams_grid= needs at least one PrivacyParams")

    grid = list(itertools.product(
        seeds, wcfgs, cparams_list, aparams_list,
        fparams_list if faults_on else [None],
        pparams_list if pparams_list is not None else [None],
        hlist if hlist is not None else [None]))
    if not grid:
        raise ValueError("run_sweep needs at least one "
                         "(seed, wcfg, cparams, aparams) variant")
    batches, eval_batch = _on(batches, dev), _on(eval_batch, dev)
    has_eval = eval_batch is not None
    d_model = fl_server.flat_dim(params)
    comp_iter = comp_names if comp_names is not None else [cfg.compression]
    algo_iter = algo_names if algo_names is not None else [cfg.algorithm]

    def result_key(pol, comp, alg, priv):
        parts = ((pol,)
                 + ((comp,) if comp_names is not None else ())
                 + ((alg,) if algo_names is not None else ())
                 + ((priv,) if privacies is not None else ()))
        return parts[0] if len(parts) == 1 else parts

    def cfg_variant(pol, comp, alg, priv) -> SimConfig:
        return dataclasses.replace(
            cfg, policy=pol, compression=comp, algorithm=alg,
            faults=fparams_list[0] if faults_on else cfg.faults,
            privacy=priv,
            privacy_params=(pparams_list[0] if priv != "none"
                            and pparams_list is not None
                            else cfg.privacy_params))

    def run_grid(pol, comp, alg, priv) -> SimLogs:
        """Every variant of the base grid under one name combination."""
        cfg_v = cfg_variant(pol, comp, alg, priv)
        engine = (_HFLEngine(cfg_v, hlist[0], wcfgs[0], loss_fn, has_eval)
                  if hlist is not None
                  else _Engine(cfg_v, wcfgs[0], loss_fn, has_eval))
        cols = []
        block = grid if sweep_mesh is None else _block_of(grid, sweep_mesh)
        for seed, w, cp, ap, fp, pp, h in block:
            args = (trandom.PRNGKey(seed, dev),
                    wireless.channel_params(w, dev), cp.to(dev), ap.to(dev))
            if h is not None:
                args += (h.backhaul_rate_bps,)
            v = engine.variant(*args, fp.to(dev) if faults_on else None,
                               pp.to(dev) if priv != "none" else None,
                               d_model)
            cols.append(_log_columns(
                engine.run(v, params, batches, eval_batch)[1],
                cfg.n_devices))
        logs = {f: np.stack([c[f] for c in cols]) for f in _LOG_FIELDS}
        if sweep_mesh is not None:
            logs = _gather_variants(logs, sweep_mesh, len(grid))
        return SimLogs(**logs)

    shapes = _shapes(params, batches, eval_batch)
    combos = list(itertools.product(comp_iter, algo_iter, priv_iter))
    results: Dict[Any, SimLogs] = {}
    if hlist is None and policy_mode == "mixture" and len(policies) > 1:
        # the reference compiles one program a name combination for the
        # whole policy set, the grid tiled policy-major
        for comp, alg, priv in combos:
            _count_trace(_engine_key(
                cfg_variant(policies[0], comp, alg, priv), wcfgs[0], loss_fn,
                has_eval, "sweep", tuple(policies)),
                (len(grid) * len(policies),) + shapes)
            for pol in policies:
                results[result_key(pol, comp, alg, priv)] = run_grid(
                    pol, comp, alg, priv)
        return results

    for pol in policies:
        for comp, alg, priv in combos:
            cfg_v = cfg_variant(pol, comp, alg, priv)
            _count_trace(_engine_key(cfg_v, wcfgs[0], loss_fn, has_eval,
                                     "sweep") if hlist is None else
                         _hfl_engine_key(cfg_v, hlist[0], wcfgs[0], loss_fn,
                                         has_eval, "hfl-sweep"),
                         (len(grid),) + shapes)
            results[result_key(pol, comp, alg, priv)] = run_grid(
                pol, comp, alg, priv)
    return results


# ---------------------------------------------------------------------------
# Hierarchical FL simulation (Alg. 9): the wireless-aware cluster -> cloud
# engine
#
# The same channel, compression and policy machinery as flat FL: every device
# talks to its nearest SBS over the fading channel (per-cluster
# ChannelParams gathered per device), each cluster runs the registry policy
# over its own members, compressed intra-cluster payloads (with EF and
# SCAFFOLD's control variates in the round state) price the device->SBS
# uplink, and the periodic SBS->MBS sync ships a separately compressed and
# priced backhaul payload over a fixed-rate fronthaul. Rows compress through
# the registry's plain row operators, as the reference's vmapped compressor
# does: no kernel is on this path.
# ---------------------------------------------------------------------------
_HFL_ALGOS = ("fedavg", "fedavg_m", "fedprox", "scaffold")


def _check_hfl_config(cfg: SimConfig) -> None:
    algo = algo_registry.get_algorithm(cfg.algorithm)
    if algo.name not in _HFL_ALGOS:
        raise ValueError(
            f"run_hfl supports client-side algorithms "
            f"({'/'.join(_HFL_ALGOS)}), not {algo.name!r}: Alg. 9 aggregates "
            "raw cluster models, so server-side optimizer state (slowmo/"
            "fedadam/fedyogi) has no SBS or MBS slot to live in. SCAFFOLD "
            "is supported with cluster-level server control variates.")
    if cfg.double_ef:
        raise ValueError(
            "run_hfl does not support double_ef: HFL has no single PS "
            "downlink to carry server-side EF state — each SBS broadcasts "
            "its raw cluster model. Drop double_ef (uplink EF still "
            "applies) or use the flat engine.")
    if (cfg.chunk_size is not None or cfg.datagen is not None
            or cfg.ef_mode != "dense" or cfg.state_dtype != "float32"):
        raise ValueError(
            "run_hfl does not support the fleet-scale knobs (chunk_size/"
            "datagen/ef_mode='sparse'/state_dtype='bfloat16'); they live on "
            "the flat engine, whose N is the fleet-scale axis")


def _fold_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of a short vector in the reference's order: its compiled
    reduction of up to 32 elements adds them one by one from 0 (longer
    vectors take ``torch.sum``)."""
    if x.shape[0] > 32:
        return x.sum()
    s = torch.zeros((), dtype=torch.float32, device=x.device)
    for v in x.to(torch.float32):
        s = s + v
    return s


class _HFLVariant(NamedTuple):
    """One run's inputs and what the engine derives from them once."""
    cparams: CompressionParams
    aparams: AlgoParams
    bh_rate: torch.Tensor           # SBS->MBS fronthaul rate, bits/s
    fparams: Optional[FaultParams]
    pparams: Optional[PrivacyParams]
    chan_dev: wireless.ChannelParams  # each device's cell (gathered)
    cluster_ids: torch.Tensor       # (N,) int64
    dist: torch.Tensor              # (N,) distance to the own SBS
    member: torch.Tensor            # (L, N) bool
    cluster_sizes: torch.Tensor     # (L,) float32
    w_cluster: torch.Tensor         # (L,) population weights
    k_rounds: torch.Tensor
    bits_dev: torch.Tensor          # priced uplink bits, () or (N,)
    mask_over: torch.Tensor         # key-agreement bits, () or (N,)
    payload_scale: float


@dataclasses.dataclass
class _HFLCarry:
    """The round state: the reference's HFL scan carry."""
    cm: Params                      # (L, ...) cluster models
    gm: Params                      # the global model at the MBS
    ef: Optional[torch.Tensor]      # (N, D) uplink EF
    ctrl: Optional[torch.Tensor]    # (N, D) SCAFFOLD client variates
    cc: Optional[torch.Tensor]      # (L, D) SCAFFOLD cluster variates
    clock: torch.Tensor
    ages: torch.Tensor
    norms: torch.Tensor
    avg_snr: torch.Tensor
    avail: Optional[torch.Tensor] = None
    fad: Optional[torch.Tensor] = None
    stal: Optional[torch.Tensor] = None
    rdp: Optional[torch.Tensor] = None


class _HFLEngine:
    """The static half of an HFL run, the counterpart of the reference's
    ``_make_hfl_fns``. ``cfg.n_scheduled`` is the per-cluster budget: one
    int shared by every cluster, or a tuple with one budget per cluster.

    One round (Alg. 9 + §III wireless): every device draws fading against
    its own SBS and prices its compressed payload; each cluster schedules
    its members; scheduled clients' EF-compressed deltas average into their
    cluster model; every ``inter_cluster_period`` rounds each SBS uplinks
    its compressed cluster-model delta over the fronthaul and the MBS
    averages (population-weighted) and broadcasts. The round's time is the
    slowest scheduled device's plus the backhaul's on sync rounds."""

    def __init__(self, cfg: SimConfig, hcfg, wcfg: wireless.WirelessConfig,
                 loss_fn, has_eval: bool):
        n = self.n = cfg.n_devices
        self.n_clusters = hcfg.n_clusters
        self.period = hcfg.inter_cluster_period
        self.per_cluster_k = isinstance(cfg.n_scheduled, tuple)
        if self.per_cluster_k and len(cfg.n_scheduled) != self.n_clusters:
            raise ValueError(
                f"per-cluster n_scheduled needs one budget per cluster "
                f"({self.n_clusters}), got {len(cfg.n_scheduled)}")
        self.ks = (tuple(cfg.n_scheduled) if self.per_cluster_k
                   else (cfg.n_scheduled,) * self.n_clusters)
        self.pcfg = dataclasses.replace(_policy_cfg(cfg, wcfg),
                                        n_scheduled=self.ks[0])
        self.policy_fn = scheduling.get_policy(cfg.policy)
        _check_hfl_config(cfg)
        self.cfg, self.hcfg, self.loss_fn, self.has_eval = (
            cfg, hcfg, loss_fn, has_eval)
        self.algo = algo_registry.get_algorithm(cfg.algorithm)
        self.comp_active = cfg.compression != "none"
        # the registry's plain row operator (no kernel dispatch)
        self.compress = (compression.rows_compressor(cfg.compression)
                         if self.comp_active else None)
        self.faults_on = cfg.faults is not None
        # masks cancel within each cluster: the SBS is the aggregator, so
        # pairwise keys (and their wire overhead) are scoped to cluster
        # peers, and the per-cluster modular sum unmasks exactly
        self.priv_on = cfg.privacy != "none"
        self.priv = (privacy_lib.get_privacy(cfg.privacy) if self.priv_on
                     else None)
        self.dp_on = self.priv_on and self.priv.uses_dp
        self.masks_on = self.priv_on and self.priv.uses_masks
        self.field_on = self.priv_on and self.priv.uses_field

    def variant(self, key: torch.Tensor, chan: wireless.ChannelParams,
                cparams: CompressionParams, aparams: AlgoParams,
                bh_rate: float, fparams: Optional[FaultParams],
                pparams: Optional[PrivacyParams], d_model: int
                ) -> _HFLVariant:
        """A run's inputs with its deployment (from the seed's ``k_geo``),
        round-key root and prices."""
        cfg, dev = self.cfg, key.device
        k_geo, k_rounds = trandom.split(key)
        cluster_ids, dist, member, sizes = hierarchy.hfl_geometry_jax(
            k_geo, self.hcfg, self.n)
        ids = cluster_ids.to(torch.int64)
        payload_scale = cfg.model_bits / (32.0 * d_model)
        msg_bits = message_bits_jax(cfg.compression, cparams, cfg.model_bits,
                                    d_model)
        if self.field_on:
            # a masked message is incompressible: dense field_bits per
            # coordinate replaces the compressor's rate on the wire
            msg_bits = payload_scale * privacy_lib.uplink_bits_jax(
                cfg.privacy, pparams, d_model, 0.0)
        bits_dev = msg_bits * self.algo.uplink_factor
        mask_over = torch.zeros((), device=dev)
        if self.masks_on:
            # key agreement with cluster peers only: a device's overhead
            # follows its cell's population, so bits_dev becomes (N,)
            mask_over = privacy_lib.mask_bits_jax(
                cfg.privacy, torch.clamp_min(sizes[ids] - 1.0, 0.0), dev)
            bits_dev = bits_dev + mask_over
        return _HFLVariant(
            cparams, aparams,
            torch.as_tensor(bh_rate, dtype=torch.float32, device=dev),
            fparams, pparams, wireless.gather_channel_params(chan, ids), ids,
            dist, member, sizes, sizes / torch.clamp_min(sizes.sum(), 1.0),
            k_rounds, bits_dev, mask_over, payload_scale)

    def init(self, params: Params) -> _HFLCarry:
        """The round state before round 0: every cluster model and the
        global model at ``params``."""
        n, L = self.n, self.n_clusters
        dev = next(iter(params.values())).device
        d = fl_server.flat_dim(params)
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        mat = (lambda rows: torch.zeros((rows, d), dtype=torch.float32,
                                        device=dev))
        carry = _HFLCarry(
            {k: v[None].expand((L,) + tuple(v.shape)).clone()
             for k, v in params.items()},
            {k: v.clone() for k, v in params.items()},
            mat(n) if self.comp_active else None,
            mat(n) if self.algo.uses_ctrl else None,
            mat(L) if self.algo.uses_ctrl else None,
            torch.zeros((), dtype=torch.float32, device=dev),
            zeros, torch.ones_like(zeros), zeros)
        if self.faults_on:
            carry.avail = torch.ones(n, dtype=torch.bool, device=dev)
            carry.fad = torch.zeros((n, 2), dtype=torch.float32, device=dev)
            carry.stal = zeros
        if self.dp_on:
            carry.rdp = torch.zeros(len(privacy_lib.ALPHAS),
                                    dtype=torch.float32, device=dev)
        return carry

    def _rate(self, v: _HFLVariant, snr: torch.Tensor) -> torch.Tensor:
        """Each device shares its own cell's uplink budget. The reference's
        compiled program divides by a constant budget as a multiply by its
        float32 reciprocal."""
        bw = v.chan_dev.bandwidth_hz
        if self.per_cluster_k:
            ks = torch.tensor(self.ks, dtype=torch.float32,
                              device=snr.device)[v.cluster_ids]
            return wireless.shannon_rate_jax(snr, bw / ks)
        return wireless.shannon_rate_jax(snr, bw * (1.0 / self.cfg.n_scheduled))

    def _schedule(self, t: int, rstate: scheduling.RoundState,
                  member_eff: torch.Tensor, keys_l: torch.Tensor,
                  v: _HFLVariant) -> torch.Tensor:
        """(L, N) per-cluster masks, each cluster with its own static budget.
        ``random`` and ``round_robin`` are cluster-aware twins of the
        policies (a random member k-subset; a rotation over each cluster's
        static member ranks); the score policies see an intra-cluster view
        of the round state, so their top-k picks at most the members."""
        pol, n = self.cfg.policy, self.n
        if pol == "random":
            score = torch.where(member_eff, trandom.uniform(keys_l, (n,)),
                                -torch.inf)
        elif pol == "round_robin":
            rank = torch.cumsum(v.member.to(torch.float32), dim=1) - 1.0
            t_f = torch.tensor(float(t), device=rank.device)
        masks = []
        for l, k_l in enumerate(self.ks):
            m = member_eff[l]
            if pol == "random":
                masks.append(scheduling.topk_mask_jax(score[l], k_l) & m)
            elif pol == "round_robin":
                # floor(|C_l| / k) groups, the division as the reference's
                # multiply by the constant's reciprocal
                g_l = torch.clamp_min(torch.floor(
                    v.cluster_sizes[l] * (1.0 / k_l)), 1.0)
                g = torch.remainder(t_f, g_l)
                masks.append(m & (rank[l] >= g * k_l)
                             & (rank[l] < (g + 1) * k_l))
            else:
                stl = scheduling.masked_round_state(rstate, m, keys_l[l])
                pcfg = dataclasses.replace(self.pcfg, n_scheduled=k_l)
                masks.append(self.policy_fn(pcfg, stl) & m)
        return torch.stack(masks)

    def step(self, t: int, carry: _HFLCarry, v: _HFLVariant,
             batches: Params, eval_batch: Optional[Params]
             ) -> Tuple[_HFLCarry, Tuple]:
        """Round ``t``: the new round state and the round's log values in
        ``_LOG_FIELDS`` order. ``batches`` are the round's (N, H, ...)
        tensors."""
        cfg, n, L, priv = self.cfg, self.n, self.n_clusters, self.priv
        algo, fparams, pparams = self.algo, v.fparams, v.pparams
        faults_on, chan = self.faults_on, v.chan_dev
        cm, gm, ef, ctrl, cc = carry.cm, carry.gm, carry.ef, carry.ctrl, \
            carry.cc
        avail, fad, stal, rdp = carry.avail, carry.fad, carry.stal, carry.rdp
        dev = v.dist.device
        zero = torch.zeros((), device=dev)

        kt = trandom.fold_in(v.k_rounds, t)
        kf, kc, kp, kn, kz = trandom.split(kt, 5)
        if self.priv_on:
            k_priv = trandom.fold_in(kt, privacy_lib.PRIVACY_FOLD)

        # --- channel draw + intra-cluster uplink pricing ------------------
        if faults_on:
            fad, fading = faults_lib.gauss_markov_fading(fparams, kt, fad, t)
        else:
            fading = wireless.sample_fading_jax(kf, n)
        snr_lin = wireless.snr_jax(v.dist, fading, chan)
        rates = self._rate(v, snr_lin)
        comp_lat = cfg.comp_latency_s * trandom.exponential(kc, (n,))
        if faults_on:
            comp_lat = comp_lat * faults_lib.straggler_multiplier(fparams,
                                                                  kt, n)
        d_model = fl_server.flat_dim(gm)
        bits_dev, mask_over = v.bits_dev, v.mask_over

        def bill(w_):
            # per-device bits_dev (mask overhead on) sums its products;
            # otherwise a scalar price times the count
            return (_fold_sum(bits_dev * w_) if self.masks_on
                    else bits_dev * w_.sum())

        comm_lat = wireless.comm_latency_jax(bits_dev, rates)
        avg_snr = (snr_lin if t == 0
                   else 0.9 * carry.avg_snr + 0.1 * snr_lin)

        # --- per-cluster scheduling (registry policy) ---------------------
        if faults_on:
            # churned-off devices disappear from their cluster's view
            avail = faults_lib.churn_step(fparams, kt, avail)
            member_eff = v.member & avail[None, :]
        else:
            member_eff = v.member
        rstate = scheduling.RoundState(
            t=t, key=kp, snr_lin=snr_lin, avg_snr=avg_snr, rates=rates,
            comm_lat=comm_lat, comp_lat=comp_lat, ages=carry.ages,
            update_norms=carry.norms)
        masks_l = self._schedule(t, rstate, member_eff,
                                 trandom.split(kp, L), v)
        mask = masks_l.any(dim=0)
        stal_pre = stal
        ages = scheduling.update_ages_jax(carry.ages, mask)
        mask_f = mask.to(torch.float32)

        # --- mid-round dropout + decode failure + retransmissions ---------
        dec = (_decode_with_retries(
            fparams, kt, mask, snr_lin, comm_lat, v.dist, chan, bits_dev,
            lambda snr: self._rate(v, snr), cfg.max_retries)
            if faults_on else None)
        part_f = dec.survived.to(torch.float32) if faults_on else mask_f

        # --- local updates from each device's cluster model ---------------
        client_params = hierarchy.broadcast_to_clients(cm, v.cluster_ids)
        if algo.uses_ctrl:
            ci_tree = algo_registry.unflatten_rows(ctrl, gm)
            cdev_tree = algo_registry.unflatten_rows(cc[v.cluster_ids], gm)
            deltas, ctrl_deltas, losses = torch.func.vmap(
                lambda p, b, ci, cd: algo.client_update(
                    self.loss_fn, v.aparams, p, b, (ci, cd)))(
                client_params, batches, ci_tree, cdev_tree)
            ctrl_flat, _ = fl_server.flatten_clients(ctrl_deltas)
        else:
            def one(p, b):  # (delta, loss): vmap outputs no None
                delta, _, loss = algo.client_update(self.loss_fn, v.aparams,
                                                    p, b, None)
                return delta, loss

            deltas, losses = torch.func.vmap(one)(client_params, batches)
            ctrl_flat = None

        # --- client-side compression + EF in message space ----------------
        flat, _ = fl_server.flatten_clients(deltas)               # (N, D)
        ctrl_wire = ctrl_flat
        if self.comp_active:
            k_up, k_ctrl, k_bh = trandom.split(kz, 3)
            flat = flat + ef
            wire, bits = self.compress(v.cparams, trandom.split(k_up, n),
                                       flat)
            # every device compresses; under faults a lost client's
            # residual carries forward untouched
            ef = (torch.where(dec.survived[:, None], flat - wire, ef)
                  if faults_on else flat - wire)
            flat = wire
            if ctrl_flat is not None:
                ctrl_wire, cbits = self.compress(
                    v.cparams, trandom.split(k_ctrl, n), ctrl_flat)
                bits = bits + cbits
            if self.field_on:
                # the wire carries field elements, not compressor output
                bits = (pparams.field_bits * float(d_model)).expand(
                    bits.shape)
            ubits_intra = v.payload_scale * _fold_sum(bits * part_f)
            if self.masks_on:
                # key agreement for every scheduled member (it precedes the
                # transmission that may then fail)
                ubits_intra = ubits_intra + _fold_sum(mask_over * mask_f)
            if faults_on:
                # undecoded attempts' airtime; the reference's compiled step
                # contracts the scalar price's bill into a fused multiply-add
                retry = torch.where(
                    dec.sent, dec.n_retx + (~dec.ok).to(torch.float32), 0.0)
                ubits_intra = (ubits_intra + bill(retry) if self.masks_on
                               else _fma(bits_dev, retry.sum(), ubits_intra))
        else:
            k_bh = kz
            ubits_intra = (bill(torch.where(dec.sent, 1.0 + dec.n_retx, 0.0))
                           if faults_on else bill(mask_f))

        # --- SBS aggregation: masked per-cluster delta mean ---------------
        # (under faults only the survivors; a cluster whose every scheduled
        # member failed keeps its model bitwise)
        wgt = v.member.to(torch.float32) * part_f[None, :]         # (L, N)
        cnt = wgt.sum(dim=1)                                       # (L,)
        denom = torch.clamp_min(cnt, 1.0)[:, None]
        if self.field_on:
            # finite-field secure aggregation per cluster: encode every row,
            # add pairwise masks scoped to cluster peers, sum each cluster
            # mod 2^32, decode the centered representative
            surv = part_f > 0.0
            ids_all = torch.arange(n, device=dev)
            q = priv.client_transform(pparams, k_priv, ids_all, flat)
            if self.masks_on:
                g = privacy_lib.mask_rows(k_priv, ids_all, d_model)
                gsum_l = self._segment_sum(
                    torch.where(surv[:, None], g, 0), v.cluster_ids)
                cnt_l = self._segment_sum(surv.to(torch.int64),
                                          v.cluster_ids)
                q = (q + cnt_l[v.cluster_ids][:, None] * g
                     - gsum_l[v.cluster_ids]) & FIELD_MASK
            qsum_l = self._segment_sum(torch.where(surv[:, None], q, 0),
                                       v.cluster_ids)
            mean_delta = priv.server_transform(pparams, k_priv,
                                               qsum_l) / denom
        elif self.priv_on:
            # central DP at each SBS: clip every row, then independent
            # Gaussian noise per cluster aggregate
            flat_c = priv.client_transform(
                pparams, k_priv, torch.arange(n, device=dev), flat)
            keys_l = chunking.client_keys(
                trandom.fold_in(k_priv, privacy_lib.NOISE_FOLD),
                torch.arange(L, device=dev))
            noise = pparams.sigma * pparams.clip * trandom.normal(
                keys_l, (d_model,))
            mean_delta = (wgt @ flat_c + torch.where(
                cnt[:, None] > 0.0, noise, 0.0)) / denom
        else:
            mean_delta = (wgt @ flat) / denom
        delta_tree = algo_registry.unflatten_rows(mean_delta, gm)
        cm_new = {k: (m_.to(torch.float32) + v.aparams.server_lr
                      * delta_tree[k]).to(m_.dtype) for k, m_ in cm.items()}
        if faults_on:
            alive_l = cnt > 0.0
            cm = {k: torch.where(alive_l.reshape((L,) + (1,) * (x.dim() - 1)),
                                 x, cm[k]) for k, x in cm_new.items()}
        else:
            cm = cm_new

        # --- SCAFFOLD: cluster-level server control variates --------------
        # scheduled clients advance c_i by the transmitted ctrl delta, and
        # the SBS integrates the same quantity scaled by 1/|C_l|
        if algo.uses_ctrl:
            ctrl = ctrl + ctrl_wire * part_f[:, None]
            cc_upd = cc + ((wgt @ ctrl_wire) / torch.clamp_min(
                v.cluster_sizes, 1.0)[:, None])
            cc = (torch.where(alive_l[:, None], cc_upd, cc) if faults_on
                  else cc_upd)

        # --- periodic inter-cluster sync over the SBS->MBS backhaul -------
        sync = (t + 1) % self.period == 0
        if sync:
            cm_flat, _ = fl_server.flatten_clients(cm)             # (L, D)
            gm_flat = algo_registry.flatten_vec(gm)
            bh_deltas = cm_flat - gm_flat[None, :]
            if self.comp_active:
                bh_wire, bh_bits = self.compress(
                    v.cparams, trandom.split(k_bh, L), bh_deltas)
                bh_bits_sbs = v.payload_scale * bh_bits            # (L,)
            else:
                bh_wire = bh_deltas
                bh_bits_sbs = torch.full((L,), float(cfg.model_bits),
                                         dtype=torch.float32, device=dev)
            gm_vec = algo_registry.unflatten_vec(
                gm_flat + v.w_cluster @ bh_wire, gm)
            gm = {k: gm_vec[k].to(g.dtype) for k, g in gm.items()}
            cm = {k: gm[k][None].expand(c.shape).to(c.dtype).clone()
                  for k, c in cm.items()}
            # parallel per-SBS fronthaul links, one transfer each; the price
            # is data-independent, so every SBS's is the same and the
            # reference's compiled sum of it is one product
            bh_time = bh_bits_sbs.amax() / v.bh_rate
            ubits_bh = bh_bits_sbs[0] * float(L)
        else:
            bh_time, ubits_bh = zero, zero
        ubits = ubits_intra + ubits_bh

        # --- downlink: each SBS broadcasts its cluster model to the members
        # opening the round; on sync rounds the MBS also pushes the fresh
        # global model over every SBS's fronthaul link
        mb = torch.tensor(float(cfg.model_bits), dtype=torch.float32,
                          device=dev)
        dl_rate = wireless.shannon_rate_jax(
            wireless.downlink_snr_jax(
                v.dist, faults_lib.downlink_fading(kt, n), chan),
            chan.bandwidth_hz)
        dl_lat = wireless.comm_latency_jax(mb, dl_rate)
        any_sched = mask.any()
        dl_s = torch.where(mask, dl_lat, zero).amax()
        sync_f = float(sync)
        bh_time = bh_time + sync_f * (mb / v.bh_rate)
        dl_bits_out = (torch.where(any_sched, mb * L, zero)
                       + sync_f * mb * L)

        # --- wall clock: slowest scheduled device + backhaul --------------
        comm_s, comp_s = _slowest(mask, comm_lat, comp_lat, dec, zero)
        clock = carry.clock + dl_s + comm_s + comp_s + bh_time

        n_sched = mask.sum().to(torch.int32)
        fault_log = _fault_log(mask, n_sched, dec, stal_pre, zero)
        if faults_on:
            stal = torch.where(dec.survived, 0.0, stal + 1.0)

        # --- (epsilon, delta): clusters compose in parallel (disjoint
        # populations), so the round's guarantee is the worst cell's. Local
        # field noise aggregates to sigma * sqrt(m) in the smallest
        # non-empty cluster; central dp adds sigma per cluster
        if self.dp_on:
            q_frac = part_f.sum() * (1.0 / n)
            if priv.dp_local:
                m_min = torch.where(cnt > 0.0, cnt, torch.inf).amin()
                z_eff = pparams.sigma * torch.sqrt(torch.where(
                    torch.isfinite(m_min), m_min, 1.0))
            else:
                z_eff = pparams.sigma
            rdp = rdp + privacy_lib.rdp_increment(q_frac, z_eff)
            dp_log = (privacy_lib.epsilon_of(rdp),
                      torch.tensor(privacy_lib.DELTA, dtype=torch.float32,
                                   device=dev))
        else:
            dp_log = (torch.tensor(torch.inf, device=dev),
                      torch.tensor(1.0, device=dev))

        loss = losses.mean()
        if self.has_eval:
            loss = self.loss_fn(hierarchy.inter_cluster_average(
                cm, v.cluster_sizes), eval_batch)[0]
        norms = 0.9 * carry.norms + 0.1 * trandom.exponential(kn, (n,))
        carry = _HFLCarry(cm, gm, ef, ctrl, cc, clock, ages, norms, avg_snr,
                          avail, fad, stal, rdp)
        return carry, ((loss, clock, mask, n_sched, ubits, comm_s, comp_s,
                        dl_bits_out) + fault_log + dp_log
                       + (_fold_sum(mask_over * mask_f),))

    def _segment_sum(self, x: torch.Tensor, ids: torch.Tensor
                     ) -> torch.Tensor:
        """Per-cluster sums of int64 field rows (or counts) mod 2^32."""
        out = torch.zeros((self.n_clusters,) + tuple(x.shape[1:]),
                          dtype=torch.int64, device=x.device)
        return out.index_add_(0, ids, x) & FIELD_MASK

    def final(self, carry: _HFLCarry, v: _HFLVariant,
              params: Params) -> Params:
        """The population-weighted global model, in ``params``' types."""
        avg = hierarchy.inter_cluster_average(carry.cm, v.cluster_sizes)
        return {k: avg[k].to(p.dtype) for k, p in params.items()}

    def run(self, v: _HFLVariant, params: Params, batches: Params,
            eval_batch: Optional[Params]) -> Tuple[Params, List[Tuple]]:
        """``cfg.rounds`` steps from ``params``: the final global model and
        each round's log values."""
        carry, outs = self.init(params), []
        for t in range(self.cfg.rounds):
            carry, out = self.step(t, carry, v,
                                   {k: x[t] for k, x in batches.items()},
                                   eval_batch)
            outs.append(out)
        return self.final(carry, v, params), outs


def _hfl_engine_key(cfg: SimConfig, hcfg, wcfg: wireless.WirelessConfig,
                    loss_fn, has_eval: bool, tag: str) -> Tuple:
    """The flat engine's key plus ``hcfg.static_key()``: the backhaul rate
    is a per-run input, so a backhaul-rate grid shares one engine."""
    return _engine_key(cfg, wcfg, loss_fn, has_eval, tag) + (
        hcfg.static_key(),)


def _resolve_hfl_channel(cfg: SimConfig, hcfg, wcfg, cluster_wcfgs, dev
                         ) -> Tuple[wireless.WirelessConfig,
                                    wireless.ChannelParams]:
    """One cell configuration shared by every cluster (scalar ChannelParams
    fields), or one WirelessConfig per cluster (fields with a leading (L,)
    axis, gathered per device in the engine). Returns ``(static wcfg,
    ChannelParams)``. Device placement, and so every device->SBS distance,
    comes from the ``hcfg`` hex geometry, not from ``cell_radius_m``."""
    if wcfg is not None and cluster_wcfgs is not None:
        raise ValueError("pass wcfg= or cluster_wcfgs=, not both")
    if cluster_wcfgs is not None:
        ws = list(cluster_wcfgs)
        if len(ws) != hcfg.n_clusters:
            raise ValueError(
                f"cluster_wcfgs needs one WirelessConfig per cluster "
                f"({hcfg.n_clusters}), got {len(ws)}")
        statics = (ws[0].n_devices, ws[0].n_subchannels)
        for w in ws:
            if (w.n_devices, w.n_subchannels) != statics:
                raise ValueError("cluster_wcfgs must share static fields "
                                 "(n_devices, n_subchannels)")
            if cfg.policy == "age" and w.bandwidth_hz != ws[0].bandwidth_hz:
                raise ValueError(
                    "cluster_wcfgs must share static bandwidth_hz for the "
                    "'age' policy (its sub-band bandwidth compiles in "
                    "statically)")
        return ws[0], wireless.stack_channel_params(ws, dev)
    w = wcfg or wireless.WirelessConfig(n_devices=cfg.n_devices)
    return w, wireless.channel_params(w, dev)


def _hfl_single(cfg: SimConfig, hcfg, loss_fn, init_params: Params,
                has_eval: bool, chan: wireless.ChannelParams,
                wcfg_stat: wireless.WirelessConfig, dev: torch.device
                ) -> Tuple[_HFLEngine, _HFLVariant, Params]:
    """The engine and variant of a single HFL run, ``cfg``'s seed and
    parameters, and the initial params on ``dev``."""
    params = _on(init_params, dev)
    engine = _HFLEngine(cfg, hcfg, wcfg_stat, loss_fn, has_eval)
    v = engine.variant(
        trandom.PRNGKey(cfg.seed, dev), chan,
        _resolve_cparams(cfg, params, dev), _resolve_aparams(cfg, dev),
        hcfg.backhaul_rate_bps,
        cfg.faults.to(dev) if cfg.faults is not None else None,
        _resolve_pparams(cfg, dev) if cfg.privacy != "none" else None,
        fl_server.flat_dim(params))
    return engine, v, params


def _run_hfl_scan(cfg: SimConfig, hcfg, loss_fn, init_params: Params,
                  batches: Params, eval_batch: Optional[Params],
                  chan: wireless.ChannelParams,
                  wcfg_stat: wireless.WirelessConfig, dev: torch.device
                  ) -> Tuple[Params, SimLogs]:
    """``cfg.rounds`` HFL rounds over pre-stacked ``batches`` (see
    :func:`stack_batches`): the final population-weighted global model and
    the stacked logs, what the reference's compiled HFL engine returns."""
    batches, eval_batch = _on(batches, dev), _on(eval_batch, dev)
    has_eval = eval_batch is not None
    engine, v, params = _hfl_single(cfg, hcfg, loss_fn, init_params,
                                    has_eval, chan, wcfg_stat, dev)
    _count_trace(_hfl_engine_key(cfg, hcfg, wcfg_stat, loss_fn, has_eval,
                                 "hfl-single"),
                 (tuple(tuple(f.shape) for f in chan),)
                 + _shapes(params, batches, eval_batch))
    final, outs = engine.run(v, params, batches, eval_batch)
    return final, SimLogs(**_log_columns(outs, cfg.n_devices))


def run_hfl(cfg: SimConfig, hcfg, loss_fn, init_params: Params,
            sample_client_batches: Callable[[int, int], Dict],
            eval_fn: Optional[Callable] = None, *,
            wcfg: Optional[wireless.WirelessConfig] = None,
            cluster_wcfgs: Optional[Sequence[wireless.WirelessConfig]] = None,
            engine: Optional[str] = None, device="cuda") -> List[RoundLog]:
    """Wireless-aware HFL (Alg. 9) on ``device``: per-round ``RoundLog``
    entries.

    Intra-cluster averaging runs every round over the fading device->SBS
    channel (per-cluster scheduling, compressed and priced uplinks);
    inter-cluster sync every ``hcfg.inter_cluster_period`` rounds over the
    ``hcfg.backhaul_rate_bps`` fronthaul. The eval and engine contract is
    :func:`run_simulation`'s; an opaque ``eval_fn`` receives the
    population-weighted global model. ``cluster_wcfgs`` gives each SBS its
    own cell configuration (radiometric fields; distances come from the
    ``hcfg`` hex geometry). ``cfg.n_scheduled`` is the per-cluster budget:
    one int, or a tuple with one budget per cluster (each entry also sets
    that cell's uplink bandwidth split).
    """
    if engine not in (None, "scan", "host"):
        raise ValueError(f"unknown engine {engine!r}; use 'scan' or 'host'")
    _check_hfl_config(cfg)
    if cfg.rounds == 0:
        return []
    dev = resolve_device(device)
    wcfg_stat, chan = _resolve_hfl_channel(cfg, hcfg, wcfg, cluster_wcfgs,
                                           dev)
    eval_batch = getattr(eval_fn, "eval_batch", None) if eval_fn else None
    opaque_eval = eval_fn is not None and eval_batch is None
    if engine == "scan" and opaque_eval:
        raise ValueError(
            "engine='scan' needs an in-program eval: attach eval_fn."
            "eval_batch (logged loss becomes loss_fn(params, eval_batch)) "
            "or drop engine= to let the host loop serve the opaque eval_fn")
    if engine == "host" or opaque_eval:
        return _run_hfl_host(cfg, hcfg, loss_fn, init_params,
                             sample_client_batches, eval_fn, eval_batch,
                             chan, wcfg_stat, dev)
    batches = stack_batches(sample_client_batches, cfg.rounds, cfg.n_devices)
    _, logs = _run_hfl_scan(cfg, hcfg, loss_fn, init_params, batches,
                            eval_batch, chan, wcfg_stat, dev)
    return logs.to_round_logs()


def _run_hfl_host(cfg: SimConfig, hcfg, loss_fn, init_params: Params,
                  sample_client_batches, eval_fn, eval_batch,
                  chan: wireless.ChannelParams,
                  wcfg_stat: wireless.WirelessConfig,
                  dev: torch.device) -> List[RoundLog]:
    """Round-by-round loop over the scan's own HFL step, each round's
    batches sampled when it starts and its log read back at once."""
    has_eval = eval_batch is not None
    eval_batch = _on(eval_batch, dev)
    engine, v, params = _hfl_single(cfg, hcfg, loss_fn, init_params,
                                    has_eval, chan, wcfg_stat, dev)
    carry = engine.init(params)
    logs: List[RoundLog] = []
    for t in range(cfg.rounds):
        bt = _on(sample_client_batches(t, cfg.n_devices), dev)
        carry, (loss, clock, mask, nsched, ubits, comm_s, comp_s, dl_bits,
                n_surv, n_drop, retx, stal, eps, dlt, mbits) = engine.step(
            t, carry, v, bt, eval_batch)
        lv = float(loss)
        if eval_fn is not None and not has_eval:
            lv = eval_fn(hierarchy.inter_cluster_average(carry.cm,
                                                         v.cluster_sizes))
        logs.append(RoundLog(t, float(clock), lv, int(nsched),
                             mask.cpu().numpy(), float(ubits), float(comm_s),
                             float(comp_s), float(dl_bits), int(n_surv),
                             int(n_drop), float(retx), float(stal),
                             float(eps), float(dlt), float(mbits)))
    return logs
