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
  parameters, and returns ``(variants, rounds)`` logs. The reference's
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

Not in this slice: the hierarchical engine (with ``run_sweep(hcfg=,
hcfgs=)``), gossip, and sharding a sweep over several cards.
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
from repro_torch.core import scheduling, wireless
from repro_torch.core.algorithms import registry as algo_registry
from repro_torch.core.algorithms.registry import AlgoParams
from repro_torch.core.compression import registry as compression
from repro_torch.core.compression.registry import CompressionParams
from repro_torch.core.faults import FaultParams
from repro_torch.core.privacy import registry as privacy_lib
from repro_torch.core.privacy.registry import PrivacyParams
from repro_torch.fl import server as fl_server

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
    # hierarchical engine's (not ported), and the flat engine rejects it
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
    """Pre-sample every round's client batches (array-likes: numpy or
    tensors); leaves get a leading ``(rounds,)`` axis."""
    per_round = [sample_client_batches(t, n_devices) for t in range(rounds)]
    return {k: torch.stack([torch.tensor(np.asarray(b[k])) for b in per_round])
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
            chunk_size=self.chunk, n_clients=n, privacy=self.priv)

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
        snr_lin = wireless.snr_jax(v.dist, fading, chan)
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
            update_norms=norms)
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

        if faults_on:
            # dropout, then decode failure with up to max_retries re-priced
            # retransmissions, each on a fresh channel draw
            dropped = faults_lib.dropout_draw(fparams, kt, n) & mask
            ok = snr_lin >= fparams.snr_min
            comm_eff = comm_lat
            n_retx = torch.zeros_like(snr_lin)
            for r in range(1, cfg.max_retries + 1):
                snr_r = wireless.snr_jax(
                    v.dist, faults_lib.retry_fading(kt, r, n), chan)
                lat_r = wireless.comm_latency_jax(
                    v.bits_dev, wireless.shannon_rate_jax(
                        snr_r, chan.bandwidth_hz / cfg.n_scheduled))
                need = ~ok
                comm_eff = comm_eff + torch.where(need, lat_r, 0.0)
                n_retx = n_retx + need.to(torch.float32)
                ok = ok | (snr_r >= fparams.snr_min)
            survived = mask & ~dropped & ok
            sent = mask & ~dropped
            part = survived.to(torch.float32)
        else:
            part = mask.to(torch.float32)
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
                    sent, n_retx + (~ok).to(torch.float32), 0.0).sum(),
                    ubits)
        else:
            state, metrics = self.round_fn(state, batches, **kw)
            ubits = (v.bits_dev * torch.where(sent, 1.0 + n_retx, 0.0).sum()
                     if faults_on else v.bits_dev * n_sched)

        # downlink: the broadcast opens the round at BS power over the full
        # band with its own fading; the slowest scheduled device gates it
        dl_rate = wireless.shannon_rate_jax(
            wireless.downlink_snr_jax(
                v.dist, faults_lib.downlink_fading(kt, n), chan),
            chan.bandwidth_hz)
        dl_lat = wireless.comm_latency_jax(v.dl_bits, dl_rate)
        any_sched = mask.any()
        dl_s = torch.where(mask, dl_lat, zero).amax()
        dl_bits_out = torch.where(any_sched, v.dl_bits, zero)

        # wall clock: synchronous round = slowest scheduled device; a
        # dropped client stops consuming the round, a decode-failed one
        # still burns its airtime
        if faults_on:
            comm_c = torch.where(dropped, 0.0, comm_eff)
            comp_c = torch.where(dropped, 0.0, comp_lat)
        else:
            comm_c, comp_c = comm_lat, comp_lat
        total = comm_c + comp_c
        slowest = torch.argmax(torch.where(mask, total, -torch.inf))
        comm_s = torch.where(any_sched, comm_c[slowest], zero)
        comp_s = torch.where(any_sched, comp_c[slowest], zero)
        clock = clock + dl_s + comm_s + comp_s

        if faults_on:
            fault_log = (survived.sum().to(torch.int32),
                         (mask & ~survived).sum().to(torch.int32),
                         torch.where(sent, n_retx, 0.0).sum(),
                         stal_pre.mean())
            stal = torch.where(survived, 0.0, stal + 1.0)
        else:
            fault_log = (n_sched, torch.zeros_like(n_sched), zero, zero)
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


_NOT_SHARDED = ("multi-card sharding of the sweep is not ported; the port "
                "runs every variant on one card")


def _check_sweep_devices(devices, mesh) -> None:
    """``devices=`` / ``mesh=``: the port runs a sweep on one card, so only
    ``None``, ``1``, ``"auto"`` on one card and a one-device sequence
    apply; more devices than there are raise as in the reference."""
    if devices is not None and mesh is not None:
        raise ValueError("pass devices= or mesh=, not both")
    if mesh is not None:
        raise ValueError(f"run_sweep(mesh=...): {_NOT_SHARDED}")
    if devices is None:
        return
    avail = max(1, torch.cuda.device_count())
    if devices == "auto":
        count = avail
    elif isinstance(devices, int):
        if devices > avail:
            raise ValueError(f"devices={devices} but only {avail} local "
                             "devices are available")
        count = devices
    else:
        count = len(list(devices))
    if count > 1:
        raise ValueError(f"run_sweep(devices={devices!r}): {_NOT_SHARDED}")


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

    ``hcfg`` / ``hcfgs`` (the hierarchical engine) are not ported, and the
    port runs on one card: ``devices`` / ``mesh`` asking for more raise.
    """
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
    if hcfg is not None or hcfgs is not None:
        raise NotImplementedError(
            "run_sweep(hcfg=, hcfgs=) needs the hierarchical engine, which "
            "is not ported yet (ROADMAP queue A item 3)")
    _check_sweep_devices(devices, mesh)
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
        pparams_list if pparams_list is not None else [None]))
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
        engine = _Engine(cfg_variant(pol, comp, alg, priv), wcfgs[0],
                         loss_fn, has_eval)
        cols = []
        for seed, w, cp, ap, fp, pp in grid:
            v = engine.variant(
                trandom.PRNGKey(seed, dev), wireless.channel_params(w, dev),
                cp.to(dev), ap.to(dev), fp.to(dev) if faults_on else None,
                pp.to(dev) if priv != "none" else None, d_model)
            cols.append(_log_columns(
                engine.run(v, params, batches, eval_batch)[1],
                cfg.n_devices))
        return SimLogs(**{f: np.stack([c[f] for c in cols])
                          for f in _LOG_FIELDS})

    shapes = _shapes(params, batches, eval_batch)
    combos = list(itertools.product(comp_iter, algo_iter, priv_iter))
    results: Dict[Any, SimLogs] = {}
    if policy_mode == "mixture" and len(policies) > 1:
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
            _count_trace(_engine_key(cfg_variant(pol, comp, alg, priv),
                                     wcfgs[0], loss_fn, has_eval, "sweep"),
                         (len(grid),) + shapes)
            results[result_key(pol, comp, alg, priv)] = run_grid(
                pol, comp, alg, priv)
    return results
