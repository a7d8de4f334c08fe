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

Not in this slice: sweeps, the host loop, the hierarchical engine and
gossip.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable, Dict, List, Optional, Tuple

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
    n_scheduled: int = 8
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
    """Stacked per-round logs, each with a leading ``(rounds,)`` axis.
    Without faults ``n_survived`` is ``n_scheduled`` and ``n_dropped``,
    ``retransmissions`` and ``staleness_mean`` are 0; without DP
    ``epsilon`` is +inf and ``delta`` 1.0; without masks ``mask_bits`` is
    0."""
    loss: np.ndarray
    latency_s: np.ndarray
    n_scheduled: np.ndarray
    participation: np.ndarray  # (rounds, n_devices) bool
    uplink_bits: np.ndarray
    comm_s: np.ndarray
    comp_s: np.ndarray
    downlink_bits: np.ndarray
    n_survived: np.ndarray
    n_dropped: np.ndarray
    retransmissions: np.ndarray
    staleness_mean: np.ndarray
    epsilon: np.ndarray        # cumulative, non-decreasing
    delta: np.ndarray
    mask_bits: np.ndarray

    def to_round_logs(self) -> List[RoundLog]:
        return [RoundLog(t, float(self.latency_s[t]), float(self.loss[t]),
                         int(self.n_scheduled[t]), self.participation[t],
                         float(self.uplink_bits[t]), float(self.comm_s[t]),
                         float(self.comp_s[t]), float(self.downlink_bits[t]),
                         int(self.n_survived[t]), int(self.n_dropped[t]),
                         float(self.retransmissions[t]),
                         float(self.staleness_mean[t]),
                         float(self.epsilon[t]), float(self.delta[t]),
                         float(self.mask_bits[t]))
                for t in range(self.loss.shape[0])]


# the SimLogs fields of one round, in the order the engine emits them
_LOG_FIELDS = ("loss", "latency_s", "participation", "n_scheduled",
               "uplink_bits", "comm_s", "comp_s", "downlink_bits",
               "n_survived", "n_dropped", "retransmissions", "staleness_mean",
               "epsilon", "delta", "mask_bits")


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
    n = cfg.n_devices
    pcfg = _policy_cfg(cfg, wcfg)
    policy_fn = scheduling.get_policy(cfg.policy)
    algo = algo_registry.get_algorithm(cfg.algorithm)
    comp_active = cfg.compression != "none"
    faults_on = cfg.faults is not None
    priv_on = cfg.privacy != "none"
    priv = privacy_lib.get_privacy(cfg.privacy) if priv_on else None
    dp_on = priv_on and priv.uses_dp
    # chunk >= N is the unchunked pass; EF rows pad to the chunk multiple
    chunk = (cfg.chunk_size
             if cfg.chunk_size is not None and cfg.chunk_size < n else None)
    n_rows = chunking.n_blocks(n, chunk) * chunk if chunk else n
    state_dt = (torch.bfloat16 if cfg.state_dtype == "bfloat16"
                else torch.float32)

    params = {k: v.clone() for k, v in _on(init_params, dev).items()}
    batches = _on(batches, dev)
    eval_batch = _on(eval_batch, dev)
    d_model = fl_server.flat_dim(params)
    chan = wireless.channel_params(wcfg, dev)
    cparams = (cfg.compression_params.to(dev)
               if cfg.compression_params is not None
               else compression.default_compression_params(d_model, dev))
    aparams = (cfg.algo_params.to(dev) if cfg.algo_params is not None
               else algo_registry.default_algo_params(dev))
    fparams = cfg.faults.to(dev) if faults_on else None
    pparams = ((cfg.privacy_params if cfg.privacy_params is not None
                else privacy_lib.default_privacy_params()).to(dev)
               if priv_on else None)
    round_fn = functools.partial(
        fl_server.fl_round, loss_fn=loss_fn, algo=algo, aparams=aparams,
        compression_name=(cfg.compression if comp_active else None),
        chunk_size=chunk, n_clients=n, privacy=priv)

    state = fl_server.init_fl_state(
        params, n, algo=algo, use_ef=comp_active,
        double_ef=comp_active and cfg.double_ef, ef_mode=cfg.ef_mode,
        ef_slots=cfg.ef_slots, state_dtype=state_dt, n_rows=n_rows)
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    clock = torch.zeros((), dtype=torch.float32, device=dev)
    ages, norms, avg_snr = zeros, torch.ones_like(zeros), zeros
    if faults_on:
        # churn availability (everyone starts online), the Gauss-Markov
        # fading state and per-client staleness
        avail = torch.ones(n, dtype=torch.bool, device=dev)
        fad = torch.zeros((n, 2), dtype=torch.float32, device=dev)
        stal = zeros
    if dp_on:  # the Renyi ledger, one slot per order in ALPHAS
        rdp = torch.zeros(len(privacy_lib.ALPHAS), dtype=torch.float32,
                          device=dev)

    k_pos, k_rounds = trandom.split(trandom.PRNGKey(cfg.seed, dev))
    dist = wireless.sample_positions_jax(k_pos, chan, n)
    payload_scale = cfg.model_bits / (32.0 * d_model)
    if comp_active:
        bits_dev = message_bits_jax(cfg.compression, cparams, cfg.model_bits,
                                    d_model) * algo.uplink_factor
        dl_bits = (payload_scale * compression.uplink_bits_jax(
            cfg.compression, cparams, d_model) if cfg.double_ef
            else torch.tensor(float(cfg.model_bits), device=dev))
    else:
        bits_dev = torch.tensor(cfg.model_bits * algo.uplink_factor,
                                dtype=torch.float32, device=dev)
        dl_bits = torch.tensor(float(cfg.model_bits), device=dev)
    neg_inf = torch.tensor(-torch.inf, device=dev)
    zero = torch.zeros((), device=dev)
    mask_over = zero
    if priv_on:
        # field modes send dense field_bits a coordinate (a masked message
        # is incompressible); the pairwise key agreement adds raw bits
        if priv.uses_field:
            bits_dev = payload_scale * privacy_lib.uplink_bits_jax(
                cfg.privacy, pparams, d_model, 0.0) * algo.uplink_factor
        if priv.uses_masks:
            mask_over = privacy_lib.mask_bits_jax(cfg.privacy, n - 1, dev)
            bits_dev = bits_dev + mask_over
    no_dp = (torch.tensor(torch.inf, device=dev),
             torch.tensor(1.0, device=dev))
    dp_delta = torch.tensor(privacy_lib.DELTA, dtype=torch.float32,
                            device=dev)

    outs = []
    for t in range(cfg.rounds):
        kt = trandom.fold_in(k_rounds, t)
        kf, kc, kp, kn, kz = trandom.split(kt, 5)
        if cfg.datagen is not None:
            round_batches = functools.partial(
                cfg.datagen, trandom.fold_in(kt, DATAGEN_FOLD))
        else:
            round_batches = {k: v[t] for k, v in batches.items()}

        if faults_on:
            # correlated fading replaces the i.i.d. draw
            fad, fading = faults_lib.gauss_markov_fading(fparams, kt, fad, t)
        else:
            fading = wireless.sample_fading_jax(kf, n)
        snr_lin = wireless.snr_jax(dist, fading, chan)
        rates = wireless.shannon_rate_jax(
            snr_lin, chan.bandwidth_hz / cfg.n_scheduled)
        comp_lat = cfg.comp_latency_s * trandom.exponential(kc, (n,))
        if faults_on:
            comp_lat = comp_lat * faults_lib.straggler_multiplier(
                fparams, kt, n)
        comm_lat = wireless.comm_latency_jax(bits_dev, rates)
        # per-device time-averaged SNR (PF's denominator), seeded with the
        # first observation
        avg_snr = snr_lin if t == 0 else 0.9 * avg_snr + 0.1 * snr_lin

        rstate = scheduling.RoundState(
            t=t, key=kp, snr_lin=snr_lin, avg_snr=avg_snr, rates=rates,
            comm_lat=comm_lat, comp_lat=comp_lat, ages=ages,
            update_norms=norms)
        if faults_on:
            # churn after pricing: offline devices are invisible to the
            # policy, and index-based policies are intersected with avail
            avail = faults_lib.churn_step(fparams, kt, avail)
            mask = policy_fn(
                pcfg, scheduling.masked_round_state(rstate, avail)) & avail
        else:
            mask = policy_fn(pcfg, rstate)
        # staleness before this round's resets: fedbuff's discount reads the
        # true per-client staleness under faults, else the scheduling age
        stal_pre = stal if faults_on else ages
        ages = scheduling.update_ages_jax(ages, mask)

        if faults_on:
            # dropout, then decode failure with up to max_retries re-priced
            # retransmissions, each on a fresh channel draw
            dropped = faults_lib.dropout_draw(fparams, kt, n) & mask
            ok = snr_lin >= fparams.snr_min
            comm_eff = comm_lat
            n_retx = zeros
            for r in range(1, cfg.max_retries + 1):
                snr_r = wireless.snr_jax(
                    dist, faults_lib.retry_fading(kt, r, n), chan)
                lat_r = wireless.comm_latency_jax(
                    bits_dev, wireless.shannon_rate_jax(
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
        sw = (faults_lib.staleness_weights(aparams, stal_pre)
              if algo.uses_staleness else None)
        kw = dict(participation=part, staleness_weights=sw)
        if faults_on:
            kw.update(gate_ef=True, guard_empty=True)
        if priv_on:
            kw.update(pparams=pparams,
                      privacy_key=trandom.fold_in(kt,
                                                  privacy_lib.PRIVACY_FOLD))
        if comp_active:
            state, metrics = round_fn(state, round_batches, cparams=cparams,
                                      key=kz, **kw)
            ubits = payload_scale * metrics["uplink_bits"]
            if priv_on and priv.uses_masks:
                # key agreement for every scheduled client (it precedes the
                # transmission that may fail)
                ubits = _fma(mask_over, mask.sum(), ubits)
            if faults_on:
                # undecoded attempts' airtime: the retries, plus the final
                # failed payload of clients never decoded
                ubits = _fma(bits_dev, torch.where(
                    sent, n_retx + (~ok).to(torch.float32), 0.0).sum(),
                    ubits)
        else:
            state, metrics = round_fn(state, round_batches, **kw)
            ubits = (bits_dev * torch.where(sent, 1.0 + n_retx, 0.0).sum()
                     if faults_on else bits_dev * mask.sum())

        # downlink: the broadcast opens the round at BS power over the full
        # band with its own fading; the slowest scheduled device gates it
        dl_rate = wireless.shannon_rate_jax(
            wireless.downlink_snr_jax(
                dist, faults_lib.downlink_fading(kt, n), chan),
            chan.bandwidth_hz)
        dl_lat = wireless.comm_latency_jax(dl_bits, dl_rate)
        any_sched = mask.any()
        dl_s = torch.where(mask, dl_lat, zero).amax()
        dl_bits_out = torch.where(any_sched, dl_bits, zero)

        # wall clock: synchronous round = slowest scheduled device; a
        # dropped client stops consuming the round, a decode-failed one
        # still burns its airtime
        if faults_on:
            comm_c = torch.where(dropped, 0.0, comm_eff)
            comp_c = torch.where(dropped, 0.0, comp_lat)
        else:
            comm_c, comp_c = comm_lat, comp_lat
        total = comm_c + comp_c
        slowest = torch.argmax(torch.where(mask, total, neg_inf))
        comm_s = torch.where(any_sched, comm_c[slowest], zero)
        comp_s = torch.where(any_sched, comp_c[slowest], zero)
        clock = clock + dl_s + comm_s + comp_s

        if faults_on:
            fault_log = (survived.sum(), (mask & ~survived).sum(),
                         torch.where(sent, n_retx, 0.0).sum(),
                         stal_pre.mean())
            stal = torch.where(survived, 0.0, stal + 1.0)
        else:
            fault_log = (mask.sum(), torch.zeros_like(mask.sum()), zero,
                         zero)
        if dp_on:
            # one subsampled-Gaussian round at sampling fraction
            # survivors / N; local field noise aggregates to an effective
            # multiplier sigma * sqrt(survivors)
            n_surv_f = part.sum()
            z_eff = (pparams.sigma * torch.sqrt(torch.clamp_min(n_surv_f,
                                                                1.0))
                     if priv.dp_local else pparams.sigma)
            rdp = rdp + privacy_lib.rdp_increment(n_surv_f / n, z_eff)
            dp_log = (privacy_lib.epsilon_of(rdp), dp_delta)
        else:
            dp_log = no_dp

        loss = metrics["loss"]
        if eval_batch is not None:
            loss = loss_fn(state.params, eval_batch)[0]
        # update-aware policies observe last-round delta norms (proxy)
        norms = 0.9 * norms + 0.1 * trandom.exponential(kn, (n,))
        outs.append((loss, clock, mask, mask.sum(), ubits, comm_s, comp_s,
                     dl_bits_out) + fault_log + dp_log
                    + (mask_over * mask.sum(),))

    cols = [torch.stack(c).cpu().numpy() for c in zip(*outs)]
    return state.params, SimLogs(**dict(zip(_LOG_FIELDS, cols)))


def run_simulation(cfg: SimConfig, loss_fn, init_params: Params,
                   sample_client_batches: Callable[[int, int], Dict],
                   eval_fn: Optional[Callable] = None,
                   wcfg: Optional[wireless.WirelessConfig] = None,
                   engine: Optional[str] = None,
                   device="cuda") -> List[RoundLog]:
    """Per-round ``RoundLog`` entry point over :func:`run_simulation_scan`.

    ``engine`` may be ``None`` or ``"scan"``. An ``eval_fn`` must carry an
    ``eval_batch`` attribute (the logged loss becomes ``loss_fn(params,
    eval_batch)``); the reference's host loop for opaque ``eval_fn``s is not
    ported.
    """
    if engine not in (None, "scan"):
        raise NotImplementedError(f"engine={engine!r}: only the scan engine "
                                  "is ported to PyTorch")
    if cfg.rounds == 0:
        return []
    eval_batch = getattr(eval_fn, "eval_batch", None) if eval_fn else None
    if eval_fn is not None and eval_batch is None:
        raise NotImplementedError(
            "an eval_fn without an eval_batch attribute needs the host loop, "
            "which is not ported to PyTorch")
    batches = (None if cfg.datagen is not None else
               stack_batches(sample_client_batches, cfg.rounds,
                             cfg.n_devices))
    _, logs = run_simulation_scan(cfg, loss_fn, init_params, batches,
                                  eval_batch=eval_batch, wcfg=wcfg,
                                  device=device)
    return logs.to_round_logs()
