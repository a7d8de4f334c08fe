"""Federated training from the command line: the FL simulation scale of
``repro/launch/train.py`` (vmapped clients, wireless scheduling,
compression + EF) on one CUDA device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --reduced --rounds 50 --policy age --compressor topk

Trains the dense, moe, ssm and hybrid families. ``--cluster`` (the
reference's pod-scale pjit path, and the only one that feeds the vlm and
audio families their embeddings) belongs to the trainer and is not ported
yet (ROADMAP queue A item 10).
"""
from __future__ import annotations

import argparse
import warnings

import numpy as np

from repro_torch import random as trandom
from repro_torch.configs import get_config
from repro_torch.core.algorithms.registry import (algo_params,
                                                  algorithm_names, flat_dim,
                                                  from_server_name)
from repro_torch.core.compression.registry import (compression_params,
                                                   compressor_names)
from repro_torch.core.privacy import privacy_names, privacy_params
from repro_torch.data import (FederatedLoader, SyntheticLMDataset,
                              dirichlet_partition)
from repro_torch.fl import runtime as fl_runtime
from repro_torch.models import transformer as tf


def make_compression(name: str, d: int, k_frac: float = 0.01):
    """CLI name -> (registry name, CompressionParams) for the d-dim model."""
    return name, compression_params(k=max(1, int(k_frac * d)), levels=256)


def federated_problem(args, cfg=None, device="cuda"):
    """``run_federated``'s pieces: the config (``--arch``, ``--reduced``;
    or ``cfg`` as given), the loss, the params on ``device``, the loader
    and the ``SimConfig``. Returns (cfg, sim, loss_fn, params, loader)."""
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    ds = SyntheticLMDataset(cfg.vocab_size, args.seq_len, 8192, seed=0)
    parts = dirichlet_partition(ds.labels_cls, args.n_devices,
                                alpha=args.dirichlet_alpha, seed=0,
                                min_per_client=args.batch)
    loader = FederatedLoader(ds, parts, args.batch, args.local_steps, seed=0)

    def loss_fn(params, batch):
        return tf.lm_loss(params, cfg, batch, remat=False)

    params = tf.init_params(cfg, trandom.PRNGKey(
        args.seed, fl_runtime.resolve_device(device)))
    d = flat_dim(params)
    comp_name, cparams = make_compression(args.compressor, d)
    algorithm = args.algorithm
    if args.server is not None:
        algorithm = from_server_name(args.server)
        warnings.warn(f"--server is deprecated; use --algorithm {algorithm}",
                      DeprecationWarning, stacklevel=2)
    aparams = algo_params(lr=args.lr, momentum=args.momentum,
                          prox_mu=args.prox_mu, server_lr=args.server_lr,
                          slowmo_beta=args.slowmo_beta)
    sim = fl_runtime.SimConfig(
        n_devices=args.n_devices, n_scheduled=args.n_scheduled,
        rounds=args.rounds, local_steps=args.local_steps,
        algorithm=algorithm, algo_params=aparams,
        policy=args.policy,
        compression=comp_name, compression_params=cparams,
        privacy=args.privacy,
        privacy_params=privacy_params(clip=args.dp_clip, sigma=args.dp_sigma,
                                      field_bits=args.field_bits),
        model_bits=32.0 * d)
    return cfg, sim, loss_fn, params, loader


def run_federated(args, device="cuda"):
    """Train ``--arch`` federated for ``--rounds`` rounds, print the logs
    and return them; the final loss must be below the first."""
    cfg, sim, loss_fn, params, loader = federated_problem(args,
                                                          device=device)
    # engine="host" keeps the seed's O(1)-per-round batch memory: the scan
    # engine would stack all rounds' token batches first
    logs = fl_runtime.run_simulation(
        sim, loss_fn, params, lambda t, n: loader.next_round(),
        engine=args.engine, device=device)
    for lg in logs[:: max(1, len(logs) // 20)]:
        eps = (f" eps={lg.epsilon:.2f}" if args.privacy != "none"
               and np.isfinite(lg.epsilon) else "")
        print(f"round {lg.round:4d} t={lg.latency_s:9.1f}s loss={lg.loss:.4f} "
              f"sched={lg.n_scheduled}{eps}")
    print(f"final loss {logs[-1].loss:.4f}")
    # DP noise at CLI-chosen sigma can legitimately dominate a short run
    if args.dp_sigma == 0.0 or args.privacy in ("none", "secagg"):
        assert logs[-1].loss < logs[0].loss
    return logs


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--cluster", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    # cluster args
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mode", default="pssgd",
                    choices=["pssgd", "localsgd", "fsdp"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8", "sign"])
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    # federated args
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--engine", default="host", choices=["scan", "host"],
                    help="simulation engine: 'scan' stacks all rounds' "
                         "batches on device first (O(rounds) memory); "
                         "'host' (default) samples round by round")
    ap.add_argument("--n-devices", type=int, default=16)
    ap.add_argument("--n-scheduled", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--policy", default="random")
    ap.add_argument("--algorithm", default="fedavg",
                    choices=sorted(algorithm_names()),
                    help="optimization algorithm (core.algorithms registry)")
    ap.add_argument("--server", default=None,
                    choices=["avg", "slowmo", "adam", "yogi"],
                    help="deprecated: use --algorithm")
    ap.add_argument("--server-lr", type=float, default=1.0)
    ap.add_argument("--slowmo-beta", type=float, default=0.5)
    ap.add_argument("--prox-mu", type=float, default=0.01)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--compressor", default="none",
                    choices=sorted(compressor_names()),
                    help="uplink compression (registry name; compressed "
                         "bits-on-the-wire drive the simulated latency)")
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5)
    ap.add_argument("--privacy", default="none",
                    choices=sorted(privacy_names()),
                    help="privacy mechanism (core.privacy registry): secure "
                         "aggregation masks and/or DP clip+noise")
    ap.add_argument("--dp-clip", type=float, default=1.0,
                    help="per-client L2 clip (DP sensitivity bound)")
    ap.add_argument("--dp-sigma", type=float, default=0.0,
                    help="Gaussian noise multiplier (0 = clip only)")
    ap.add_argument("--field-bits", type=float, default=20.0,
                    help="fixed-point bits per coordinate for the secagg "
                         "finite-field encoding")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.cluster:
        raise NotImplementedError(
            "--cluster is the pod-scale trainer (launch/steps.py, optim/, "
            "checkpoint/), not ported yet: ROADMAP queue A item 10")
    run_federated(args)


if __name__ == "__main__":
    main()
