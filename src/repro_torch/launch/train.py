"""End-to-end training from the command line, the port of
``repro/launch/train.py``. Two scales:

* ``--cluster`` -- the pod-scale trainer (``launch/steps.py``) on a
  ``--mesh-data`` x ``--mesh-model`` mesh of members, one process each:
  PSSGD, local SGD or FSDP with a compressed all-reduce and EF;
* default -- the FL simulation scale: vmapped clients, wireless scheduling,
  compression + EF through the flat engine, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 20 --reduced --cluster
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m \
        repro_torch.launch.train --arch gemma-2b --steps 20 --reduced \
        --cluster --mesh-data 2 --compression int8
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --reduced --rounds 50 --policy age --compressor topk

A mesh of more than one member runs inside a process group of as many
members (``torchrun``, or a caller's group, ``launch/members.py``) and
raises outside one. Only rank 0 prints, and the checkpoint is gathered to
rank 0 in the reference's layout. ``--mesh-model`` above 1 splits the
blocks over the model axis (heads, MLP, vocabulary, the MoE expert
stacks, the mamba and RG-LRU channels). Trains all six families;
``--cluster`` feeds the vlm and audio families zero vision / audio
embeddings, as the reference does, and the federated path feeds none, so
it fails on them with the reference's ``KeyError``.
"""
from __future__ import annotations

import argparse
import time
import warnings

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.algorithms.registry import (algo_params,
                                                  algorithm_names, flat_dim,
                                                  from_server_name)
from repro_torch.core.compression.registry import (compression_params,
                                                   compressor_names)
from repro_torch.core.privacy import privacy_names, privacy_params
from repro_torch.data import (FederatedLoader, SyntheticLMDataset,
                              batch_iterator, dirichlet_partition)
from repro_torch.fl import runtime as fl_runtime
from repro_torch.launch.members import init_from_env, member_device
from repro_torch.launch.mesh import make_local_mesh, members_line
from repro_torch.launch.steps import (TrainPolicy, gather_params,
                                      make_init_fn, make_train_step)
from repro_torch.models import transformer as tf


def make_compression(name: str, d: int, k_frac: float = 0.01):
    """CLI name -> (registry name, CompressionParams) for the d-dim model."""
    return name, compression_params(k=max(1, int(k_frac * d)), levels=256)


def run_cluster(args, cfg=None, device="cuda"):
    """Train ``--arch`` (or ``cfg`` as given) for ``--steps`` steps of the
    pod-scale trainer on this member's block of the mesh, print the losses
    (rank 0), save the gathered params to ``--ckpt-dir`` if given (rank 0)
    and return (losses, this member's final state); the last loss must be
    below the first."""
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    init_from_env(device)
    mesh = make_local_mesh(args.mesh_data, args.mesh_model)
    dev = fl_runtime.resolve_device(member_device(device, mesh.rank))
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    if mesh.bound:
        say(f"members: {members_line(mesh)}; rank 0 on {dev}")
    ef = args.compression not in ("none", "bf16")
    policy = TrainPolicy(mode=args.mode, compression=args.compression,
                         error_feedback=ef, local_steps=args.local_steps,
                         lr=args.lr, optimizer=args.optimizer,
                         total_steps=args.steps, remat=not args.reduced)
    ds = SyntheticLMDataset(cfg.vocab_size, args.seq_len, 4096, seed=0)
    it = batch_iterator(ds, args.batch, seed=0)

    state = make_init_fn(cfg, policy, mesh)(trandom.PRNGKey(args.seed, dev))
    step_fn = make_train_step(cfg, policy, mesh)
    losses = []
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(it).items()}
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.zeros(
                (args.batch, cfg.n_vision_tokens, cfg.vision_dim),
                dtype=torch.float32, device=dev)
        if cfg.family == "audio":
            batch["audio_embeds"] = torch.zeros(
                (args.batch, cfg.n_audio_frames, cfg.d_model),
                dtype=torch.float32, device=dev)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % max(1, args.steps // 20) == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:.4f} "
                f"({time.time() - t0:.2f}s) [{policy.tag()}]")
    if args.ckpt_dir:
        params = (gather_params(cfg, policy, mesh, state["params"])
                  if mesh.bound else state["params"])
        if mesh.rank == 0:
            save_checkpoint(args.ckpt_dir, args.steps, params)
        del params
    assert losses[-1] < losses[0], "training did not reduce loss"
    say(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    return losses, state


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


def main(argv=None, device="cuda") -> None:
    args = parser().parse_args(argv)
    if args.cluster:
        run_cluster(args, device=device)
    else:
        run_federated(args, device=device)


if __name__ == "__main__":
    main()
