"""Quickstart: federated training of a small LM with the paper's full stack:
top-k sparsification + error feedback, age-based wireless scheduling,
FedAvg. The port of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

Needs a CUDA card; ``main(device="cpu")`` runs it on the CPU. At gemma-2b
``reduced()``'s D = 541 312 the twelve client rows go through the top-k
row kernel (``kernels/topk_mask.py::topk_rows``), once a round.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import random as trandom
from repro_torch.configs import get_config
from repro_torch.core.algorithms.registry import algo_params, flat_dim
from repro_torch.core.compression import compression_params
from repro_torch.data import (FederatedLoader, SyntheticLMDataset,
                              dirichlet_partition)
from repro_torch.fl import runtime as rt
from repro_torch.models import transformer as tf

N, SCHEDULED, ROUNDS = 12, 4, 30
SEQ, BATCH, LOCAL_STEPS = 32, 4, 2


def model(device):
    """gemma-2b ``reduced()`` (2 layers, d = 128): ``(cfg, params on
    device, loss_fn)``."""
    cfg = get_config("gemma-2b").reduced()

    def loss_fn(params, batch):
        return tf.lm_loss(params, cfg, batch, remat=False)

    return cfg, tf.init_params(cfg, trandom.PRNGKey(0, device)), loss_fn


def make_loader(vocab_size: int) -> FederatedLoader:
    """N clients of a Dirichlet(0.3) split of 2048 synthetic sequences;
    ``next_round()`` gives numpy ``(N, LOCAL_STEPS, BATCH, SEQ)`` batches."""
    ds = SyntheticLMDataset(vocab_size, seq_len=SEQ, n_sequences=2048)
    parts = dirichlet_partition(ds.class_of(np.arange(len(ds))), N,
                                alpha=0.3, min_per_client=8)
    return FederatedLoader(ds, parts, batch=BATCH, local_steps=LOCAL_STEPS)


def sim_config(cfg, rounds: int, **kw) -> rt.SimConfig:
    """What the quickstart and ``private_fl`` share: N devices, SCHEDULED
    of them by age a round, FedAvg at lr 2e-3, 32-bit model pricing;
    ``kw`` adds the compressor or the privacy mechanism."""
    return rt.SimConfig(n_devices=N, n_scheduled=SCHEDULED, rounds=rounds,
                        local_steps=LOCAL_STEPS,
                        algo_params=algo_params(lr=2e-3), policy="age",
                        model_bits=32.0 * cfg.param_count(), **kw)


def topk_config(cfg, d: int, rounds: int, **kw) -> rt.SimConfig:
    """The quickstart's cell: 2% top-k + EF, whose compressed bits price
    the uplink latency."""
    return sim_config(cfg, rounds, compression="topk",
                      compression_params=compression_params(
                          k=max(1, d // 50)), **kw)


def main(argv=None, device="cuda") -> list:
    """Print every fifth round and the last; return the ``RoundLog``s."""
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    dev = rt.resolve_device(device)
    cfg, params, loss_fn = model(dev)
    print(f"model: {cfg.name}  params~{cfg.param_count():,}")
    loader = make_loader(cfg.vocab_size)
    logs = rt.run_simulation(
        topk_config(cfg, flat_dim(params), ROUNDS), loss_fn, params,
        lambda t, n: loader.next_round(), device=dev)
    for lg in logs[::5] + [logs[-1]]:
        print(f"round {lg.round:3d}  wall-clock {lg.latency_s:8.1f}s  "
              f"(comm {lg.comm_s:6.1f}s)  loss {lg.loss:.4f}  "
              f"scheduled {lg.n_scheduled}  uplink {lg.uplink_bits:.2e}b")
    assert logs[-1].loss < logs[0].loss
    print("quickstart OK")
    return logs


if __name__ == "__main__":
    main()
