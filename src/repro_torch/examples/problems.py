"""The small learnable LM problem that the walk-through examples share: the
port of ``benchmarks/common.py::make_lm_problem``.

A synthetic order-1 Markov token source (4 classes, branching 2) split
over clients by a Dirichlet(alpha) partition, and an embedding -> ReLU MLP
-> logits model trained with cross-entropy. The chapter's experiments train
CNNs on MNIST/CIFAR-10; this task keeps their optimization structure
(non-iid clients, an NN model, SGD) at a size that runs anywhere.

Where the tensors live: the params and the eval batch are on the caller's
device; ``sample_batches`` returns numpy arrays, as
``data.FederatedLoader.next_round`` does, and the engines move them to
their own device.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.data import SyntheticLMDataset, dirichlet_partition
from repro_torch.fl.runtime import resolve_device

VOCAB, SEQ, DHID = 64, 16, 32
D = VOCAB * DHID + DHID * DHID + DHID * VOCAB  # the model's 5120 weights


def lm_loss(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
    """Mean cross-entropy of the next token: ``logsumexp`` minus gold."""
    h = torch.relu(p["emb"][batch["tokens"].long()] @ p["w1"])
    logits = h @ p["w2"]
    gold = torch.gather(logits, -1, batch["labels"][..., None].long())[..., 0]
    return (torch.logsumexp(logits, -1) - gold).mean(), {}


def make_lm_problem(n_clients: int, alpha: float = 0.3, seed: int = 0, *,
                    device="cuda") -> Tuple[Dict[str, torch.Tensor], Callable,
                                            Callable, Callable]:
    """``(params, loss_fn, sample_batches, eval_fn)`` for ``n_clients``.

    The weights are threefry ``normal`` draws on ``PRNGKey(seed)`` split
    three ways, made on the CPU (so bitwise the reference's on any device)
    and moved to ``device``. ``sample_batches(t, n, h=2, b=16)`` draws the
    first ``n`` clients' ``(n, h, b, SEQ)`` tokens and labels from one
    ``np.random.default_rng(seed)`` that lives as long as the problem: it
    ignores ``t``, so every call moves the stream on. ``eval_fn(p)`` is the
    loss on the first 256 sequences; it carries them as ``eval_batch``, so
    the engines evaluate them in their own loop.
    """
    dev = resolve_device(device)
    ds = SyntheticLMDataset(VOCAB, SEQ, 2048, n_classes=4, seed=seed,
                            branching=2)
    parts = dirichlet_partition(ds.class_of(np.arange(len(ds))), n_clients,
                                alpha=alpha, seed=seed, min_per_client=16)
    k1, k2, k3 = trandom.split(trandom.PRNGKey(seed), 3)
    params = {"emb": trandom.normal(k1, (VOCAB, DHID)) * 0.1,
              "w1": trandom.normal(k2, (DHID, DHID)) * DHID ** -0.5,
              "w2": trandom.normal(k3, (DHID, VOCAB)) * DHID ** -0.5}
    params = {k: v.to(dev) for k, v in params.items()}
    rng = np.random.default_rng(seed)

    def sample_batches(t: int, n: int, h: int = 2, b: int = 16
                       ) -> Dict[str, np.ndarray]:
        outs = {"tokens": [], "labels": []}
        for ci in parts[:n]:
            got = ds.get(rng.choice(ci, size=(h, b)).reshape(-1))
            for k in outs:
                outs[k].append(got[k].reshape(h, b, -1))
        return {k: np.stack(v) for k, v in outs.items()}

    eval_batch = {k: torch.tensor(v, device=dev)
                  for k, v in ds.get(np.arange(256)).items()}

    def eval_fn(p) -> float:
        return float(lm_loss(p, eval_batch)[0])

    eval_fn.eval_batch = eval_batch
    return params, lm_loss, sample_batches, eval_fn
