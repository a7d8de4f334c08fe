"""Federated data partitioning: iid shards and Dirichlet non-iid splits, the
port's copy of ``repro/data/partition.py`` (numpy only)."""
from __future__ import annotations

from typing import List

import numpy as np


def shard_partition(n_samples: int, n_clients: int, seed: int = 0
                    ) -> List[np.ndarray]:
    """IID: random equal shards."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_samples)
    return [np.sort(s) for s in np.array_split(perm, n_clients)]


def dirichlet_partition(class_labels: np.ndarray, n_clients: int,
                        alpha: float = 0.3, seed: int = 0,
                        min_per_client: int = 1) -> List[np.ndarray]:
    """Non-iid: per-class Dirichlet(alpha) proportions across clients
    (standard FL benchmark protocol)."""
    rng = np.random.default_rng(seed)
    n_classes = int(class_labels.max()) + 1
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.nonzero(class_labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for client, part in enumerate(np.split(idx, cuts)):
            client_idx[client].extend(part.tolist())
    # guarantee everyone has at least min_per_client samples
    for i in range(n_clients):
        while len(client_idx[i]) < min_per_client:
            donor = int(np.argmax([len(ci) for ci in client_idx]))
            client_idx[i].append(client_idx[donor].pop())
    return [np.sort(np.asarray(ci)) for ci in client_idx]
