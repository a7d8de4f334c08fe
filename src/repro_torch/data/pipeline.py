"""Batch iteration for central training and stacked-client FL rounds, the
port's copy of ``repro/data/pipeline.py`` (numpy only): the same index
streams from ``np.random.default_rng(seed)``."""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from repro_torch.data.synthetic import SyntheticLMDataset


def batch_iterator(ds: SyntheticLMDataset, batch: int, seed: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, len(ds), size=batch)
        yield ds.get(idx)


class FederatedLoader:
    """Produces stacked (N, H, B, S) client batches for fl_round."""

    def __init__(self, ds: SyntheticLMDataset, client_indices: List[np.ndarray],
                 batch: int, local_steps: int, seed: int = 0):
        self.ds = ds
        self.client_indices = client_indices
        self.batch = batch
        self.h = local_steps
        self.rng = np.random.default_rng(seed)

    @property
    def n_clients(self) -> int:
        return len(self.client_indices)

    def next_round(self) -> Dict[str, np.ndarray]:
        outs: Dict[str, List[np.ndarray]] = {}
        for ci in self.client_indices:
            idx = self.rng.choice(ci, size=(self.h, self.batch), replace=True)
            b = self.ds.get(idx.reshape(-1))
            for k, v in b.items():
                outs.setdefault(k, []).append(
                    v.reshape(self.h, self.batch, *v.shape[1:]))
        return {k: np.stack(v) for k, v in outs.items()}
