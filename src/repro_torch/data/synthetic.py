"""Synthetic language-model data with learnable structure, the port's copy
of ``repro/data/synthetic.py`` (numpy only).

A order-1 Markov token source with per-class transition matrices: clients can
be made non-iid by skewing class proportions (see partition.py). Losses on
this source drop well below the uniform log V floor once the model learns the
transitions, which is what the convergence tests assert.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class SyntheticLMDataset:
    def __init__(self, vocab_size: int, seq_len: int, n_sequences: int,
                 n_classes: int = 10, seed: int = 0, branching: int = 4):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.n_classes = n_classes
        rng = np.random.default_rng(seed)
        # sparse-support Markov transitions per class
        self.next_tokens = rng.integers(
            0, vocab_size, size=(n_classes, vocab_size, branching))
        self.labels_cls = rng.integers(0, n_classes, size=n_sequences)
        self.tokens = np.empty((n_sequences, seq_len + 1), dtype=np.int32)
        state = rng.integers(0, vocab_size, size=n_sequences)
        for t in range(seq_len + 1):
            self.tokens[:, t] = state
            choice = rng.integers(0, branching, size=n_sequences)
            state = self.next_tokens[self.labels_cls, state, choice]

    def __len__(self) -> int:
        return self.tokens.shape[0]

    def get(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        toks = self.tokens[idx]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def class_of(self, idx: np.ndarray) -> np.ndarray:
        return self.labels_cls[idx]
