"""PyTorch ops a sweep variant-round issues, counted by ``torch.profiler``.

    PYTHONPATH=src python3 scripts/torch_sweep_ops.py [--device cpu]

Runs ``benchmarks/bench_sweep.py``'s cell (N = 16, 4 scheduled, top-k,
linear d = 32, H = 2, B = 8) through ``run_sweep`` with one policy for a
few rounds, and prints the aten ops a variant-round, the threefry passes a
variant-round and the aten ops of one pass. A count, not a time: on the
card each op is at least one kernel launch.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import random as trandom  # noqa: E402
from repro_torch.fl import runtime as rt  # noqa: E402

N, D, H, B, ROUNDS = 16, 32, 2, 8, 4


def _aten(prof) -> int:
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    w_star = trandom.normal(trandom.PRNGKey(42), (D,)).numpy()

    def make_batches(t, n):
        rng = np.random.default_rng(t)
        x = rng.normal(size=(n, H, B, D)).astype(np.float32)
        y = x @ w_star + 0.01 * rng.normal(size=(n, H, B))
        return {"x": x, "y": y.astype(np.float32)}

    def loss(p, b):
        return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}

    batches = rt.stack_batches(make_batches, ROUNDS, N)
    cfg = rt.SimConfig(n_devices=N, n_scheduled=4, rounds=ROUNDS,
                       compression="topk")

    def sweep():
        rt.run_sweep(cfg, loss, {"w": np.zeros(D, np.float32)}, batches,
                     seeds=[0], policies=["random"], device=args.device)

    sweep()  # warm-up
    passes = [0]
    threefry = trandom.threefry2x32

    def counted(*a):
        passes[0] += 1
        return threefry(*a)
    trandom.threefry2x32 = counted
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sweep()
    trandom.threefry2x32 = threefry
    key = trandom.PRNGKey(0, args.device)
    with profile(activities=[ProfilerActivity.CPU]) as one:
        trandom.split(key, 5)
    print(f"aten ops a variant-round: {_aten(prof) / ROUNDS:.2f}; threefry "
          f"passes a variant-round: {passes[0] / ROUNDS:.2f}; aten ops of "
          f"one split (one threefry pass): {_aten(one)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
