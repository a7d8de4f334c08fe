"""Train a ~100M-param llama-style model with the pod-scale PSSGD step on
one card: int8-quantized gradient all-reduce with error feedback (the
paper's section II.B applied to the collective), the port of
``examples/train_fl_100m.py``.

By default a scaled-down model; ``--full-100m`` builds the ~100M config.

    PYTHONPATH=src python -m repro_torch.examples.train_fl_100m --steps 300
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLMDataset
from repro_torch.fl.runtime import resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import (TrainPolicy, make_init_fn,
                                      make_train_step)


def model_100m(full: bool) -> ModelConfig:
    if full:  # ~100M params
        return ModelConfig(
            name="fl-100m", family="dense", source="examples", n_layers=12,
            d_model=768, n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32_000, dtype="float32")
    return ModelConfig(
        name="fl-100m-mini", family="dense", source="examples", n_layers=4,
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=1024,
        vocab_size=2_000, dtype="float32")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--compression", default="int8",
                    choices=["none", "bf16", "int8", "sign"])
    return ap


def train(args, device="cuda") -> list:
    """Print the model, the losses and tokens/s; return the losses."""
    cfg = model_100m(args.full_100m)
    n_params = cfg.param_count()
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params; "
          f"compression={args.compression}+EF")

    dev = resolve_device(device)
    mesh = make_local_mesh(1, 1)
    ef = args.compression not in ("none", "bf16")
    policy = TrainPolicy(mode="pssgd", compression=args.compression,
                         error_feedback=ef,
                         lr=3e-4 if args.full_100m else 3e-3,
                         optimizer="adamw", total_steps=args.steps,
                         remat=args.full_100m)
    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, 8192, seed=0)
    rng = np.random.default_rng(0)

    state = make_init_fn(cfg, policy, mesh)(trandom.PRNGKey(0, dev))
    step_fn = make_train_step(cfg, policy, mesh)
    t_start = time.time()
    losses = []
    for step in range(args.steps):
        idx = rng.integers(0, len(ds), args.batch)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in ds.get(idx).items()}
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        if step % max(1, args.steps // 15) == 0 or step == args.steps - 1:
            toks = args.batch * args.seq * (step + 1)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"{toks / max(time.time() - t_start, 1e-9):,.0f} tok/s")
    return losses


def main(argv=None, device="cuda") -> None:
    args = parser().parse_args(argv)
    losses = train(args, device)
    first, loss = losses[0], losses[-1]
    assert loss < first - 0.3, (first, loss)
    print(f"done: loss {first:.3f} -> {loss:.3f} over {args.steps} steps")


if __name__ == "__main__":
    main()
