"""Where a step of the port's one-card trainer spends its time, on one card.

    python3 scripts/torch_profile_trainer.py [--model gemma-2b|fl-100m]
        [--warm 2] [--steps 2]

Builds the trainer of ``chip_smoke.py`` phase 17: ``gemma-2b`` at its
published size in float32 (``run_cluster``'s policy: pssgd, int8 + EF,
adamw, lr 1e-3, remat, (8, 128) batches), or ``fl-100m``, the ~100M model
of ``python -m repro_torch.examples.train_fl_100m --full-100m`` (int8 +
EF, lr 3e-4, remat, (8, 128)). After ``--warm`` steps it profiles
``--steps`` more (``torch.profiler``, CPU + CUDA activities) and prints the
host clock a step, the device's busy share, ``cudaLaunchKernel`` calls a
step, the device time of matrix products (kernels named gemm or sm90)
against the rest, and the operators with the most device and host time.
The full operator table goes to ``build/profile_trainer_<model>.txt``.
Needs CUDA; fails without it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from repro_torch import random as trandom  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset, batch_iterator  # noqa: E402
from repro_torch.examples import train_fl_100m  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.steps import (TrainPolicy, make_init_fn,  # noqa: E402
                                      make_train_step)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gemma-2b",
                    choices=["gemma-2b", "fl-100m"])
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_trainer: CUDA is not available")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if args.model == "gemma-2b":
        cfg = dataclasses.replace(get_config("gemma-2b"), dtype="float32")
        lr = 1e-3
    else:
        cfg, lr = train_fl_100m.model_100m(True), 3e-4
    total = args.warm + args.steps
    policy = TrainPolicy(mode="pssgd", compression="int8",
                         error_feedback=True, lr=lr, optimizer="adamw",
                         total_steps=total, remat=True)
    mesh = make_local_mesh()
    state = make_init_fn(cfg, policy, mesh)(trandom.PRNGKey(0, dev))
    step = make_train_step(cfg, policy, mesh)
    it = batch_iterator(SyntheticLMDataset(cfg.vocab_size, 128, 4096, seed=0),
                        8, seed=0)

    def batch():
        return {k: torch.as_tensor(v, device=dev) for k, v in next(it).items()}
    for _ in range(args.warm):
        state, m = step(state, batch())
        float(m["loss"])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state, batch())
            float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    mm_us = sum(e.self_device_time_total for e in kernels
                if "gemm" in e.key.lower() or "sm90" in e.key.lower())
    n = args.steps
    print(f"{cfg.name}, {policy.tag()}, (8, 128): host {wall / n * 1e3:.1f} "
          f"ms a step; device busy {device_us / 1e3 / n:.1f} ms a step = "
          f"{device_us / 1e6 / wall:.3f} of the wall clock; matrix products "
          f"{mm_us / 1e3 / n:.1f} ms a step ({mm_us / max(device_us, 1):.3f} "
          f"of the device time)", flush=True)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"cudaLaunchKernel: {launches / n:.0f} a step", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"device {e.self_device_time_total / 1e3 / n:9.2f} ms a step "
              f"x{e.count // n:<6d} {e.key[:90]}", flush=True)
    for e in sorted((e for e in events if e.device_type != DeviceType.CUDA),
                    key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"host   {e.self_cpu_time_total / 1e3 / n:9.2f} ms a step "
              f"x{e.count // n:<6d} {e.key[:90]}", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build",
                           f"profile_trainer_{args.model}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    print(f"losses finite: {bool(np.isfinite(float(m['loss'])))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
