"""Where a round of the port's fleet engine spends its time, on one card.

    python3 scripts/torch_profile_fleet.py [--compression topk] [--rounds 2]
        [--faults] [--privacy secagg]

Runs the headline fleet configuration (N = 100000 clients, linear model
d = 32, H = 2 local steps of batch 8, 4096-client blocks, on-device data,
random scheduling of 256), optionally with ``benchmarks/bench_faults.py``'s
faults (``max_retries=2``) and a privacy mechanism (clip 0.5, sigma 0.3, as
``benchmarks/bench_privacy.py``), and prints:

* the host clock per round and the device's busy share over the profiled
  rounds (``torch.profiler``, CPU + CUDA activities);
* the operators with the most device time and the most host time, and the
  device time per launch of the port's own kernels;
* the time of each piece of one round's work, one at a time, each ended by
  a synchronize: the data of one 4096-client block, the local SGD of that
  block, its compression, the policy over all clients, the channel draws.

The full operator table goes to ``chiprun_out/profile_fleet.txt``. Needs
CUDA; fails without it.
"""
from __future__ import annotations

import argparse
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
from repro_torch.core import chunking, faults, scheduling, wireless  # noqa: E402
from repro_torch.core.algorithms import registry as algos  # noqa: E402
from repro_torch.core.compression import registry as comp_lib  # noqa: E402
from repro_torch.core.privacy import privacy_params  # noqa: E402
from repro_torch.data import make_linear_datagen  # noqa: E402
from repro_torch.fl import runtime as rt  # noqa: E402

N, K, D, H, B, CHUNK = 100_000, 256, 32, 2, 8, 4096


def _loss(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}


def _timed(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def pieces(dev, compression: str, datagen) -> None:
    """One round's work, piece by piece (ms each, host clock, synced)."""
    key = trandom.PRNGKey(0, dev)
    ids = torch.arange(CHUNK, device=dev)
    batch = datagen(key, ids)
    params = {"w": torch.zeros(D, device=dev)}
    ap = algos.algo_params(lr=0.05, device=dev)
    fedavg = algos.get_algorithm("fedavg")
    sgd = torch.func.vmap(
        lambda b: fedavg.client_update(_loss, ap, params, b, None)[::2])
    rows = torch.randn(CHUNK, D, device=dev)
    keys = chunking.client_keys(key, ids)
    cp = comp_lib.default_compression_params(D, dev)
    rows_fn = comp_lib.rows_compressor(compression, N * D)
    pcfg = scheduling.PolicyConfig(n_devices=N, n_scheduled=K)
    zeros = torch.zeros(N, device=dev)
    st = scheduling.RoundState(0, key, zeros, zeros, zeros, zeros, zeros,
                               zeros, zeros)
    chan = wireless.channel_params(wireless.WirelessConfig(n_devices=N), dev)
    dist = wireless.sample_positions_jax(key, chan, N)
    blocks = -(-N // CHUNK)
    rows_ms = {
        "datagen, one block": _timed(lambda: datagen(key, ids)),
        "local SGD, one block": _timed(lambda: sgd(batch)),
        f"{compression} rows, one block": _timed(
            lambda: rows_fn(cp, keys, rows)),
        "client keys, one block": _timed(
            lambda: chunking.client_keys(key, ids)),
        "random policy, all clients": _timed(
            lambda: scheduling.get_policy("random")(pcfg, st)),
        "uplink + downlink channel draws": _timed(lambda: (
            wireless.snr_jax(dist, wireless.sample_fading_jax(key, N), chan),
            faults.downlink_fading(key, N),
            trandom.exponential(key, (N,)))),
    }
    for name, ms in rows_ms.items():
        per_round = ms * (blocks if "one block" in name else 1)
        print(f"piece {name}: {ms:.3f} ms; per round {per_round:.1f} ms",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compression", default="topk")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--privacy", default="none")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_fleet: CUDA is not available")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    w_star = np.random.default_rng(42).standard_normal(D).astype(np.float32)
    datagen = make_linear_datagen(w_star, local_steps=H, batch=B)

    extra = dict(privacy=args.privacy, privacy_params=privacy_params(
        clip=0.5, sigma=0.3))
    if args.faults:
        extra.update(max_retries=2, faults=faults.fault_params(
            drop_prob=0.2, churn_p_off=0.05, churn_p_on=0.5,
            straggler_prob=0.1, straggler_alpha=1.5, snr_min=1.0,
            fading_rho=0.5))
    what = (f"{args.compression}, privacy {args.privacy}"
            + (", faults" if args.faults else ""))

    def cfg(rounds):
        return rt.SimConfig(
            n_devices=N, n_scheduled=K, rounds=rounds, local_steps=H,
            policy="random", compression=args.compression, chunk_size=CHUNK,
            datagen=datagen, algo_params=algos.algo_params(lr=0.05), **extra)

    params0 = {"w": np.zeros(D, np.float32)}
    rt.run_simulation_scan(cfg(1), _loss, params0, device=dev)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rt.run_simulation_scan(cfg(args.rounds), _loss, params0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    print(f"profiled {args.rounds} rounds ({what}): host "
          f"{wall / args.rounds * 1e3:.1f} ms/round; device busy "
          f"{device_us / 1e3 / args.rounds:.1f} ms/round = "
          f"{device_us / 1e6 / wall:.3f} of the wall clock", flush=True)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"cudaLaunchKernel: {launches / args.rounds:.0f} a round",
          flush=True)
    by_dev = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    for e in by_dev:
        print(f"device {e.self_device_time_total / 1e3:9.2f} ms "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)
    by_cpu = sorted((e for e in events if e.device_type != DeviceType.CUDA),
                    key=lambda e: -e.self_cpu_time_total)[:12]
    for e in by_cpu:
        print(f"host   {e.self_cpu_time_total / 1e3:9.2f} ms "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)
    for e in kernels:  # the port's own CUDA kernels, device time only
        if any(n in e.key for n in ("topk_rows", "qsgd_rows", "sign_ef_rows")):
            print(f"port kernel {e.key[:60]}: {e.count} launches, "
                  f"{e.self_device_time_total / e.count:.2f} us each on the "
                  "device", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_fleet.txt"),
              "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    pieces(dev, args.compression, datagen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
