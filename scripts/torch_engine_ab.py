"""Two checkouts' flat engines on one card, in turns: the headline fleet
configuration of ``chip_smoke.py`` phase 7 (N = 100000, d = 32, H = 2 steps
of batch 8, 4096-client blocks, on-device data, random scheduling of 256,
top-k), 6 rounds after a 1-round warm-up, each run in a process of its own.

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 scripts/torch_engine_ab.py --parent build/parent [--change .]

Runs parent, change, change, parent, ``--rounds`` times over; prints each
rate, both trees' rates sorted with their medians, and fails unless the
two trees log the same losses bit for bit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

ONE = r'''
import sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.core.algorithms import registry as algos
from repro_torch.data import make_linear_datagen
from repro_torch.fl import runtime as rt
from repro_torch.kernels import build
build.build()
build.lib()
torch.backends.cuda.matmul.allow_tf32 = False
w_star = np.random.default_rng(42).standard_normal(32).astype(np.float32)
datagen = make_linear_datagen(w_star, local_steps=2, batch=8)


def cfg(rounds):
    return rt.SimConfig(n_devices=100_000, n_scheduled=256, local_steps=2,
                        policy="random", chunk_size=4096, seed=0,
                        rounds=rounds, datagen=datagen, compression="topk",
                        algo_params=algos.algo_params(lr=0.05))


def loss(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}


params0 = {"w": np.zeros(32, np.float32)}
dev = torch.device("cuda", 0)
rt.run_simulation_scan(cfg(1), loss, params0, device=dev)
torch.cuda.synchronize()
t0 = time.perf_counter()
_, logs = rt.run_simulation_scan(cfg(6), loss, params0, device=dev)
torch.cuda.synchronize()
print("RATE", 6 / (time.perf_counter() - t0), logs.loss.tolist())
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", default=".")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    trees = {"parent": args.parent, "change": args.change}
    rates = {"parent": [], "change": []}
    losses = {}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            r = subprocess.run([sys.executable, "-c", ONE, trees[name]],
                               capture_output=True, text=True)
            line = [ln for ln in r.stdout.splitlines()
                    if ln.startswith("RATE")]
            if r.returncode or not line:
                print(f"{name}: failed\n{r.stdout[-2000:]}\n"
                      f"{r.stderr[-3000:]}")
                return 1
            _, rate, loss = line[0].split(" ", 2)
            rates[name].append(float(rate))
            losses.setdefault(name, loss)
            print(f"{name} {float(rate):.4f} rounds/s; loss {loss}",
                  flush=True)
    for name, v in rates.items():
        v = sorted(v)
        mid = len(v) // 2
        med = v[mid] if len(v) % 2 else (v[mid - 1] + v[mid]) / 2
        print(f"{name}: rates {[round(x, 4) for x in v]}, median "
              f"{med:.4f} rounds/s")
    if losses["parent"] != losses["change"]:
        print("the two trees log different losses")
        return 1
    print("both trees log the same losses, bit for bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
