"""Where a call of the port's whole-tensor compression API spends its time,
on one card.

    python3 scripts/torch_profile_api.py [--calls 5]

For ``block_topk``, ``qsgd_quantize`` and ``sign_ef_compress`` on one
gradient of 2^18 and of 10^8 elements (float32, and bf16 at 10^8), after a
warm-up, ``--calls`` calls under ``torch.profiler`` (CPU + CUDA
activities) give per call: the host clock, the device's busy time, the
device time of the port's tile kernel alone, and the device time of
everything else (for ``qsgd_quantize``: the threefry draw of the dither and
the global norm). The operator tables go to ``chiprun_out/profile_api.txt``.
Needs CUDA; fails without it.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from repro_torch import random as trandom  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CASES = [(1 << 18, torch.float32), (10 ** 8, torch.float32),
         (10 ** 8, torch.bfloat16)]
PORT_KERNELS = ("topk_tiles_warp", "topk_tiles_staged", "qsgd_tiles_kernel",
                "sign_ef_tiles_warp")


def profile(fn, calls: int, table):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    table.append(events.table(sort_by="self_device_time_total",
                              row_limit=25))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device = sum(e.self_device_time_total for e in kernels) / calls
    port = sum(e.self_device_time_total for e in kernels
               if any(k in e.key for k in PORT_KERNELS)) / calls
    launches = sum(e.count for e in kernels) / calls
    return wall / calls * 1e3, device / 1e3, port / 1e3, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_api: CUDA is not available")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    key = trandom.PRNGKey(7, dev)
    tables = []
    for n, dt in CASES:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(n, device=dev, generator=gen).to(dt)
        e = 0.1 * torch.randn(n, device=dev, generator=gen)
        calls = {"block_topk": lambda: ops.block_topk(x),
                 "qsgd_quantize": lambda: ops.qsgd_quantize(key, x),
                 "sign_ef_compress": lambda: ops.sign_ef_compress(x, e)}
        for name, fn in calls.items():
            tables.append(f"== {name} n={n} {dt}")
            host, device, port, launches = profile(fn, args.calls, tables)
            print(f"api {name} n={n} {str(dt).split('.')[-1]}: host "
                  f"{host:.4f} ms per call; device busy {device:.4f} ms "
                  f"({launches:.0f} launches), of which the port's kernel "
                  f"{port:.4f} ms and the rest {device - port:.4f} ms",
                  flush=True)
        del x, e
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_api.txt"),
              "w") as f:
        f.write("\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
