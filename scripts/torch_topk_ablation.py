"""Where the time of the engine's top-k row kernel goes, on one card.

    python3 scripts/torch_topk_ablation.py [--rounds 5] [--tree NAME=CSRC ...]

Builds three versions of ``csrc/rows.cu`` with nvcc (one process each, in
parallel, under ``build/topk_ablation/``) and times ``topk_rows`` beside
``sign_ef_rows`` at the engine's block (4096, 32), k = 1, each alone on the
device (a CUDA graph of 200 launches, replayed 5 times), in turns:

* ``built``: the sources as they are (warp 0 replays the block's rows);
* ``every_lane``: each warp replays its own row on all 32 lanes;
* ``no_replay``: the replay skipped (lo = hi), for timing only;
* one more per ``--tree NAME=CSRC``: the ``rows.cu`` and ``warp_rows.cuh``
  of another checkout's ``src/repro_torch/kernels/csrc`` as they are (for
  example an earlier commit unpacked with ``git archive``), timed by the
  same graphs in the same turns.

Each round prints both times and their ratio; the last lines give each
version's median over the rounds.

Needs CUDA and nvcc; fails without them.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "topk_ablation")

import torch  # noqa: E402

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-Xcompiler", "-fPIC", "-shared"]
EVERY_LANE = ('''  float v[VPT];
  if (live) {''', '''  if (live)
    topk_warp_row<VPT>(x + base, out + base, d, d, k, lane, cand[warp]);
  return;
  float v[VPT];
  if (live) {''')
NO_REPLAY = ('''  if (tkey == kLoReady) return hi;''', '''  return hi;''')
VARIANTS = {"built": [], "every_lane": [("rows.cu", *EVERY_LANE)],
            "no_replay": [("warp_rows.cuh", *NO_REPLAY)]}


def build(name: str, patches, csrc: str = CSRC) -> subprocess.Popen:
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f in ("rows.cu", "warp_rows.cuh"):
        src = open(os.path.join(csrc, f)).read()
        for target, old, new in patches:
            if target == f:
                if old not in src:
                    raise SystemExit(f"{name}: {f} no longer holds the "
                                     "patched text")
                src = src.replace(old, new)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(src)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return subprocess.Popen(
        [nvcc, *FLAGS, "-o", os.path.join(d, "lib.so"),
         os.path.join(d, "rows.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def graph_us(fn, reps: int = 200) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=CSRC",
                    help="also time the kernels of another csrc directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_topk_ablation: CUDA is not available")
    procs = {name: build(name, p) for name, p in VARIANTS.items()}
    for spec in args.tree:
        name, _, csrc = spec.partition("=")
        if name in procs or not os.path.isdir(csrc):
            raise SystemExit(f"--tree {spec}: need a new name and a "
                             "directory")
        procs[name] = build(name, [], csrc)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_rows_launch.argtypes = (p, p, i, i, p, p)
        lib.sign_ef_rows_launch.argtypes = (p, p, p, p, i, i, p)
        libs[name] = lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4096, 32, device=dev, generator=gen)
    e = 0.1 * torch.randn(4096, 32, device=dev, generator=gen)
    k = torch.tensor([1.0], device=dev)
    out, c, e2 = (torch.empty_like(x) for _ in range(3))
    times = {name: ([], [], []) for name in libs}
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            def topk(lib=lib):
                lib.topk_rows_launch(x.data_ptr(), out.data_ptr(), 4096, 32,
                                     k.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)

            def sign_ef(lib=lib):
                lib.sign_ef_rows_launch(
                    x.data_ptr(), e.data_ptr(), c.data_ptr(), e2.data_ptr(),
                    4096, 32, torch.cuda.current_stream().cuda_stream)
            t_us, s_us = graph_us(topk), graph_us(sign_ef)
            for acc, v in zip(times[name], (t_us, s_us, t_us / s_us)):
                acc.append(v)
            print(f"round {rnd} {name}: topk_rows {t_us:.3f} us, "
                  f"sign_ef_rows {s_us:.3f} us, ratio {t_us / s_us:.3f}",
                  flush=True)
    for name, (t, s, r) in times.items():
        print(f"median {name}: topk_rows {statistics.median(t):.3f} us, "
              f"sign_ef_rows {statistics.median(s):.3f} us, ratio "
              f"{statistics.median(r):.3f} (ratios {min(r):.3f}-"
              f"{max(r):.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
