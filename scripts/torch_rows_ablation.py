"""The row kernels B1 (``sign_ef_rows``) and B3 (``qsgd_rows``) of this
checkout against another's, on one card.

    python3 scripts/torch_rows_ablation.py --parent DIR [--rounds 5]

``DIR`` is the root of another checkout, for example the parent commit
unpacked with ``git archive`` under the git-ignored ``build/``. Builds the
``csrc/rows.cu`` of both, and of this checkout with the values a thread of
its row groups set otherwise (``VARIANTS``: one, two or four at every d),
with nvcc (one process each, in parallel, under ``build/rows_ablation/``),
checks that they agree (B3 given the norms bit for bit, B1 to rtol 1e-5 /
atol 1e-6), then:

* device time, each call alone on the device (a CUDA graph of 200 launches,
  20 above 2^22 elements, replayed 5 times), at the shapes of
  ``chip_smoke.py``'s phase 3, the builds in turns (parent, this, the
  variants, then back): B1; B3 given the norms; and the engine's whole
  ``ops.qsgd_rows`` call, in this checkout one launch that computes the
  norms and in the parent the older form, ``clamp_min`` of ``levels``,
  ``vector_norm`` of the rows, then B3 given them;
* host time per call, the launch included (``--host`` runs of this script
  in turns, each importing one checkout's ``repro_torch``): the
  ``qsgd.qsgd_rows`` and ``sign_ef.sign_ef_rows`` wrappers, ``ops.qsgd_rows``
  and the pieces of a wrapper's host path.

Each round prints its times; the last lines give the medians and this
checkout's time over the other's. Needs CUDA and nvcc; fails without them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "rows_ablation")
ROWS_CU = os.path.join("src", "repro_torch", "kernels", "csrc", "rows.cu")

import torch  # noqa: E402

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-Xcompiler", "-fPIC", "-shared"]
SHAPES = [(4096, 32), (102400, 32), (256, 65536), (1000, 1000), (4096, 1024)]
HOST_CALLS = 3000
# builds of this checkout with the values a thread of its row groups
# (warp_rows.cuh::row_vals) set otherwise: one, two where d is even, four
# where d % 4 == 0
ROW_VALS = "  return cols % 4 == 0 && cols > 64 ? 4 : cols % 2 == 0 ? 2 : 1;"
VARIANTS = {
    "vals1": ("warp_rows.cuh", ROW_VALS, "  return 1;"),
    "vals2": ("warp_rows.cuh", ROW_VALS,
              "  return cols % 2 == 0 ? 2 : 1;"),
    "vals4": ("warp_rows.cuh", ROW_VALS,
              "  return cols % 4 == 0 ? 4 : cols % 2 == 0 ? 2 : 1;"),
}


def build(name: str, root: str, patch=None) -> subprocess.Popen:
    """nvcc of ``root``'s rows.cu, copied with its header into the build
    directory, one of them patched (file, old, new) where given."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    csrc = os.path.dirname(os.path.join(root, ROWS_CU))
    for f in ("rows.cu", "warp_rows.cuh"):
        with open(os.path.join(csrc, f)) as fh:
            src = fh.read()
        if patch and f == patch[0]:
            if patch[1] not in src:
                raise SystemExit(f"{name}: {f} no longer holds "
                                 f"{patch[1]!r}")
            src = src.replace(*patch[1:])
        with open(os.path.join(d, f), "w") as fh:
            fh.write(src)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return subprocess.Popen(
        [nvcc, *FLAGS, "-o", os.path.join(d, "lib.so"),
         os.path.join(d, "rows.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def graph_us(fn, reps: int) -> float:
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


def host_main(root: str) -> int:
    """Host microseconds per call of one checkout's wrappers, as JSON."""
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ops, qsgd, sign_ef
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4096, 32, device=dev, generator=gen)
    e = 0.1 * torch.randn(4096, 32, device=dev, generator=gen)
    u = torch.rand(4096, 32, device=dev, generator=gen)
    lv = torch.tensor(256.0, device=dev)
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)

    def device_ctx():
        with torch.cuda.device(dev):
            pass
    calls = {
        "qsgd.qsgd_rows (norms given)": lambda: qsgd.qsgd_rows(x, u, norms,
                                                               lv),
        "sign_ef.sign_ef_rows": lambda: sign_ef.sign_ef_rows(x, e),
        "ops.qsgd_rows": lambda: ops.qsgd_rows(x, u, lv),
        "piece: torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "piece: torch._C._cuda_getCurrentRawStream(0)":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "piece: with torch.cuda.device(dev)": device_ctx,
        "piece: torch.cuda.current_device()": torch.cuda.current_device,
        "piece: torch.empty_like(x)": lambda: torch.empty_like(x),
        "piece: torch.as_tensor(levels)":
            lambda: torch.as_tensor(lv, dtype=torch.float32, device=dev),
        "piece: build.check_operands(x, u, levels, norms)":
            lambda: kbuild.check_operands("qsgd_rows", x, u, lv, norms),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        out[name] = statistics.median(reps)
    print(json.dumps(out), flush=True)
    return 0


def host_rounds(roots: dict) -> None:
    """``--host`` runs of this script, the checkouts in turns."""
    order = list(roots) + list(roots)[::-1]
    got = {name: [] for name in roots}
    for name in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--host",
             roots[name]], capture_output=True, text=True, timeout=600,
            check=False)
        if res.returncode:
            raise SystemExit(f"--host {roots[name]} failed:\n{res.stdout}"
                             f"\n{res.stderr}")
        times = json.loads(res.stdout.strip().splitlines()[-1])
        got[name].append(times)
        print(f"host {name}: " + "; ".join(
            f"{k} {v:.3f} us" for k, v in times.items()), flush=True)
    for key in got[order[0]][0]:
        line = ", ".join(
            f"{name} {statistics.median(t[key] for t in runs):.3f} us"
            for name, runs in got.items())
        print(f"host median {key}: {line}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="root of the checkout to compare with")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--host", metavar="ROOT",
                    help="time one checkout's wrappers on the host, then "
                         "exit (run by this script)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_rows_ablation: CUDA is not available")
    if args.host:
        return host_main(args.host)
    if not args.parent or not os.path.isfile(
            os.path.join(args.parent, ROWS_CU)):
        raise SystemExit(f"--parent {args.parent}: not a checkout root")
    roots = {"parent": os.path.abspath(args.parent), "this": ROOT}
    procs = {name: build(name, root) for name, root in roots.items()}
    for name, patch in VARIANTS.items():
        procs[name] = build(name, ROOT, patch)
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        lib.qsgd_rows_launch.argtypes = (p, p, p, p, i, i, p, p)
        lib.sign_ef_rows_launch.argtypes = (p, p, p, p, i, i, p)
        libs[name] = lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}
    for shape in SHAPES:
        rows, d = shape
        x = torch.randn(shape, device=dev, generator=gen)
        e = 0.1 * torch.randn(shape, device=dev, generator=gen)
        u = torch.rand(shape, device=dev, generator=gen)
        lv = torch.tensor(256.0, device=dev)
        norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        outs = {name: [torch.empty_like(x) for _ in range(3)]
                for name in libs}

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def calls(name, lib):
            q, c, e2 = outs[name]

            def sign_ef():
                lib.sign_ef_rows_launch(x.data_ptr(), e.data_ptr(),
                                        c.data_ptr(), e2.data_ptr(), rows,
                                        d, stream())

            def qsgd_norms():
                lib.qsgd_rows_launch(x.data_ptr(), u.data_ptr(),
                                     norms.data_ptr(), q.data_ptr(), rows, d,
                                     lv.data_ptr(), stream())

            def api():
                if name != "parent":  # one launch, the norms computed inside
                    lib.qsgd_rows_launch(x.data_ptr(), u.data_ptr(), None,
                                         q.data_ptr(), rows, d,
                                         lv.data_ptr(), stream())
                    return
                lvc = torch.clamp_min(lv, 1.0)
                nm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
                lib.qsgd_rows_launch(x.data_ptr(), u.data_ptr(),
                                     nm.data_ptr(), q.data_ptr(), rows, d,
                                     lvc.data_ptr(), stream())
            return {"B1 sign_ef_rows": sign_ef, "B3 qsgd_rows, norms given":
                    qsgd_norms, "ops.qsgd_rows": api}
        runs = {name: calls(name, lib) for name, lib in libs.items()}
        for name in runs:
            runs[name]["B1 sign_ef_rows"]()
            runs[name]["B3 qsgd_rows, norms given"]()
        torch.cuda.synchronize()
        for name in runs:
            if not torch.equal(outs[name][0], outs["parent"][0]):
                raise SystemExit(f"{shape} {name}: B3 given the norms "
                                 "differs from the parent's")
            for a, b in zip(outs[name][1:], outs["parent"][1:]):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        reps = 200 if rows * d <= 1 << 22 else 20
        for rnd in range(args.rounds):
            order = list(runs) if rnd % 2 == 0 else list(runs)[::-1]
            for name in order:
                for kname, fn in runs[name].items():
                    us = graph_us(fn, reps)
                    times.setdefault((shape, kname, name), []).append(us)
                    print(f"round {rnd} {shape} {name} {kname}: {us:.4f} us",
                          flush=True)
        del x, e, u, norms, outs, runs
    for (shape, kname, name), t in sorted(times.items(), key=str):
        if name == "parent":
            continue
        new = statistics.median(t)
        old = statistics.median(times[(shape, kname, "parent")])
        print(f"median {shape} {kname}: {name} {new:.4f} us, parent "
              f"{old:.4f} us, {name} / parent {new / old:.3f} (rounds "
              f"{min(t):.4f}-{max(t):.4f} us)", flush=True)
    host_rounds(roots)
    return 0


if __name__ == "__main__":
    sys.exit(main())
