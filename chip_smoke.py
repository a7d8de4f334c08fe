"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. card: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile ``src/repro_torch/kernels/csrc/rows.cu`` with nvcc for
   sm_90a and print the build time and the compiler's register report;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the engine's block (4096, 32), the whole fleet (102400, 32), wide rows
   (256, 65536) and a ragged (1000, 1000): top-k and QSGD bitwise, scaled
   sign + EF to rtol 1e-5 / atol 1e-6; with each kernel's time, the plain
   version's time and the least time the card could take (bytes or
   operations over the card's peak rate);
4. reference: the engine on the card against the same engine on the CPU
   (whose plain versions the test suite holds against the JAX reference) at
   N = 4096, d = 256, the kernel-dispatch threshold: participation and
   uplink bits equal, loss within rtol 1e-4;
5. engine: the headline fleet configuration (N = 100000 clients, linear
   model d = 32, H = 2 local steps of batch 8, 4096-client blocks, on-device
   data, random scheduling of 256, 6 rounds) once per kernel-backed
   compressor with dense EF; every launch counter is set to 0 just before a
   run and read just after, and each run must launch its kernel; the loss
   must stay finite and fall.

The last two lines of output are the kernel table as JSON and the result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
SHAPES = [(4096, 32), (102400, 32), (256, 65536), (1000, 1000)]
ENGINE_BLOCK = (4096, 32)
FLEET = dict(n_devices=100_000, n_scheduled=256, local_steps=2,
             policy="random", chunk_size=4096, seed=0)
D_FLEET, ROUNDS, BATCH = 32, 6, 8

# per kernel: the TPU kernel it replaces, bytes per element it must move
# (each input read once, each output written once) plus bytes per row, and
# float32 operations per element (top-k: |x|, max, 24 x (compare, count),
# final compare + select; QSGD: 11 elementwise ops; scaled sign + EF: add,
# |.|, sum, sign, scale, subtract)
KERNELS = {
    "sign_ef_rows": ("src/repro/kernels/sign_ef.py:55", 16, 0, 6),
    "topk_rows": ("src/repro/kernels/topk_mask.py:83", 8, 0, 52),
    "qsgd_rows": ("src/repro/kernels/qsgd.py:64", 12, 4, 11),
}
SOURCE = "src/repro_torch/kernels/csrc/rows.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(name: str, shape) -> tuple:
    _, b_elem, b_row, ops = KERNELS[name]
    rows, d = shape
    t_bytes = (rows * d * b_elem + rows * b_row) / HBM_BYTES_PER_S * 1e3
    t_ops = rows * d * ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return smi


def build() -> None:
    from repro_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    so = kbuild.build()
    kbuild.lib()
    log(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")
    name = None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"(topk_rows_warp|topk_rows_block|qsgd_rows_kernel|"
                      r"sign_ef_rows_warp|sign_ef_rows_block)(?:ILi(\d+)E)?",
                      line)
        if m and "Compiling" in line:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")


def check_kernels(dev) -> dict:
    from repro_torch.kernels import qsgd, sign_ef, topk_mask
    gen = torch.Generator(device=dev).manual_seed(0)
    table = {}
    for shape in SHAPES:
        rows, d = shape
        x = torch.randn(shape, device=dev, generator=gen)
        e = 0.1 * torch.randn(shape, device=dev, generator=gen)
        u = torch.rand(shape, device=dev, generator=gen)
        k = torch.tensor(float(max(1, d // 100)), device=dev)
        lv = torch.tensor(256.0, device=dev)
        norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        iters = 200 if rows * d <= 1 << 22 else 20
        runs = {
            "topk_rows": (lambda: topk_mask.topk_rows(x, k),
                          lambda: topk_mask.topk_rows_plain(x, k)),
            "qsgd_rows": (lambda: qsgd.qsgd_rows(x, u, norms, lv),
                          lambda: qsgd.qsgd_rows_plain(x, u, norms, lv)),
            "sign_ef_rows": (lambda: sign_ef.sign_ef_rows(x, e),
                             lambda: sign_ef.sign_ef_rows_plain(x, e)),
        }
        for name, (kern, plain) in runs.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if name == "sign_ef_rows":
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            else:
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {shape}: kernel differs "
                                         "from its plain version")
                err = float((got - want).abs().max())
            ms, plain_ms = time_ms(kern, iters), time_ms(plain, iters)
            b_ms, b_by = bound_ms(name, shape)
            log(f"kernel {name} {shape}: max_abs_err {err:.3g} "
                f"ms {ms:.5f} plain_ms {plain_ms:.5f} "
                f"bound_ms {b_ms:.5f} ({b_by})")
            row = table.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if shape == ENGINE_BLOCK:
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by)
        del x, e, u, norms
    log("kernels: no single PyTorch call computes any of the three "
        "functions, so library_ms is null")
    return table


def _loss(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}


def check_against_cpu(dev) -> None:
    """The engine on the card against the engine on the CPU."""
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.data import make_linear_datagen
    from repro_torch.fl import runtime as rt
    d = 256
    w_star = np.random.default_rng(42).standard_normal(d).astype(np.float32)
    for comp in ("topk", "qsgd", "scaled_sign"):
        logs = []
        for device in (dev, "cpu"):
            cfg = rt.SimConfig(
                n_devices=4096, n_scheduled=64, rounds=2, local_steps=2,
                policy="random", compression=comp, chunk_size=1024, seed=20,
                algo_params=algos.algo_params(lr=0.1),
                datagen=make_linear_datagen(w_star))
            _, lg = rt.run_simulation_scan(
                cfg, _loss, {"w": np.zeros(d, np.float32)}, device=device)
            logs.append(lg)
        g, c = logs
        np.testing.assert_array_equal(g.participation, c.participation)
        np.testing.assert_array_equal(g.uplink_bits, c.uplink_bits)
        np.testing.assert_allclose(g.loss, c.loss, rtol=1e-4)
        np.testing.assert_allclose(g.latency_s, c.latency_s, rtol=1e-5)
        rel = float(np.max(np.abs(g.loss - c.loss) / np.abs(c.loss)))
        log(f"reference {comp}: card == cpu (participation, bits); "
            f"loss max rel diff {rel:.3g}")


def run_engine(dev, smi: str) -> dict:
    from repro_torch.core.algorithms import registry as algos
    from repro_torch.data import make_linear_datagen
    from repro_torch.fl import runtime as rt
    from repro_torch.kernels import qsgd, sign_ef, topk_mask
    counters = {"topk_rows": topk_mask.topk_rows,
                "qsgd_rows": qsgd.qsgd_rows,
                "sign_ef_rows": sign_ef.sign_ef_rows}
    by_comp = {"topk": "topk_rows", "qsgd": "qsgd_rows",
               "scaled_sign": "sign_ef_rows"}
    w_star = np.random.default_rng(42).standard_normal(D_FLEET).astype(
        np.float32)
    datagen = make_linear_datagen(w_star, local_steps=2, batch=BATCH)
    launches = {}
    for comp, kname in by_comp.items():
        def cfg(rounds):
            return rt.SimConfig(rounds=rounds, compression=comp,
                                datagen=datagen,
                                algo_params=algos.algo_params(lr=0.05),
                                **FLEET)
        params0 = {"w": np.zeros(D_FLEET, np.float32)}
        rt.run_simulation_scan(cfg(1), _loss, params0, device=dev)  # warm-up
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        params, logs = rt.run_simulation_scan(cfg(ROUNDS), _loss, params0,
                                              device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {n: fn.launches for n, fn in counters.items()}
        launches[kname] = counts[kname]
        log(f"engine {comp}: {ROUNDS / dt:.4f} rounds/s at N="
            f"{FLEET['n_devices']} on {smi}; launches {counts}; "
            f"loss {logs.loss.tolist()}")
        if counts[kname] == 0:
            raise AssertionError(f"engine {comp} never launched {kname}")
        if not np.all(np.isfinite(logs.loss)) or not (
                logs.loss[-1] < logs.loss[0]):
            raise AssertionError(f"engine {comp}: loss not finite or not "
                                 f"falling: {logs.loss}")
        if params["w"].shape != (D_FLEET,) or not bool(
                torch.isfinite(params["w"]).all()):
            raise AssertionError(f"engine {comp}: bad final params")
        if not np.all(logs.n_scheduled == FLEET["n_scheduled"]):
            raise AssertionError(f"engine {comp}: schedule size off")
    return launches


def main() -> int:
    smi = card()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build()
    table = check_kernels(dev)
    check_against_cpu(dev)
    launches = run_engine(dev, smi)
    rows = []
    for name, (replaces, *_rest) in KERNELS.items():
        r = table[name]
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
