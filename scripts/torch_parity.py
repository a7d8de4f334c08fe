"""Report how far the PyTorch port's flat engine sits from the JAX engine.

    PYTHONPATH=src:. python scripts/torch_parity.py

Runs, on the CPU, the configurations of ``tests/test_torch_engine.py`` (a)
and ``tests/test_torch_engine_fleet.py`` (b) through both packages and
prints, per configuration, whether participation and uplink bits are equal
and the largest relative deviation of loss and latency. The tests assert the
tolerances; this script measures what is inside them.
"""
from __future__ import annotations

import numpy as np

from benchmarks.common import make_linear_problem
from repro.core import scheduling as jsched
from repro.data import make_linear_datagen as jdatagen
from repro.fl import runtime as jrt
from repro_torch.core.algorithms import registry as talg
from repro_torch.data import make_linear_datagen as tdatagen
from repro_torch.fl import runtime as trt

SEED = 20


def _loss_t(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}


def _report(tag, jl, tl) -> tuple:
    loss = float(np.max(np.abs(tl.loss - jl.loss) / np.abs(jl.loss)))
    lat = float(np.max(np.abs(tl.latency_s - jl.latency_s) / jl.latency_s))
    part = bool(np.array_equal(tl.participation, jl.participation))
    bits = bool(np.array_equal(tl.uplink_bits, jl.uplink_bits))
    print(f"{tag}: participation_equal={part} bits_equal={bits} "
          f"loss_rel={loss:.3g} latency_rel={lat:.3g}", flush=True)
    return loss, lat


def main() -> None:
    worst = {"a": [0.0, 0.0], "b": [0.0, 0.0]}
    params, loss_fn, make_batches, _ = make_linear_problem(d=32)
    batches = jrt.stack_batches(make_batches, 12, 40)
    cases = ([(p, "none") for p in jsched.policy_names()]
             + [("pf", c) for c in ("topk", "qsgd", "scaled_sign")])
    for policy, comp in cases:
        kw = dict(n_devices=40, n_scheduled=8, rounds=12, local_steps=2,
                  policy=policy, compression=comp, seed=SEED)
        _, jl = jrt.run_simulation_scan(
            jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1), **kw),
            loss_fn, params, batches)
        _, tl = trt.run_simulation_scan(
            trt.SimConfig(algo_params=talg.algo_params(lr=0.1), **kw),
            _loss_t, {"w": np.asarray(params["w"])},
            {k: np.asarray(v) for k, v in batches.items()}, device="cpu")
        for i, v in enumerate(_report(f"(a) {policy} {comp}", jl, tl)):
            worst["a"][i] = max(worst["a"][i], v)
    params, loss_fn, _, w_star = make_linear_problem(d=256)
    for comp in ("topk", "qsgd", "scaled_sign"):
        kw = dict(n_devices=4096, n_scheduled=64, rounds=2, local_steps=2,
                  policy="random", compression=comp, chunk_size=1024,
                  seed=SEED)
        _, jl = jrt.run_simulation_scan(
            jrt.SimConfig(algo_params=jrt.algo_params(lr=0.1),
                          datagen=jdatagen(w_star, batch=2), **kw),
            loss_fn, params)
        _, tl = trt.run_simulation_scan(
            trt.SimConfig(algo_params=talg.algo_params(lr=0.1),
                          datagen=tdatagen(np.asarray(w_star), batch=2),
                          **kw),
            _loss_t, {"w": np.zeros(256, np.float32)}, device="cpu")
        for i, v in enumerate(_report(f"(b) {comp}", jl, tl)):
            worst["b"][i] = max(worst["b"][i], v)
    for k, (loss, lat) in worst.items():
        print(f"worst ({k}): loss_rel={loss:.3g} latency_rel={lat:.3g}")


if __name__ == "__main__":
    main()
