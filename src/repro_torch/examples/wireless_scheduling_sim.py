"""Fig. 1/2-style wireless scheduling study: compare all policies on the same
non-iid federated problem, reporting loss-vs-wall-clock (the chapter's core
message: schedule for *learning* progress, not just channel throughput).
The port of ``examples/wireless_scheduling_sim.py``.

The batch stack is sampled once, then ``runtime.run_sweep`` runs every
policy's ROUNDS-round run through the engine, one after another.

    PYTHONPATH=src python -m repro_torch.examples.wireless_scheduling_sim

Needs a CUDA card; ``main(device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.algorithms.registry import algo_params
from repro_torch.core.scheduling import policy_names
from repro_torch.examples.problems import make_lm_problem
from repro_torch.fl import runtime as rt

N, ROUNDS = 20, 60


def main(argv=None, device="cuda") -> dict:
    """Print the table and the best policy; return ``{policy: SimLogs}``."""
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    dev = rt.resolve_device(device)
    params, loss_fn, sample, eval_fn = make_lm_problem(n_clients=N,
                                                       alpha=0.1, device=dev)
    cfg = rt.SimConfig(n_devices=N, n_scheduled=4, rounds=ROUNDS,
                       algo_params=algo_params(lr=1.0), local_steps=4,
                       model_bits=1e6)
    batches = rt.stack_batches(sample, ROUNDS, cfg.n_devices)
    sweep = rt.run_sweep(cfg, loss_fn, params, batches, seeds=[cfg.seed],
                         policies=list(policy_names()),
                         eval_batch=eval_fn.eval_batch, device=dev)

    print(f"{'policy':14s} {'final loss':>10s} {'wall-clock':>11s} "
          f"{'avg sched':>9s}")
    results = {}
    for pol, logs in sweep.items():
        final_loss = float(logs.loss[0, -1])
        wall = float(logs.latency_s[0, -1])
        sched = float(np.mean(logs.n_scheduled[0]))
        results[pol] = final_loss
        print(f"{pol:14s} {final_loss:10.4f} {wall:10.1f}s {sched:9.1f}")
    best = min(results, key=results.get)
    print(f"\nbest final loss: {best} ({results[best]:.4f})")
    return sweep


if __name__ == "__main__":
    main()
