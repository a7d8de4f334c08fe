"""Hierarchical FL over wireless (Alg. 9): SBS/MBS two-tier aggregation vs
flat FL, priced end-to-end by the channel layer: every device uploads its
compressed delta to its nearest SBS over the fading channel, the SBS->MBS
backhaul ships a separately compressed payload every H rounds, and each
cluster can run its own cell configuration (``cluster_wcfgs``). The port
of ``examples/hierarchical_fl.py``.

    PYTHONPATH=src python -m repro_torch.examples.hierarchical_fl

Needs a CUDA card; ``main(device="cpu")`` runs it on the CPU. No kernel is
on this path: the hierarchical engine compresses through the registry's
plain row compressors.
"""
from __future__ import annotations

import argparse

from repro_torch.core import wireless
from repro_torch.core.algorithms.registry import algo_params
from repro_torch.core.compression import compression_params
from repro_torch.core.hierarchy import HFLConfig
from repro_torch.examples.problems import make_lm_problem
from repro_torch.fl import runtime as rt

N, MODEL_BITS, ROUNDS = 21, 1e8, 60
PERIODS, N_CLUSTERS = (2, 4, 6), 7


def base_config(d: int, rounds: int, **kw) -> rt.SimConfig:
    """All N devices scheduled (per cluster under HFL) by the random
    policy, 2 local steps at lr 1.0, 1% top-k + EF on a D-dim model priced
    at MODEL_BITS; ``kw`` replaces or adds fields."""
    fields = dict(n_devices=N, n_scheduled=N, rounds=rounds,
                  algo_params=algo_params(lr=1.0), local_steps=2,
                  policy="random", model_bits=MODEL_BITS,
                  compression="topk",
                  compression_params=compression_params(k=d // 100))
    fields.update(kw)
    return rt.SimConfig(**fields)


def macro_cell() -> wireless.WirelessConfig:
    """Flat FL's one big (weak) cell around the macro BS."""
    return wireless.WirelessConfig(n_devices=N, cell_radius_m=1500.0)


def cluster_cells() -> list:
    """The N_CLUSTERS per-cluster channels: the outer cells run 5 dB
    hotter than the centre cell (e.g. to compensate a noisier band)."""
    return [wireless.WirelessConfig(n_devices=N,
                                    tx_power_dbm=10.0 if c == 0 else 15.0)
            for c in range(N_CLUSTERS)]


def main(argv=None, device="cuda") -> dict:
    """Print flat FL and HFL at each H; return ``{"flat" | H: RoundLogs}``."""
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    dev = rt.resolve_device(device)
    params, loss_fn, sample, eval_fn = make_lm_problem(n_clients=N,
                                                       alpha=0.3, device=dev)
    d = sum(p.numel() for p in params.values())
    base = base_config(d, ROUNDS)

    # flat FL: every device uploads to the macro BS over a big (weak) cell
    fl_logs = rt.run_simulation(base, loss_fn, params, sample,
                                eval_fn=eval_fn, wcfg=macro_cell(),
                                device=dev)
    print(f"flat FL   : loss {fl_logs[0].loss:.4f} -> {fl_logs[-1].loss:.4f}"
          f"  wall-clock {fl_logs[-1].latency_s:9.1f}s")
    out = {"flat": fl_logs}

    for h in PERIODS:
        # a fresh problem, so each H gets a new data stream
        params, loss_fn, sample, eval_fn = make_lm_problem(
            n_clients=N, alpha=0.3, device=dev)
        hcfg = HFLConfig(n_clusters=N_CLUSTERS, inter_cluster_period=h)
        logs = out[h] = rt.run_hfl(
            base, hcfg, loss_fn, params, sample, eval_fn=eval_fn,
            cluster_wcfgs=cluster_cells(), device=dev)
        speedup = fl_logs[-1].latency_s / logs[-1].latency_s
        print(f"HFL (H={h}): loss {logs[0].loss:.4f} -> {logs[-1].loss:.4f}"
              f"  wall-clock {logs[-1].latency_s:9.1f}s"
              f"  ({speedup:.1f}x faster than flat FL)")
    return out


if __name__ == "__main__":
    main()
