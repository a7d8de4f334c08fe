"""Decentralized learning (Alg. 2) on the gossip engine: consensus + local
SGD over ring / torus / Erdos-Renyi topologies. The mixing matrix W is an
axis of one sweep, so all three topologies run on one engine (watch the
trace counter), and every D2D edge is priced through the fading channel
layer (round time = slowest active edge). Convergence speed tracks the
spectral gap (section I.B). The port of ``examples/decentralized_gossip.py``.

    PYTHONPATH=src python -m repro_torch.examples.decentralized_gossip

Needs a CUDA card; ``main(device="cpu")`` runs it on the CPU. No kernel is
on this path: gossip's QSGD messages take the registry's plain rows.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.algorithms.registry import algo_params
from repro_torch.core.topology import (erdos_renyi, laplacian_mixing, ring,
                                       spectral_gap, torus_2d)
from repro_torch.examples.problems import make_lm_problem
from repro_torch.fl import decentralized as dz
from repro_torch.fl import runtime as rt

N, ROUNDS = 16, 40


def graphs() -> dict:
    """The three topologies over the N = 16 nodes, by name."""
    return {"ring": ring(N), "torus 4x4": torus_2d(4, 4),
            "erdos-renyi(0.4)": erdos_renyi(0, N, 0.4)}


def gossip_config(n_nodes: int, rounds: int, **kw) -> dz.GossipConfig:
    """QSGD, a scale-preserving quantizer: gossip exchanges *model states*,
    so rank-truncating compressors (topk) would shrink every node toward
    zero each mix. 1e6 model bits, lr 0.5; shared with ``fog_hybrid``."""
    return dz.GossipConfig(n_nodes=n_nodes, rounds=rounds, compression="qsgd",
                           model_bits=1e6, algo_params=algo_params(lr=0.5),
                           **kw)


def main(argv=None, device="cuda") -> dz.GossipLogs:
    """Print the trace count and a line a topology; return the sweep's
    logs (a leading axis of the three topologies)."""
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    dev = rt.resolve_device(device)
    names = list(graphs())
    wgrid = [laplacian_mixing(a) for a in graphs().values()]
    params0, loss_fn, sample, eval_fn = make_lm_problem(n_clients=N,
                                                        alpha=0.5, device=dev)
    t0 = rt.ENGINE_STATS["traces"]
    logs = dz.run_gossip_sweep(gossip_config(N, ROUNDS), loss_fn, params0,
                               sample, wgrid=wgrid,
                               eval_batch=eval_fn.eval_batch, device=dev)
    print(f"{len(wgrid)} topologies, {rt.ENGINE_STATS['traces'] - t0} "
          "trace(s)\n")
    for i, name in enumerate(names):
        gap = spectral_gap(np.asarray(wgrid[i]))
        print(f"{name:18s} spectral gap {gap:.3f}"
              f"  final loss {float(logs.loss[i, -1]):.4f}"
              f"  drift {float(logs.consensus_err[i, -1]):.4f}"
              f"  wall clock {float(logs.latency_s[i, -1]):.1f}s"
              f"  ({int(logs.n_edges[i, -1])} D2D edges)")
    return logs


if __name__ == "__main__":
    main()
