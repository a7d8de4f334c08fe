"""Fog learning hybrid (arXiv 2006.03594): intra-cluster D2D gossip between
SBS sync rounds. Devices deploy on the HFL hex geometry; cluster members run
``gossip_steps`` priced D2D consensus exchanges per round, and every
``inter_cluster_period`` rounds the SBS tier collapses everyone to the
(online-weighted) global mean over the wired backhaul. More local gossip
(k up) buys drift control between syncs with D2D airtime instead of
backhaul bits. The port of ``examples/fog_hybrid.py``.

    PYTHONPATH=src python -m repro_torch.examples.fog_hybrid

Needs a CUDA card; ``main(device="cpu")`` runs it on the CPU. No kernel is
on this path: the QSGD messages take the registry's plain rows.
"""
from __future__ import annotations

import argparse

from repro_torch.core.hierarchy import HFLConfig
from repro_torch.examples.decentralized_gossip import gossip_config
from repro_torch.examples.problems import make_lm_problem
from repro_torch.fl import decentralized as dz
from repro_torch.fl import runtime as rt

N, ROUNDS, STEPS = 28, 24, (1, 2, 4)


def hfl_config() -> HFLConfig:
    """7 hex clusters, SBS sync every 4 rounds."""
    return HFLConfig(n_clusters=7, inter_cluster_period=4)


def main(argv=None, device="cuda") -> dict:
    """Print the frontier over k; return ``{k: GossipLogs}``. The three
    runs share one problem, so each k draws the batches after the last."""
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    dev = rt.resolve_device(device)
    params0, loss_fn, sample, eval_fn = make_lm_problem(n_clients=N,
                                                        alpha=0.5, device=dev)
    hcfg = hfl_config()
    print(f"{N} devices, 7 clusters, SBS sync every {hcfg.inter_cluster_period}"
          " rounds\n  k  final-loss  wall-clock  backhaul-bits  drift")
    out = {}
    for k in STEPS:
        _, logs = dz.run_fog(
            gossip_config(N, ROUNDS, gossip_steps=k), hcfg, loss_fn, params0,
            sample, eval_batch=eval_fn.eval_batch, device=dev)
        out[k] = logs
        print(f"  {k}  {float(logs.loss[-1]):10.4f}"
              f"  {float(logs.latency_s[-1]):9.1f}s"
              f"  {float(logs.backhaul_bits.sum()):12.2e}"
              f"  {float(logs.consensus_err[-1]):.2e}")
    return out


if __name__ == "__main__":
    main()
