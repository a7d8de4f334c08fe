"""How often the port's gossip and fog latencies leave the parity contract's
rtol 1e-5 against the JAX engines, over many channel seeds, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_gossip_latency_seeds.py \
        [--seeds 100] [--fog]

Needs both packages (JAX and PyTorch). Runs ``examples/
decentralized_gossip.py``'s cell (N = 16; ring, 4x4 torus and ER(0.4)
with Laplacian mixing; QSGD, 1e6 model bits, lr 0.5, 40 rounds) as one
sweep over seeds 0..S-1 in each package, and with ``--fog``
``examples/fog_hybrid.py``'s (N = 28 in 7 clusters synced every 4 rounds,
k = 2 gossip steps, 24 rounds) seed by seed. The round latency depends on
the channel draws, the topology and the priced bits, not on the model, so
the linear problem (d = 32, H = 2, B = 8) stands in for the examples' LM
problem. Prints the largest relative latency difference and how many
variant-rounds exceed 1e-5 (a deep fade's ``log2(1 + snr)`` magnifies an
ulp of the SNR).
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.common import make_linear_problem  # noqa: E402
from repro.core import topology as jt  # noqa: E402
from repro.core.algorithms.registry import algo_params  # noqa: E402
from repro.core.hierarchy import HFLConfig as JHFLConfig  # noqa: E402
from repro.fl import decentralized as jdz  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.fl import decentralized as tdz  # noqa: E402


def _loss_t(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}


def _report(what, want, got) -> None:
    rel = np.abs(np.asarray(got) - want) / np.abs(want)
    print(f"{what}: {rel.size} variant-rounds, max rel diff {rel.max():.3g}, "
          f"{int((rel > 1e-5).sum())} past 1e-5 (in "
          f"{int((rel > 1e-5).reshape(rel.shape[0], -1).any(1).sum())} of "
          f"{rel.shape[0]} variants)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--fog", action="store_true")
    args = ap.parse_args()
    params, loss_fn, make_batches, _ = make_linear_problem()
    np_params = {k: np.asarray(v) for k, v in params.items()}

    def batches(t, n):
        return {k: np.asarray(v) for k, v in make_batches(t, n).items()}
    seeds = list(range(args.seeds))

    n = 16
    wgrid = [jt.laplacian_mixing(a) for a in (
        jt.ring(n), jt.torus_2d(4, 4), jt.erdos_renyi(0, n, 0.4))]
    cfg = jdz.GossipConfig(n_nodes=n, rounds=40, compression="qsgd",
                           model_bits=1e6, algo_params=algo_params(lr=0.5))
    want = jdz.run_gossip_sweep(cfg, loss_fn, params, make_batches,
                                wgrid=wgrid, seeds=seeds)
    got = tdz.run_gossip_sweep(convert.gossip_config_from_jax(cfg), _loss_t,
                               np_params, batches,
                               wgrid=[np.asarray(w) for w in wgrid],
                               seeds=seeds, device="cpu")
    _report(f"gossip N = {n}, 3 topologies x {len(seeds)} seeds, 40 rounds",
            np.asarray(want.latency_s), np.asarray(got.latency_s))

    if args.fog:
        n, hcfg = 28, JHFLConfig(n_clusters=7, inter_cluster_period=4)
        want, got = [], []
        for s in seeds:
            cfg = jdz.GossipConfig(n_nodes=n, rounds=24, gossip_steps=2,
                                   compression="qsgd", model_bits=1e6,
                                   algo_params=algo_params(lr=0.5), seed=s)
            want.append(np.asarray(jdz.run_fog(
                cfg, hcfg, loss_fn, params, make_batches)[1].latency_s))
            got.append(np.asarray(tdz.run_fog(
                convert.gossip_config_from_jax(cfg),
                convert.hfl_config_from_jax(hcfg), _loss_t, np_params,
                batches, device="cpu")[1].latency_s))
        _report(f"fog N = {n}, k = 2, {len(seeds)} seeds, 24 rounds",
                np.stack(want), np.stack(got))
    return 0


if __name__ == "__main__":
    torch.set_num_threads(4)
    sys.exit(main())
