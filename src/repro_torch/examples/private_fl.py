"""Private federated learning: priced secure aggregation + DP accounting.
The port of ``examples/private_fl.py``.

Three runs of the quickstart's small-LM federation, one per privacy
posture:

* ``none``: the clear baseline;
* ``secagg``: pairwise-masked finite-field sums: the server only ever sees
  the cohort total (bitwise the plain field-quantized sum), and the mask
  key-agreement bits price the uplink;
* ``secagg_dp``: secagg plus per-client clipping and discrete field noise,
  with the cumulative (epsilon, delta) guarantee accounted every round.

Then one ``run_sweep`` call traces the privacy-utility frontier over the
``PrivacyParams`` sigma grid.

    PYTHONPATH=src python -m repro_torch.examples.private_fl

Needs a CUDA card; ``main(device="cpu")`` runs it on the CPU. No kernel is
on this path: without a compressor the rows are not compressed.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.privacy import privacy_params
from repro_torch.examples import quickstart as qs
from repro_torch.fl import runtime as rt

N, ROUNDS = qs.N, 20
CLIP, SIGMA, SIGMAS = 1.0, 0.5, (0.3, 1.0, 3.0)


def main(argv=None, device="cuda") -> dict:
    """Print each mechanism's last round and the frontier; return
    ``{"none" | "secagg" | "secagg_dp": RoundLogs, "dp": SimLogs}``."""
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    dev = rt.resolve_device(device)
    cfg, params, loss_fn = qs.model(dev)
    print(f"model: {cfg.name}  params~{cfg.param_count():,}")
    loader = qs.make_loader(cfg.vocab_size)
    pp = privacy_params(clip=CLIP, sigma=SIGMA)

    def sim_for(privacy):
        return qs.sim_config(cfg, ROUNDS, privacy=privacy, privacy_params=pp)

    out = {}
    for privacy in ("none", "secagg", "secagg_dp"):
        logs = out[privacy] = rt.run_simulation(
            sim_for(privacy), loss_fn, params,
            lambda t, n: loader.next_round(), device=dev)
        last = logs[-1]
        eps = (f"eps={last.epsilon:6.2f} (delta={last.delta:.0e})"
               if np.isfinite(last.epsilon) else "eps=   inf (no DP)")
        print(f"{privacy:>9}: loss {last.loss:.4f}  {eps}  "
              f"uplink {last.uplink_bits:.2e}b "
              f"(masks {last.mask_bits:.2e}b)")

    # privacy-utility frontier: the sigma grid is one sweep axis
    batches = rt.stack_batches(lambda t, n_: loader.next_round(), ROUNDS, N)
    res = rt.run_sweep(sim_for("dp"), loss_fn, params, batches,
                       seeds=[0], privacies=["dp"],
                       pparams_grid=[privacy_params(clip=CLIP, sigma=s)
                                     for s in SIGMAS], device=dev)
    logs = out["dp"] = res[("age", "dp")]
    print(f"\nprivacy-utility frontier (dp, clip={CLIP}):")
    for i, s in enumerate(SIGMAS):
        print(f"  sigma={s:3.1f}: loss {float(logs.loss[i, -1]):.4f}  "
              f"eps={float(logs.epsilon[i, -1]):6.2f}")
    print("private_fl OK")
    return out


if __name__ == "__main__":
    main()
