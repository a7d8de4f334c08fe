"""The reference's side of ``tests/test_torch_dryrun_account.py``: its
compiled analyses of each of ``ACCOUNT_CASES`` on a mesh of Auto axes over
forced CPU devices, written to a JSON file. ``run_reference`` starts it in
a subprocess under ``--xla_force_host_platform_device_count`` (the test
process has one device)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

# (arch, reduced() config's mesh (data, model), shape kind, policy name);
# global batch (8, 64), a decode cache of 64
ACCOUNT_CASES = (
    [("gemma-2b", (2, 1), "train", p)
     for p in ("baseline", "int8_ef", "sign_ef", "localsgd_h4", "fsdp")]
    + [("qwen2-moe-a2.7b", m, k, "baseline")
       for m in ((1, 1), (1, 2)) for k in ("train", "prefill", "decode")])
BATCH, SEQ = 8, 64
# a decode cache of d_inner positions (256 at reduced()), which the cache
# rule splits over model where the kv heads do not divide (gemma-2b's one)
SEQ_SPLIT_CASES = (("gemma-2b", (1, 2), "decode", "baseline"),)
SPLIT_SEQ = 256


def case_seq(case) -> int:
    """The sequence length (a decode cache's positions) of a case."""
    return SPLIT_SEQ if tuple(case) in SEQ_SPLIT_CASES else SEQ


def case_key(arch, mesh, kind, policy) -> str:
    return f"{arch}/{mesh[0]}x{mesh[1]}/{kind}/{policy}"


def run_reference(out: str, timeout: float = 600) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [HERE, SRC] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    code = f"import torch_dryrun_jax as m; m.account({out!r})"
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=timeout)
    with open(out) as f:
        return json.load(f)


def account(out: str) -> None:
    """Each case jitted with its shardings, lowered and compiled: its
    memory analysis, parsed flops and HBM bytes, and collectives; or its
    failure."""
    import jax
    import numpy as np
    from jax.sharding import AxisType, Mesh

    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.launch import dryrun, hlo_analysis, specs
    res = {}
    for arch, mshape, kind, policy in ACCOUNT_CASES + list(SEQ_SPLIT_CASES):
        key = case_key(arch, mshape, kind, policy)
        n = mshape[0] * mshape[1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(mshape),
                    ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        cfg = get_config(arch).reduced()
        shape = ShapeSpec(kind, kind, case_seq((arch, mshape, kind, policy)),
                          BATCH)
        try:
            with mesh:
                fn, args, sh = specs.build_case(
                    cfg, shape, mesh, dryrun.policy_from_name(policy))
                compiled = jax.jit(fn, in_shardings=sh).lower(
                    *args).compile()
        except Exception as e:  # noqa: BLE001 - a failure is a result
            res[key] = {"status": "fail", "error": f"{type(e).__name__}: {e}"}
            continue
        hlo = compiled.as_text()
        mem = compiled.memory_analysis()
        res[key] = {"status": "ok",
                    "argument_bytes": mem.argument_size_in_bytes,
                    "temp_bytes": mem.temp_size_in_bytes,
                    "parsed": hlo_analysis.hlo_compute_stats(hlo),
                    "collectives": hlo_analysis.collective_stats(hlo)}
    with open(out, "w") as f:
        json.dump(res, f)
