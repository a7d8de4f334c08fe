"""The reference's side of ``tests/test_torch_cluster_tp.py`` and
``tests/test_torch_cluster_tp_serve.py``: every train case of
``torch_cluster_workers.TP_STEP_CASES`` or serving case of
``TP_SERVE_CASES``, jitted with its shardings on a mesh of Auto axes over
forced CPU devices, in one process; the results go to an ``.npz`` keyed
as the port's members key theirs. ``start_reference`` starts it in a
subprocess under ``--xla_force_host_platform_device_count`` (the test
process has one device).
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def start_reference(kind: str, out: str) -> subprocess.Popen:
    """Start ``reference(kind, out)`` in a subprocess with 4 CPU devices;
    the port's members may run meanwhile (both sides draw their inputs
    from the same seeds: the reference's unjitted init is the port's bit
    for bit)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [HERE, SRC] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    code = f"import torch_tp_jax as m; m.reference({kind!r}, {out!r})"
    return subprocess.Popen([sys.executable, "-c", code], env=env)


def finish_reference(proc: subprocess.Popen, out: str,
                     timeout: float = 900) -> dict:
    """Wait for ``proc``; returns the ``.npz`` it wrote."""
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, f"the reference exited {rc}"
    with np.load(out, allow_pickle=False) as f:
        return dict(f)


def _cfg(name):
    import dataclasses

    from repro.configs import get_config
    from torch_cluster_workers import TP_CONFIGS
    arch, kw = TP_CONFIGS[name]
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _mesh(shape):
    import jax
    from jax.sharding import AxisType, Mesh
    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


def _gates(params):
    """The vlm's cross gates at 0.5 (they start at 0, which would hide the
    cross layers)."""
    import jax.numpy as jnp
    if "cross" in params.get("blocks", {}):
        cross = params["blocks"]["cross"]
        for g in ("gate_attn", "gate_mlp"):
            cross[g] = jnp.full_like(cross[g], 0.5)
    return params


def _serve(name, shape, res):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.launch import serve as jserve
    from repro.launch import sharding as jsh
    from repro.launch import steps as jsteps
    from repro.models import moe as jmoe
    from repro.models import transformer as jtf
    from torch_cluster_workers import (TP_B, TP_DECODE, TP_S, TP_T,
                                       _flat_tree, tp_key, tp_serve_inputs)
    cfg = _cfg(name)
    mesh = _mesh(shape)
    key = f"serve/{tp_key(name, shape)}/"
    jmoe.set_expert_parallel_mesh(mesh if cfg.n_experts else None)
    with mesh:
        params = _gates(jtf.init_params(cfg, jax.random.PRNGKey(1)))
        psh = jsh.param_shardings(cfg, params, mesh)
        params = jax.device_put(params, psh)
        inp = tp_serve_inputs(cfg)
        batch = {k: jnp.asarray(v) for k, v in inp.items() if k != "steps"}
        bsh = jsh.batch_shardings(batch, mesh)
        logits, pf = jax.jit(jsteps.make_prefill_step(cfg),
                             in_shardings=(psh, bsh))(params, batch)
        res[key + "prefill/logits"] = np.asarray(logits)
        for k, v in _flat_tree(pf, "", {}).items():
            res[key + "prefill/cache/" + k] = np.asarray(v)
        cache = jserve._load_prefill(cfg, jtf.init_decode_cache(
            cfg, TP_B, TP_T), pf, TP_S)
        csh = jsh.cache_shardings(cfg, cache, mesh, TP_B)
        steps = jnp.asarray(inp["steps"])
        tsh = jsh.batch_shardings({"t": steps[:, :1]}, mesh)["t"]
        decode = jax.jit(jsteps.make_decode_step(cfg, circular=False),
                         in_shardings=(psh, csh, tsh,
                                       NamedSharding(mesh, P())))
        for i in range(TP_DECODE):
            logits, cache = decode(params, jax.device_put(cache, csh),
                                   steps[:, i:i + 1], jnp.int32(TP_S + i))
            res[key + f"decode/{i}/logits"] = np.asarray(logits)
        for k, v in _flat_tree(cache, "", {}).items():
            res[key + "decode/cache/" + k] = np.asarray(v)
    jmoe.set_expert_parallel_mesh(None)


def _step(case, res):
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as jsteps
    from repro_torch import convert
    from torch_cluster_workers import STEP_POLICY, TP_STEP_CASES, tp_batches
    name, cname, mode, comp, _, shape = next(c for c in TP_STEP_CASES
                                             if c[0] == case)
    cfg = _cfg(cname)
    pol = jsteps.TrainPolicy(mode=mode, compression=comp,
                             error_feedback=comp in ("int8", "sign"),
                             **STEP_POLICY)
    mesh = _mesh(shape)
    with mesh:
        state = jsteps.make_init_fn(cfg, pol, mesh)(jax.random.PRNGKey(0))
        state["params"] = _gates(state["params"])
        state = jax.device_put(state, jsteps.state_shardings(
            cfg, pol, mesh, state))
        step = jax.jit(jsteps.make_train_step(cfg, pol, mesh))
        for i, b in enumerate(tp_batches(cfg)):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            res[f"step/{case}/loss/{i}"] = np.float64(m["loss"])
        final = convert.lm_params_from_jax(jax.tree.map(
            np.asarray, state["params"]))
        res.update({f"step/{case}/final/{k}": v.numpy()
                    for k, v in final.items()})


def reference(kind: str, out: str) -> None:
    """Every ``kind`` ("serve" or "train") case's reference outputs, keyed
    as the port's members key theirs (``torch_cluster_workers.
    tp_members``)."""
    from torch_cluster_workers import TP_SERVE_CASES, TP_STEP_CASES
    res = {}
    if kind == "serve":
        for name, shape in TP_SERVE_CASES:
            _serve(name, shape, res)
    else:
        for case in TP_STEP_CASES:
            _step(case[0], res)
    np.savez(out, **res)
