"""The reference's side of ``tests/test_torch_cluster_tp.py``,
``tests/test_torch_cluster_tp_serve.py`` and
``tests/test_torch_cluster_tp_recurrent.py``: every case of a kind of
``torch_cluster_workers.tp_cases`` (train or serving, of the transformer
block or the recurrent blocks), jitted with its shardings on a mesh of Auto
axes over
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


def start_reference(kind, out: str) -> subprocess.Popen:
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


def _serve(name, shape, res, greedy: bool = False):
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
                                       TPR_GREEDY, _flat_tree, tp_key,
                                       tp_serve_inputs)
    cfg = _cfg(name)
    mesh = _mesh(shape)
    key = f"serve/{tp_key(name, shape)}/"
    # on a model axis of one the expert-parallel ``shard_map`` does not
    # compile in a step partitioned over data (JAX 0.9: "Cross-partition
    # allreduce must be in (partial) manual partitioning mode"); the
    # auto-partitioned ``moe_forward`` computes the same function
    jmoe.set_expert_parallel_mesh(mesh if cfg.n_experts and shape[1] > 1
                                  else None)
    # the unjitted init outside the mesh's context, as in ``_step``
    params = _gates(jtf.init_params(cfg, jax.random.PRNGKey(1)))
    with mesh:
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
        first = cache
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
        if greedy:   # from the prefill's token, as the port's members
            logits = res[key + "prefill/logits"]
            cache, toks, outs = first, [], []
            for i in range(TPR_GREEDY):
                tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(
                    jnp.int32)[:, None]
                toks.append(np.asarray(tok))
                logits, cache = decode(params, jax.device_put(cache, csh),
                                       tok, jnp.int32(TP_S + i))
                outs.append(np.asarray(logits))
            res[key + "greedy/ref"] = np.concatenate(toks, axis=1)
            res[key + "greedy/logits"] = np.stack(outs)
    jmoe.set_expert_parallel_mesh(None)


def _step(case, res):
    """One train case's losses and final params; the unjitted init runs
    outside the mesh's context, so that its op-by-op compilations are
    shared by every case of a config."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as jsteps
    from repro_torch import convert
    from torch_cluster_workers import STEP_POLICY, tp_batches
    name, cname, mode, comp, _, shape = case
    cfg = _cfg(cname)
    pol = jsteps.TrainPolicy(mode=mode, compression=comp,
                             error_feedback=comp in ("int8", "sign"),
                             **STEP_POLICY)
    mesh = _mesh(shape)
    state = jsteps.make_init_fn(cfg, pol, mesh)(jax.random.PRNGKey(0))
    with mesh:
        state["params"] = _gates(state["params"])
        state = jax.device_put(state, jsteps.state_shardings(
            cfg, pol, mesh, state))
        step = jax.jit(jsteps.make_train_step(cfg, pol, mesh))
        for i, b in enumerate(tp_batches(cfg)):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            res[f"step/{name}/loss/{i}"] = np.float64(m["loss"])
        final = convert.lm_params_from_jax(jax.tree.map(
            np.asarray, state["params"]))
        res.update({f"step/{name}/final/{k}": v.numpy()
                    for k, v in final.items()})


def reference(kinds, out: str) -> None:
    """Every case's reference outputs of a kind of ``torch_cluster_workers.
    tp_cases`` (or of each of a tuple of kinds), keyed as the port's
    members key theirs (``tp_members``)."""
    from torch_cluster_workers import tp_cases
    res = {}
    for kind in (kinds,) if isinstance(kinds, str) else kinds:
        if kind in ("serve", "rserve", "mserve"):
            for name, shape in tp_cases(kind):
                _serve(name, shape, res, greedy=kind != "serve")
            continue
        done = {}   # a case whose computation an earlier one made is copied
        for case in tp_cases(kind):
            same = done.setdefault(case[1:4] + case[5:], case[0])
            if same == case[0]:
                _step(case, res)
            else:
                pre = f"step/{same}/"
                res.update({f"step/{case[0]}/{k[len(pre):]}": v
                            for k, v in list(res.items())
                            if k.startswith(pre)})
    np.savez(out, **res)
