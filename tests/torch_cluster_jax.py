"""The reference's side of ``tests/test_torch_cluster_*.py``: each function
runs the JAX package on a mesh of Auto axes over forced CPU devices and
writes its outputs to an ``.npz``. ``run_reference`` starts it in a
subprocess under ``--xla_force_host_platform_device_count`` (the test
process has one device); ``make_local_mesh`` gives Explicit axes under
JAX 0.9, on which the reference's int8 and sign ``jnp.repeat`` raise.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

from torch_cluster_workers import (COLL_MESHES, COLL_METHODS, COLL_SHAPES,
                                   RING_WEIGHTS, member_leaf)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def run_reference(case: str, n_devices: int, out: str, *args,
                  timeout: float = 600) -> dict:
    """Run ``case(out, *args)`` of this module in a subprocess with
    ``n_devices`` CPU devices; returns the ``.npz`` it wrote."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices}",
               PYTHONPATH=os.pathsep.join(
                   [HERE, SRC] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    code = (f"import torch_cluster_jax as m; m.{case}({out!r}, "
            f"*{args!r})")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=timeout)
    with np.load(out, allow_pickle=False) as f:
        return dict(f)


def _auto_mesh(shape, names):
    import jax
    from jax.sharding import AxisType, Mesh
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names,
                axis_types=(AxisType.Auto,) * len(names))


def collectives(out: str) -> None:
    """``hierarchical_allreduce`` of one leaf a member over every axis of
    each mesh (EF on the first stage), every method, with and without EF:
    each member's output and error."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.core import collectives as jc
    from repro.core.compat import shard_map
    res = {}
    for mname, (shape, names) in COLL_MESHES.items():
        mesh = _auto_mesh(shape, names)
        n = int(np.prod(shape))
        for i, lshape in enumerate(COLL_SHAPES):
            gs, es = zip(*(member_leaf(lshape, i, r) for r in range(n)))
            g, e = np.stack(gs), np.stack(es)
            for method in COLL_METHODS:
                for with_e in (True, False):
                    def body(g, *e):
                        o, en = jc.hierarchical_allreduce(
                            {"w": g[0]}, names, method,
                            {"w": e[0][0]} if e else None)
                        o = o["w"][None]
                        return (o, en["w"][None]) if e else (o,)
                    args = (g, e) if with_e else (g,)
                    spec = P(names)
                    f = shard_map(body, mesh=mesh,
                                  in_specs=(spec,) * len(args),
                                  out_specs=(spec,) * len(args),
                                  check_vma=False)
                    got = jax.jit(f)(*args)
                    key = f"{mname}/{method}/{int(with_e)}/{i}"
                    res[key + "/out"] = np.asarray(got[0])
                    if with_e:
                        res[key + "/err"] = np.asarray(got[1])
    np.savez(out, **res)


def ring(out: str) -> None:
    """``ring_gossip_shard_map`` on a 1-D mesh of 4, float32 and bf16
    leaves, each self weight."""
    import jax
    import jax.numpy as jnp

    from repro.fl.decentralized import ring_gossip_shard_map
    mesh = _auto_mesh((4,), ("data",))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 3, 5000)).astype(np.float32)
    res = {}
    for i, w in enumerate(RING_WEIGHTS):
        got = jax.jit(ring_gossip_shard_map(mesh, "data", w))(
            {"f32": jnp.asarray(x),
             "bf16": jnp.asarray(x).astype(jnp.bfloat16)})
        res[f"{i}/f32"] = np.asarray(got["f32"])
        res[f"{i}/bf16"] = np.asarray(got["bf16"]).view(np.int16)
    np.savez(out, **res)


def steps(out: str, cases) -> None:
    """The trainer cases ``cases`` of ``STEP_CASES``: the reference's
    jitted initial state, three steps' losses, the EF after the first and
    the final params, EF and counters (in the port's flat layout,
    ``torch_cluster_workers.flat_state``); then the pod sync alone."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.core.compat import shard_map
    from repro.launch import steps as jsteps
    from repro_torch import convert
    from torch_cluster_workers import (POD_SYNC_SHAPE, STEP_CASES,
                                       STEP_POLICY, flat_state, step_batches)
    res = {}
    for case, arch, mode, comp, shape, axes, sync in STEP_CASES:
        if case not in cases:
            continue
        cfg = get_config(arch).reduced()
        pol = jsteps.TrainPolicy(mode=mode, compression=comp,
                                 error_feedback=comp in ("int8", "sign"),
                                 sync_pods=sync, **STEP_POLICY)
        mesh = _auto_mesh(shape, axes)
        with mesh:
            state = jax.jit(jsteps.make_init_fn(cfg, pol, mesh))(
                jax.random.PRNGKey(0))
            step = jax.jit(jsteps.make_train_step(cfg, pol, mesh))

            def flat(st):
                return flat_state(convert.train_state_from_jax(
                    jax.tree.map(np.asarray, st)))
            res.update({f"{case}/init/{k}": v
                        for k, v in flat(state).items()})
            for i, b in enumerate(step_batches(cfg.vocab_size)):
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
                res[f"{case}/loss/{i}"] = np.float64(m["loss"])
                if i == 0 and "ef" in state:
                    res.update({f"{case}/ef0/{k}": v for k, v in
                                flat(state).items() if k.startswith("ef/")})
            res.update({f"{case}/final/{k}": v
                        for k, v in flat(state).items()
                        if not k.startswith("opt/") or k == "opt/step"})
    # the pod sync's bf16 mean alone, on a mesh of the pod axis
    x = np.random.default_rng(3).standard_normal(POD_SYNC_SHAPE).astype(
        np.float32) * np.logspace(-3, 3, POD_SYNC_SHAPE[1],
                                  dtype=np.float32)
    mesh = _auto_mesh((2,), ("pod",))
    sync = shard_map(lambda p: jax.lax.pmean(p.astype(jnp.bfloat16), "pod")
                     .astype(p.dtype), mesh=mesh, in_specs=P("pod"),
                     out_specs=P("pod"), check_vma=False)
    res["pod_sync/x"] = x
    res["pod_sync/out"] = np.asarray(jax.jit(sync)(x))
    np.savez(out, **res)


def moe_ep(out: str) -> None:
    """``moe_forward_ep`` on (data 1, model m) for each of ``EP_CASES``:
    the params, x, the weights of the loss, the output, aux and the
    gradient of ``sum(out * wt) + 3 aux`` to the params and x."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import moe as jmoe
    from torch_cluster_workers import EP_CASES
    res = {}
    for m, cap in EP_CASES:
        cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                                  capacity_factor=cap)
        mesh = _auto_mesh((1, m), ("data", "model"))
        p = jmoe.init_moe_block(jax.random.PRNGKey(m), cfg, jnp.float32)
        rng = np.random.default_rng(m)
        x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
        wt = rng.normal(size=x.shape).astype(np.float32)

        def loss(p, xx):
            o, a = jmoe.moe_forward_ep(p, xx, cfg, mesh)
            return jnp.sum(o * wt) + 3.0 * a
        (o, a), g = jax.jit(lambda p, xx: (
            jmoe.moe_forward_ep(p, xx, cfg, mesh),
            jax.grad(loss, argnums=(0, 1))(p, xx)))(p, jnp.asarray(x))
        key = f"{m}/{cap}/"
        res.update({key + "p/" + k: np.asarray(v) for k, v in p.items()})
        res.update({key + "g/" + k: np.asarray(v) for k, v in g[0].items()})
        res.update({key + "x": x, key + "wt": wt, key + "out": np.asarray(o),
                    key + "aux": np.asarray(a), key + "g/x": np.asarray(g[1])})
    np.savez(out, **res)


def cli(out: str, argv) -> None:
    """The reference's ``python -m repro.launch.train`` with ``argv`` on an
    Auto-axis (data, model) mesh: its printed lines."""
    import contextlib
    import io

    from repro.launch import train as jtrain
    jtrain.make_local_mesh = lambda data=1, model=1: _auto_mesh(
        (data, model), ("data", "model"))
    sys.argv = ["train"] + list(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jtrain.main()
    np.savez(out, stdout=np.array(buf.getvalue()))
