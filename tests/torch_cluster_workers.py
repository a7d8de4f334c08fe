"""The port's side of ``tests/test_torch_cluster_*.py``: functions that
``repro_torch.launch.members.spawn`` runs in each member process (one
thread, ``gloo``). They import only torch, numpy and ``repro_torch``, and
return numpy arrays keyed as the reference's ``.npz``
(``torch_cluster_jax.py``) is.
"""
from __future__ import annotations

import numpy as np
import torch

# the cases of the collectives file: meshes, methods, leaves
COLL_MESHES = {"pod2_data2": ((2, 2), ("pod", "data")),
               "data4": ((4,), ("data",))}
COLL_METHODS = ("none", "bf16", "int8", "sign")
COLL_SHAPES = ((40, 17), (70_000,), (301, 233), (18, 64, 128))
RING_WEIGHTS = (1.0 / 3.0, 0.2, 0.5)


def member_leaf(shape, seed: int, rank: int):
    """Member ``rank``'s gradient and error leaves (exact zeros in both)."""
    rng = np.random.default_rng([seed, rank])
    g = rng.standard_normal(shape).astype(np.float32)
    e = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    g.reshape(-1)[::7] = 0.0
    e.reshape(-1)[::7] = 0.0
    return g, e


def collectives(rank: int) -> dict:
    """This member's ``hierarchical_allreduce`` outputs for every case of
    ``torch_cluster_jax.collectives``, and the bytes it sent."""
    from repro_torch.core import collectives as tc
    from repro_torch.launch.mesh import make_mesh
    res = {}
    for mname, (shape, names) in COLL_MESHES.items():
        mesh = make_mesh(shape, names)
        for i, lshape in enumerate(COLL_SHAPES):
            g, e = member_leaf(lshape, i, rank)
            for method in COLL_METHODS:
                for with_e in (True, False):
                    tc.WIRE.reset()
                    o, en = tc.hierarchical_allreduce(
                        {"w": torch.as_tensor(g)}, names, method,
                        {"w": torch.as_tensor(e)} if with_e else None,
                        mesh=mesh)
                    key = f"{mname}/{method}/{int(with_e)}/{i}"
                    res[key + "/out"] = o["w"].numpy()
                    if with_e:
                        res[key + "/err"] = en["w"].numpy()
                    res[key + "/wire"] = np.int64(tc.WIRE.total)
    return res


def ring(rank: int) -> dict:
    from repro_torch.fl.decentralized import ring_gossip_shard_map
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4,), ("data",))
    x = np.random.default_rng(7).standard_normal((4, 3, 5000)).astype(
        np.float32)[rank:rank + 1]
    res = {}
    for i, w in enumerate(RING_WEIGHTS):
        got = ring_gossip_shard_map(mesh, "data", w)(
            {"f32": torch.as_tensor(x),
             "bf16": torch.as_tensor(x).to(torch.bfloat16)})
        res[f"{i}/f32"] = got["f32"].numpy()
        res[f"{i}/bf16"] = got["bf16"].view(torch.int16).numpy()
    return res


def mesh_rules(rank: int) -> dict:
    """Row-major coordinates, the per-axis groups and meshes whose size
    differs from the group's (one member among them), on 4 members."""
    import torch.distributed as dist

    from repro_torch.core.collectives import all_gather
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    mesh = make_mesh((2, 2), ("pod", "data"))
    res = {"coords": np.array([mesh.coords["pod"], mesh.coords["data"]]),
           "pod_ranks": all_gather(torch.tensor(rank), mesh, "pod").numpy(),
           "data_ranks": all_gather(torch.tensor(rank), mesh,
                                    "data").numpy(),
           "both_ranks": all_gather(torch.tensor(rank), mesh,
                                    ("pod", "data")).numpy()}
    for shape in ((1, 1), (2, 1), (8, 1)):
        try:
            make_local_mesh(*shape)
        except ValueError as exc:
            res[f"raised_{shape[0]}"] = np.array("process group" in str(exc))
    res["world"] = np.int64(dist.get_world_size())
    return res


# the trainer's cases: (name, arch, mode, compression, mesh shape, axes,
# sync_pods). The reference's localsgd stops XLA on the CPU when it syncs
# pods (its bf16 ``pmean`` over "pod" inside the step: "Invalid binary
# instruction opcode copy"), so its case runs without the sync and the sync
# is held apart (``pod_sync``).
STEP_CASES = (
    ("pssgd_int8_d2", "gemma-2b", "pssgd", "int8", (2, 1),
     ("data", "model"), True),
    ("pssgd_sign_p2d2", "gemma-2b", "pssgd", "sign", (2, 2, 1),
     ("pod", "data", "model"), True),
    ("localsgd_int8_p2d2", "gemma-2b", "localsgd", "int8", (2, 2, 1),
     ("pod", "data", "model"), False),
    ("fsdp_d2", "gemma-2b", "fsdp", "none", (2, 1), ("data", "model"), True),
    ("pssgd_int8_moe_m2", "qwen2-moe-a2.7b", "pssgd", "int8", (1, 2),
     ("data", "model"), True),
)
STEP_POLICY = dict(local_steps=2, lr=3e-3, optimizer="adamw", total_steps=6,
                   remat=False)
STEP_SEQ, STEP_BATCH, STEPS = 32, 8, 3


def step_batches(vocab: int):
    """The global batches every member draws, as numpy."""
    from repro_torch.data import SyntheticLMDataset
    ds = SyntheticLMDataset(vocab, STEP_SEQ, 512, seed=0)
    return [ds.get(np.arange(STEP_BATCH) + STEP_BATCH * i)
            for i in range(STEPS)]


def flat_state(state) -> dict:
    """A port state -> flat numpy keys (``params/<k>``, ``opt/m/<k>``...)."""
    out = {"step": state["step"].numpy(),
           "opt/step": state["opt"].step.numpy()}
    for name, tree in (("params", state["params"]), ("opt/m", state["opt"].m),
                       ("opt/v", state["opt"].v), ("ef", state.get("ef"))):
        for k, v in (tree or {}).items():
            out[f"{name}/{k}"] = v.numpy()
    return out


def unflat_state(d: dict, prefix: str):
    from repro_torch.optim.optimizers import OptState

    def tree(name):
        keys = [k for k in d if k.startswith(f"{prefix}{name}/")]
        if not keys:
            return None
        return {k[len(prefix) + len(name) + 1:]: torch.as_tensor(d[k])
                for k in keys}
    out = {"params": tree("params"),
           "opt": OptState(torch.as_tensor(d[prefix + "opt/step"]),
                           tree("opt/m"), tree("opt/v")),
           "step": torch.as_tensor(d[prefix + "step"])}
    if tree("ef") is not None:
        out["ef"] = tree("ef")
    return out


def _step_case(case: str):
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as tsteps
    name, arch, mode, comp, shape, axes, sync = next(
        c for c in STEP_CASES if c[0] == case)
    pol = tsteps.TrainPolicy(mode=mode, compression=comp,
                             error_feedback=comp in ("int8", "sign"),
                             sync_pods=sync, **STEP_POLICY)
    return get_config(arch).reduced(), pol, shape, axes


def steps(rank: int, case: str, ref_path: str) -> dict:
    """One case of ``STEP_CASES`` from the reference's jitted initial
    state, cut to this member: the losses, this member's params after each
    step, and the gathered final state."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import make_mesh
    cfg, pol, shape, axes = _step_case(case)
    mesh = make_mesh(shape, axes)
    with np.load(ref_path) as f:
        full = unflat_state({k: f[k] for k in f.files
                             if k.startswith(case + "/init/")},
                            case + "/init/")
    state = tsteps.shard_state(cfg, pol, mesh, tsteps.copy_state(full))
    step = tsteps.make_train_step(cfg, pol, mesh)
    res = {}
    for i, b in enumerate(step_batches(cfg.vocab_size)):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        res[f"loss/{i}"] = np.float64(m["loss"])
        for k, v in state["params"].items():
            res[f"local/{i}/{k}"] = v.numpy()
    res["held_bytes"] = np.int64(sum(
        v.numel() * v.element_size() for v in state["params"].values()))
    for k, v in flat_state(tsteps.gather_state(cfg, pol, mesh,
                                               state)).items():
        if not k.startswith("opt/") or k == "opt/step":
            res["final/" + k] = v
    if "ef" in state:   # the first step again, for its EF
        st, _ = step(tsteps.shard_state(cfg, pol, mesh, full),
                     {k: torch.as_tensor(v) for k, v in step_batches(
                         cfg.vocab_size)[0].items()})
        res.update({f"ef0/{k}": v for k, v in flat_state(
            tsteps.gather_state(cfg, pol, mesh, st)).items()
            if k.startswith("ef/")})
    return res


POD_SYNC_SHAPE = (2, 3000)


def pod_sync(rank: int, ref_path: str) -> dict:
    """The pod sync of Alg. 9 on 2 members: the port's bf16 ``pmean`` of a
    float32 leaf (a wide range of magnitudes), and localsgd int8 + EF on
    (pod 2, data 2) from the reference's state: one step with the sync
    against one without it followed by that sync."""
    from repro_torch.core.collectives import pmean
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import make_mesh
    res = {}
    cfg, pol, shape, axes = _step_case("localsgd_int8_p2d2")
    mesh = make_mesh(shape, axes)
    with np.load(ref_path) as f:
        x = torch.as_tensor(f["pod_sync/x"][mesh.coords["pod"]])
        full = unflat_state({k: f[k] for k in f.files
                             if k.startswith("localsgd_int8_p2d2/init/")},
                            "localsgd_int8_p2d2/init/")
    pods = make_mesh((2, 2, 1), ("pod", "data", "model"))
    res["x"] = pmean(x.to(torch.bfloat16), pods, "pod").float().numpy()
    b = {k: torch.as_tensor(v) for k, v in step_batches(
        cfg.vocab_size)[0].items()}
    synced = tsteps.TrainPolicy(**{**pol.__dict__, "sync_pods": True})
    a, _ = tsteps.make_train_step(cfg, synced, mesh)(
        tsteps.shard_state(cfg, synced, mesh, full), b)
    c, _ = tsteps.make_train_step(cfg, pol, mesh)(
        tsteps.shard_state(cfg, pol, mesh, full), b)
    res["off"] = np.int64(sum(int((a["params"][k] != pmean(
        v.to(torch.bfloat16), pods, "pod").to(v.dtype)).sum())
        for k, v in c["params"].items()))
    res["changed"] = np.int64(sum(int((a["params"][k] != v).sum())
                                  for k, v in c["params"].items()))
    return res


# moe_forward_ep: (model members, capacity factor) of qwen2-moe-a2.7b
# reduced(); 1.0 keeps every choice here, 0.5 drops some
EP_CASES = ((2, 1.0), (4, 1.0), (2, 0.5), (4, 0.5))


def ep_cfg(cap: float):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                               capacity_factor=cap)


def moe_ep(rank: int, ref_path: str, m: int, cap: float) -> dict:
    """``moe_forward_ep`` on (data 1, model ``m``) with the full params on
    every member: the output, aux and the gradient of ``sum(out * wt) + 3
    aux`` to the params (the expert stacks' outside this member's block are
    zero) and to x."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as tmoe
    cfg = ep_cfg(cap)
    mesh = make_mesh((1, m), ("data", "model"))
    key = f"{m}/{cap}/"
    with np.load(ref_path) as f:
        p = {k[len(key) + 2:]: torch.as_tensor(f[k]) for k in f.files
             if k.startswith(key + "p/")}
        x, wt = (torch.as_tensor(f[key + n]) for n in ("x", "wt"))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xx = x.clone().requires_grad_()
    out, aux = tmoe.moe_forward_ep(leaves, xx, cfg, mesh)
    loss = (out * wt).sum() + 3.0 * aux
    grads = torch.autograd.grad(loss, list(leaves.values()) + [xx])
    res = {"out": out.detach().numpy(), "aux": aux.detach().numpy()}
    for k, g in zip(list(leaves) + ["x"], grads):
        res["g/" + k] = g.numpy()
    return res


# an expert stack (experts, d, d_ff) split over model on (data 2, model 2)
EXPERT_LEAF = (4, 128, 160)


def expert_mean(rank: int) -> dict:
    """``steps._allreduce_leaf`` of an expert stack's block over ``data``
    against the mean of the gathered leaf cut again, output and error, for
    the plain mean (the block as it is) and bf16 (gathered: the block is
    under ``min_size``, the leaf is not)."""
    from repro_torch.core.collectives import hierarchical_allreduce
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"))
    spec = ("model", None, None)
    g, e = (sharding.shard(torch.as_tensor(x), spec, mesh) for x in
            member_leaf(EXPERT_LEAF, 25, mesh.index("data")))
    res = {}
    for method in ("none", "bf16"):
        pol = steps.TrainPolicy(compression=method, error_feedback=True)
        out, err = steps._allreduce_leaf("w", g, e, ("data",), pol, mesh,
                                         spec)
        whole, werr = hierarchical_allreduce(
            {"w": sharding.gather(g, spec, mesh)}, ("data",), method,
            {"w": sharding.gather(e, spec, mesh)}, mesh=mesh)
        res[method] = (out.numpy(), err.numpy(),
                       sharding.shard(whole["w"], spec, mesh).numpy(),
                       sharding.shard(werr["w"], spec, mesh).numpy())
    return res


def linear_loss(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), {}


def sweep(rank: int, args_path: str) -> dict:
    """``run_sweep(devices=<world>)`` of the grid in ``args_path`` (the
    port's ``SimConfig``, params, batches and keyword arguments): every
    member's whole result."""
    import torch.distributed as dist

    from repro_torch.fl import runtime as trt
    cfg, params, batches, kw = torch.load(args_path, weights_only=False)
    out = trt.run_sweep(cfg, linear_loss, params, batches,
                        devices=dist.get_world_size(), device="cpu", **kw)
    return {f"{key}/{f}": getattr(logs, f) for key, logs in out.items()
            for f in trt._LOG_FIELDS}


def cli(rank: int, argv) -> dict:
    """``python -m repro_torch.launch.train`` with ``argv`` on this member:
    what it printed and the bytes it sent."""
    import contextlib
    import io

    from repro_torch.core import collectives as tc
    from repro_torch.launch import train as ttrain
    buf = io.StringIO()
    tc.WIRE.reset()
    with contextlib.redirect_stdout(buf):
        ttrain.main(list(argv), device="cpu")
    return {"stdout": buf.getvalue(), "wire": tc.WIRE.total}
