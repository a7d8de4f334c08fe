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


# tensor parallelism over ``model`` (``tests/test_torch_cluster_tp.py``):
# reduced() configs with overrides; stablelm-12b's reduced() has 4 heads
# and 2 kv heads, and 6 / 3 puts a member's q heads across a kv group on
# a model axis of 2; whisper-base with an odd vocabulary keeps its
# embedding and lm_head whole
TP_CONFIGS = {
    "gemma": ("gemma-2b", {}),
    "stablelm": ("stablelm-12b", {}),
    "stablelm_6_3": ("stablelm-12b", {"n_heads": 6, "n_kv_heads": 3}),
    "vlm": ("llama-3.2-vision-11b", {}),
    "whisper": ("whisper-base", {}),
    "whisper_odd": ("whisper-base", {"vocab_size": 511}),
    "qwen": ("qwen2-moe-a2.7b", {}),
    # a capacity no choice overflows, beside "qwen" at its own capacity
    # factor (``MOE_SERVE_CASES``, ``MOE_STEP_CASES``): the split heads,
    # MLP and caches on (2, 2) without the routing's drops
    "qwen_nodrop": ("qwen2-moe-a2.7b", {"capacity_factor": 2.0}),
    # the mamba and RG-LRU blocks (``tests/test_torch_cluster_tp_recurrent.
    # py``); mamba_part: d_inner 130, so 2 d_inner divides over model 4 and
    # d_inner does not (the block held whole, in_proj too)
    "mamba": ("falcon-mamba-7b", {}),
    "rgemma": ("recurrentgemma-2b", {}),
    "mamba_part": ("falcon-mamba-7b", {"expand": 1, "d_model": 130}),
}
# serving: (config, mesh (data, model)), the reference jitted on the same
# mesh; a (B, S) prompt, a decode cache of T, DECODE_STEPS teacher-forced
# decode steps
TP_SERVE_CASES = tuple(
    (c, m) for m in ((1, 2), (2, 2))
    for c in ("gemma", "stablelm", "vlm", "whisper",
              "qwen" if m[0] == 1 else "qwen_nodrop")) + (
    ("stablelm", (1, 4)), ("stablelm_6_3", (1, 2)), ("whisper_odd", (1, 2)))
TP_B, TP_S, TP_T, TP_DECODE = 4, 16, 24, 3
# training: (name, config, mode, compression, the port's mesh, the
# reference's mesh); the reference's pssgd and localsgd steps do not
# compile on (data 1, model 2), so those cases hold (1, 2) against its
# (1, 1)
TP_STEP_CASES = (
    ("gemma_none_d2m2", "gemma", "pssgd", "none", (2, 2), (2, 2)),
    ("gemma_int8_d2m2", "gemma", "pssgd", "int8", (2, 2), (2, 2)),
    ("gemma_sign_d2m2", "gemma", "pssgd", "sign", (2, 2), (2, 2)),
    ("gemma_localsgd_d2m2", "gemma", "localsgd", "none", (2, 2), (2, 2)),
    ("gemma_fsdp_d2m2", "gemma", "fsdp", "none", (2, 2), (2, 2)),
    ("gemma_none_m2", "gemma", "pssgd", "none", (1, 2), (1, 1)),
    ("vlm_none_m2", "vlm", "pssgd", "none", (1, 2), (1, 1)),
    ("whisper_odd_none_m2", "whisper_odd", "pssgd", "none", (1, 2),
     (1, 1)),
    ("gemma_fsdp_m2", "gemma", "fsdp", "none", (1, 2), (1, 2)),
    ("stablelm_none_m4", "stablelm", "pssgd", "none", (1, 4), (1, 1)),
    ("stablelm_6_3_none_m2", "stablelm_6_3", "pssgd", "none", (1, 2),
     (1, 1)),
)
TP_STEPS, TP_STEP_BATCH, TP_STEP_SEQ = 2, 8, 16
# the mamba and RG-LRU blocks over model, as TP_STEP_CASES: int8 + EF on
# (2, 2) gathers in_proj whole for the all-reduce (its layout by halves)
TPR_STEP_CASES = tuple(
    (f"{c}_{tag}", c, mode, comp, port, ref)
    for c in ("mamba", "rgemma")
    for tag, mode, comp, port, ref in (
        ("none_d2m2", "pssgd", "none", (2, 2), (2, 2)),
        ("int8_d2m2", "pssgd", "int8", (2, 2), (2, 2)),
        ("none_m2", "pssgd", "none", (1, 2), (1, 1)),
        ("fsdp_m2", "fsdp", "none", (1, 2), (1, 2)))) + (
    ("mamba_none_m4", "mamba", "pssgd", "none", (1, 4), (1, 1)),
    ("mamba_part_none_m4", "mamba_part", "pssgd", "none", (1, 4), (1, 1)))
# serving on (1, 2): the TP_SERVE_CASES steps, then TPR_GREEDY greedy
# decode steps from the prefill's token, and each recurrent state against
# one process's
TPR_SERVE_CASES = (("mamba", (1, 2)), ("rgemma", (1, 2)))
TPR_GREEDY = 6
# MoE over the whole batch (``tests/test_torch_cluster_fsdp.py``): a member
# routes its rows as its part of the global capacity group where the
# reference's step is jitted over the mesh with the data split left to XLA:
# serving on (data 2, model 1 / 2) against the reference's steps on the same
# mesh, teacher-forced then TPR_GREEDY greedy steps; and the fsdp train step
# on (data 2) against the reference's (1, 1) step on the whole batch (its
# pssgd and localsgd steps route a member's rows, as the port's do)
MOE_SERVE_CASES = (("qwen", (2, 1)), ("qwen", (2, 2)))
MOE_STEP_CASES = (("qwen_fsdp_d2", "qwen", "fsdp", "none", (2, 1), (1, 1)),)


def tp_cases(kind: str) -> tuple:
    """The cases of a ``kind``: "train" and "serve" (the transformer
    block), "rtrain" and "rserve" (the recurrent blocks)."""
    return {"train": TP_STEP_CASES, "serve": TP_SERVE_CASES,
            "rtrain": TPR_STEP_CASES, "rserve": TPR_SERVE_CASES,
            "mtrain": MOE_STEP_CASES, "mserve": MOE_SERVE_CASES}[kind]


def tp_cfg(name: str):
    import dataclasses

    from repro_torch.configs import get_config
    arch, kw = TP_CONFIGS[name]
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _extras(cfg, b: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"vision_embeds": rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)}
    if cfg.family == "audio":
        return {"audio_embeds": rng.standard_normal(
            (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)}
    return {}


def tp_batches(cfg) -> list:
    """The global train batches every member draws, as numpy (random
    vision / audio embeddings for the vlm and audio families)."""
    from repro_torch.data import SyntheticLMDataset
    ds = SyntheticLMDataset(cfg.vocab_size, TP_STEP_SEQ, 512, seed=0)
    return [dict(ds.get(np.arange(TP_STEP_BATCH) + TP_STEP_BATCH * i),
                 **_extras(cfg, TP_STEP_BATCH, 10 + i))
            for i in range(TP_STEPS)]


def tp_serve_inputs(cfg) -> dict:
    """The prompt (and embeddings) and the decode tokens, as numpy."""
    rng = np.random.default_rng(5)
    return dict(tokens=rng.integers(0, cfg.vocab_size, (TP_B, TP_S)).astype(
        np.int32), steps=rng.integers(0, cfg.vocab_size,
                                      (TP_B, TP_DECODE)).astype(np.int32),
        **_extras(cfg, TP_B, 7))


def tp_key(name, mesh) -> str:
    return f"{name}/{mesh[0]}x{mesh[1]}"


def _tp_gather_tree(tree, specs, mesh):
    from repro_torch.launch import sharding
    from repro_torch.launch.specs import tree_map
    return tree_map(lambda x, sp: sharding.gather(x, sp, mesh).numpy(),
                    tree, specs)


def _flat_tree(tree, prefix: str, out: dict) -> dict:
    """A cache pytree's leaves keyed by their ``/``-joined paths."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_tree(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat_tree(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = tree
    return out


def _gates(params: dict) -> dict:
    """The vlm's cross gates at 0.5 (they start at 0, which would hide the
    cross layers), as ``torch_tp_jax._gates`` sets the reference's."""
    for k in params:
        if k.split("/")[-1] in ("gate_attn", "gate_mlp"):
            params[k] = torch.full_like(params[k], 0.5)
    return params


def _tp_serve(name, mesh, recurrent: bool = False,
              greedy: bool = False) -> dict:
    """Prefill, then TP_DECODE teacher-forced decode steps, on this
    member's blocks and rows: the logits and caches gathered whole;
    ``greedy`` adds TPR_GREEDY greedy steps from the prefill
    (``greedy/mesh``, ``greedy/logits``), ``recurrent`` ``_tpr_checks``."""
    from repro_torch import random as trandom
    from repro_torch.launch import serve, sharding, specs, steps
    from repro_torch.models import tp
    from repro_torch.models import transformer as tf
    cfg = tp_cfg(name)
    params = _gates(tf.init_params(cfg, trandom.PRNGKey(1)))
    held = steps.held_specs(cfg, steps.TrainPolicy(), mesh)["params"]
    params = {k: sharding.shard(v, held[k], mesh) for k, v in params.items()}
    inp = tp_serve_inputs(cfg)
    batch = {k: torch.as_tensor(v) for k, v in inp.items() if k != "steps"}
    bsp = sharding.batch_shardings(batch, mesh)
    mine = {k: sharding.shard(v, bsp[k], mesh) for k, v in batch.items()}
    rows = sharding.shard(torch.as_tensor(inp["steps"]), bsp["tokens"], mesh)
    dp = bsp["tokens"][0]
    lsp = (dp, None, "model" if cfg.vocab_size % mesh.n("model") == 0
           else None)
    res = {}
    with torch.no_grad():
        logits_pf, pf = steps.make_prefill_step(
            cfg, mesh=mesh, global_batch=TP_B)(params, mine)
        res["prefill/logits"] = sharding.gather(logits_pf, lsp,
                                                mesh).numpy()

        def cache_specs(length):
            """The held spec of each leaf of a (TP_B, length) cache."""
            glob = tf.init_decode_cache(cfg, TP_B, length, device="meta")
            return specs.held_cache_specs(cfg, glob, mesh, TP_B)[1]
        pf_sp = cache_specs(TP_S)
        for k, v in _flat_tree(_tp_gather_tree(pf, pf_sp, mesh), "",
                               {}).items():
            res["prefill/cache/" + k] = v
        b_local = rows.shape[0]
        cache = tf.init_decode_cache(cfg, b_local, TP_T,
                                     model=mesh.n("model"))
        cache = serve._load_prefill(cfg, cache, pf, TP_S)
        first = cache
        decode = steps.make_decode_step(cfg, circular=False, mesh=mesh,
                                        global_batch=TP_B)
        states = [pf]
        for i in range(TP_DECODE):
            logits, cache = decode(params, cache, rows[:, i:i + 1], TP_S + i)
            res[f"decode/{i}/logits"] = sharding.gather(logits, lsp,
                                                        mesh).numpy()
            states.append(cache)
        d_sp = cache_specs(TP_T)
        for k, v in _flat_tree(_tp_gather_tree(cache, d_sp, mesh), "",
                               {}).items():
            res["decode/cache/" + k] = v
        if greedy:   # from the prefill, the tokens and logits gathered
            toks, outs = _greedy(cfg, decode, params, logits_pf, first)
            res["greedy/mesh"] = sharding.gather(toks, lsp[:1] + (None,),
                                                 mesh).numpy()
            res["greedy/logits"] = np.stack(
                [sharding.gather(x, lsp, mesh).numpy() for x in outs])
        if recurrent:
            res.update(_tpr_checks(cfg, params, held, mine, rows, states,
                                   (pf_sp, d_sp), mesh))
    tp.set_model_mesh(None)
    return res


def _greedy(cfg, step, params, logits, cache):
    """TPR_GREEDY greedy decode steps through ``step`` from a prefill's
    ``logits`` and ``cache``: the tokens and each step's logits."""
    from repro_torch.models import tp
    toks, outs = [], []
    for i in range(TPR_GREEDY):
        tok = tp.gather_last(logits[:, -1, :], cfg.vocab_size).argmax(
            dim=-1).to(torch.int32)[:, None]
        toks.append(tok)
        logits, cache = step(params, cache, tok, TP_S + i)
        outs.append(logits)
    return torch.cat(toks, dim=1), outs


def _with_drops(fn, *args) -> dict:
    """``fn(*args)``'s results and ``drops``: this member's choices past
    their expert's capacity over every MoE layer it ran."""
    from repro_torch.models import moe
    route, drops = moe.route, []

    def counted(*a, **kw):
        r = route(*a, **kw)
        drops.append(int(r.overflow.sum()))
        return r
    moe.route = counted
    try:
        res = fn(*args)
    finally:
        moe.route = route
    res["drops"] = np.int64(sum(drops))
    return res


def _tpr_checks(cfg, params, held, mine, rows, states, sps, mesh) -> dict:
    """Against one process on the member's rows (the params gathered
    whole, no mesh named): the largest difference of each state after the
    prefill and each decode step from this member's block of one
    process's (``state_err/...``); then TPR_GREEDY greedy decode steps
    from the prefill (``greedy/one``, the tokens)."""
    from repro_torch.launch import serve, sharding
    from repro_torch.launch.specs import tree_map
    from repro_torch.models import tp
    from repro_torch.models import transformer as tf
    whole = {k: sharding.gather(v, held[k], mesh) for k, v in params.items()}
    res = {}
    tp.set_model_mesh(None)
    logits, pf = tf.prefill(whole, cfg, mine["tokens"])
    cache = serve._load_prefill(cfg, tf.init_decode_cache(
        cfg, rows.shape[0], TP_T), pf, TP_S)
    one = [pf]
    for i in range(TP_DECODE):
        _, cache = tf.decode_step(whole, cfg, cache, rows[:, i:i + 1],
                                  TP_S + i)
        one.append(cache)
    for i, (got, want) in enumerate(zip(states, one)):
        sp = sps[min(i, 1)]
        err = _flat_tree(tree_map(lambda g, w, s: float(
            (g - sharding.shard(w, s, mesh)).abs().max()), got, want, sp),
            "", {})
        tag = "prefill" if i == 0 else f"decode/{i - 1}"
        for k, v in err.items():
            res[f"state_err/{tag}/{k}"] = np.float64(v)
    one_cache = serve._load_prefill(cfg, tf.init_decode_cache(
        cfg, rows.shape[0], TP_T), pf, TP_S)
    toks, _ = _greedy(cfg, lambda p, c, t, pos: tf.decode_step(
        p, cfg, c, t, pos), whole, logits, one_cache)
    res["greedy/one"] = toks.numpy()
    return res


def _tp_step(case, mesh) -> dict:
    """TP_STEPS train steps from this member's initial state (the
    reference's unjitted init, bit for bit): the losses and the gathered
    final params."""
    from repro_torch import random as trandom
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import tp
    name, cname, mode, comp, _, _ = next(
        c for c in TP_STEP_CASES + TPR_STEP_CASES + MOE_STEP_CASES
        if c[0] == case)
    cfg = tp_cfg(cname)
    pol = tsteps.TrainPolicy(mode=mode, compression=comp,
                             error_feedback=comp in ("int8", "sign"),
                             **STEP_POLICY)
    state = tsteps.make_init_fn(cfg, pol, mesh)(trandom.PRNGKey(0))
    state["params"] = _gates(state["params"])
    step = tsteps.make_train_step(cfg, pol, mesh)
    res = {}
    for i, b in enumerate(tp_batches(cfg)):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        res[f"loss/{i}"] = np.float64(m["loss"])
    res.update({"final/" + k: v.numpy() for k, v in tsteps.gather_params(
        cfg, pol, mesh, state["params"]).items()})
    res.update({"local/" + k: v.numpy() for k, v in
                state["params"].items()})
    tp.set_model_mesh(None)
    return res


def tp_members(rank: int, mesh_shape, kinds) -> dict:
    """Every case of ``kinds`` (a kind of ``tp_cases`` or a tuple of them)
    of the tensor-parallel tests on ``mesh_shape``, on this member."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(mesh_shape, ("data", "model"))
    res = {}
    for kind in (kinds,) if isinstance(kinds, str) else kinds:
        if kind in ("serve", "rserve", "mserve"):
            for name, m in tp_cases(kind):
                if tuple(m) == tuple(mesh_shape):
                    out = (_with_drops(_tp_serve, name, mesh, False, True)
                           if kind == "mserve" else
                           _tp_serve(name, mesh, kind == "rserve",
                                     kind == "rserve"))
                    for k, v in out.items():
                        res[f"serve/{tp_key(name, m)}/{k}"] = v
            continue
        for case in tp_cases(kind):
            if tuple(case[4]) == tuple(mesh_shape):
                out = (_with_drops(_tp_step, case[0], mesh)
                       if kind == "mtrain" else _tp_step(case[0], mesh))
                for k, v in out.items():
                    res[f"step/{case[0]}/{k}"] = v
    return res


LAYOUT_CONFIGS = ("mamba", "rgemma", "mamba_part")


def recurrent_layout(rank: int, mesh_shape) -> dict:
    """Each ``LAYOUT_CONFIGS`` config's params (the reference's unjitted
    init, bit for bit) cut to this member's blocks (``held_specs``) and
    gathered whole again."""
    from repro_torch import random as trandom
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf
    mesh = make_mesh(mesh_shape, ("data", "model"))
    res = {}
    for name in LAYOUT_CONFIGS:
        cfg = tp_cfg(name)
        held = steps.held_specs(cfg, steps.TrainPolicy(), mesh)["params"]
        for k, v in tf.init_params(cfg, trandom.PRNGKey(0)).items():
            block = sharding.shard(v, held[k], mesh)
            res[f"{name}/local/{k}"] = block.numpy()
            res[f"{name}/gather/{k}"] = sharding.gather(block, held[k],
                                                        mesh).numpy()
    return res


def cli_runs(rank: int, argvs) -> list:
    """``python -m repro_torch.launch.train`` with each of ``argvs`` in
    turn on this member: what it printed."""
    import contextlib
    import io

    from repro_torch.launch import train as ttrain
    out = []
    for argv in argvs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ttrain.main(list(argv), device="cpu")
        out.append(buf.getvalue())
    return out


# fsdp a layer at a time (``tests/test_torch_cluster_fsdp.py``): each
# family's reduced() config (recurrentgemma-2b with a fourth layer, so that
# its ``rest`` runs), remat on and off, against the whole-gather step
FSDP_CONFIGS = {"dense": ("gemma-2b", {}),
                "ssm": ("falcon-mamba-7b", {}),
                "hybrid": ("recurrentgemma-2b", {"n_layers": 4}),
                "vlm": ("llama-3.2-vision-11b", {}),
                "audio": ("whisper-base", {})}
FSDP_MESHES = ((2, 1), (2, 2))


def fsdp_cfg(name: str):
    import dataclasses

    from repro_torch.configs import get_config
    arch, kw = FSDP_CONFIGS[name]
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def whole_gather_step(cfg, policy, mesh):
    """The fsdp step that gathers every leaf whole over the data axes for
    the step and reduce-scatters the whole gradient tree after it, built
    from ``launch/steps.py``'s pieces (the step before it held one layer
    at a time)."""
    from repro_torch.core.collectives import pmean
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as ts
    from repro_torch.launch.mesh import data_axes
    from repro_torch.optim.optimizers import apply_updates
    from repro_torch.optim.schedules import get_schedule
    ts.set_model_mesh(mesh)
    dp, dpe = data_axes(mesh), sharding.data_entry(mesh)
    schedule = get_schedule(cfg.lr_schedule, policy.lr, policy.total_steps)
    opt_fn = apply_updates(policy.optimizer)
    dspecs = {k: tuple(a if a == dpe else None for a in sp) for k, sp in
              ts.held_specs(cfg, policy, mesh)["params"].items()}

    def train_step(state, batch):
        params = state["params"]
        full = {k: sharding.gather(p, dspecs[k], mesh)
                for k, p in params.items()}
        loss, grads = ts._value_and_grad(
            cfg, policy, full, ts.local_batch(batch, mesh, divisible=False))
        del full
        for k, g in grads.items():
            grads[k] = (ts._reduce_scatter_mean(g, dspecs[k], mesh, dpe)
                        if dpe in dspecs[k] and mesh.n(dp) > 1
                        else pmean(g, mesh, dp))
        opt = ts._apply(opt_fn, params, grads, state["opt"],
                        schedule(state["step"]))
        return (dict(state, opt=opt, step=state["step"] + 1),
                {"loss": pmean(loss, mesh, dp)})
    return train_step


def fsdp_layers(rank: int, mesh_shape) -> dict:
    """Every ``FSDP_CONFIGS`` config, one step of ``tp_batches``' first
    batch on ``mesh_shape`` from the same initial state through
    ``steps._make_fsdp_step``, remat on and off (``{name}/{remat}/``), and
    through ``whole_gather_step`` (``{name}/whole/``; remat changes no
    number): the loss, this member's params and moments after the step,
    and the bytes the step sent by op."""
    from repro_torch import random as trandom
    from repro_torch.core import collectives as coll
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tp
    mesh = make_mesh(mesh_shape, ("data", "model"))
    res = {}
    for name in FSDP_CONFIGS:
        cfg = fsdp_cfg(name)
        batch = {k: torch.as_tensor(v) for k, v in tp_batches(cfg)[0].items()}
        init = None
        for key, make, remat in ((f"{name}/1/", tsteps.make_train_step, True),
                                 (f"{name}/0/", tsteps.make_train_step,
                                  False),
                                 (f"{name}/whole/", whole_gather_step,
                                  False)):
            pol = tsteps.TrainPolicy(mode="fsdp", **dict(STEP_POLICY,
                                                          remat=remat))
            if init is None:
                init = tsteps.make_init_fn(cfg, pol, mesh)(
                    trandom.PRNGKey(0))
                init["params"] = _gates(init["params"])
            coll.WIRE.reset()
            state, m = make(cfg, pol, mesh)(tsteps.copy_state(init), batch)
            res[key + "loss"] = m["loss"].numpy()
            res.update({key + k: v for k, v in flat_state(state).items()})
            for op, nbytes in coll.WIRE.bytes.items():
                res[f"{key}wire/{op}"] = np.int64(nbytes)
            tp.set_model_mesh(None)
    return res


def fsdp_members(rank: int, mesh_shape) -> dict:
    """``fsdp_layers`` on this member, and the MoE cases of
    ``MOE_SERVE_CASES`` / ``MOE_STEP_CASES`` on ``mesh_shape``."""
    res = {"layers": fsdp_layers(rank, mesh_shape)}
    res.update(tp_members(rank, mesh_shape, ("mserve", "mtrain")))
    return res
