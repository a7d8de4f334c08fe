"""The dry-run: every (arch x shape) case on the production meshes, one
member's step under fake tensors, the port of ``repro/launch/dryrun.py``.

For a case it builds **one member's** train, prefill or decode step
(``launch/specs.py``) on a mesh bound to a fake process group of the
mesh's size (rank 0; the fake group moves nothing), and runs it once under
``FakeTensorMode``: nothing is allocated and nothing is computed. The op
account (``launch/hlo_analysis.py``) records the member's bytes, peak,
flops and wire, in the reference's record layout; the op log goes beside
the record (``.ops.jsonl.gz``), for ``launch/reanalyze.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --mesh-shape 256x1

Fake tensors live on ``--device`` (default ``cuda``, as the card's step
would run; a machine without CUDA passes ``--device cpu``). ``--arch``
without ``--shape`` runs the arch's four shapes; ``--batch`` and
``--seq-len`` replace them by one train shape of that size; ``--reduced``
takes the config's ``reduced()``, and ``--dtype`` and ``--depth`` replace
its dtype and layer count; ``--no-remat`` keeps each layer's activations
(the trainer's ``--reduced`` setting), where a policy recomputes them. A
case that fails is a record with ``status`` "fail" and its error. The CLI
exits 1 if any case failed. Run it in a process of its own: it holds the
process's default group, a fake one.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import importlib
import json
import math
import os
import time
import traceback
from typing import Optional

import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import collectives as coll
from repro_torch.launch.hlo_analysis import (OpLog, collective_stats,
                                             hlo_compute_stats,
                                             total_collective_bytes)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import build_case, state_bytes
from repro_torch.launch.steps import TrainPolicy
from repro_torch.models import layers, xla_math
from repro_torch.models.tp import set_model_mesh

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "experiments", "artifacts_torch")

# roofline constants of one NVIDIA H100 80GB HBM3 at its 700.00 W limit
# (NVIDIA's data sheet, SXM part, dense rates)
PEAK_FLOPS_BF16 = 989e12       # per card
PEAK_FLOPS_F32 = 67e12         # per card, outside the tensor cores
HBM_BW = 3.35e12               # bytes/s per card

POLICIES = {
    "baseline": TrainPolicy(mode="pssgd", compression="none"),
    "bf16": TrainPolicy(mode="pssgd", compression="bf16"),
    "int8_ef": TrainPolicy(mode="pssgd", compression="int8",
                           error_feedback=True),
    "sign_ef": TrainPolicy(mode="pssgd", compression="sign",
                           error_feedback=True),
    "localsgd_h4": TrainPolicy(mode="localsgd", compression="none",
                               local_steps=4),
    "localsgd_int8": TrainPolicy(mode="localsgd", compression="int8",
                                 error_feedback=True, local_steps=4),
    "fsdp": TrainPolicy(mode="fsdp", compression="none",
                        opt_state_dtype="bfloat16"),
}


def policy_from_name(name: str) -> TrainPolicy:
    return POLICIES[name]


def mesh_of(mesh_shape: Optional[str], multi_pod: bool = False):
    """(dims, axes, name) of ``--mesh-shape`` ("AxB" over data x model) or
    of the production mesh."""
    if mesh_shape:
        return (tuple(int(x) for x in mesh_shape.split("x")),
                ("data", "model"), mesh_shape)
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model"), "2x16x16"
    return (16, 16), ("data", "model"), "16x16"


def reset_globals() -> None:
    """The model's cached constants (a case's are fake tensors of its
    mode, which no other case and no real step may take) and the model
    axis's mesh a case named."""
    layers.rope_frequencies.cache_clear()
    xla_math.const64.cache_clear()
    set_model_mesh(None)


def analyze(cfg, shape: ShapeSpec, mesh, policy: TrainPolicy,
            device="cuda") -> tuple:
    """One member's step of the case under fake tensors: (its record's
    ``memory``, ``cost``, ``collectives`` and ``parsed``, the op log)."""
    fake = FakeTensorMode()
    ops = OpLog()
    coll.WIRE.record_calls()
    reset_globals()
    try:
        fn, args, _ = build_case(cfg, shape, mesh, policy, fake, device)
        with fake:
            arg_bytes = state_bytes(args)
            ops.track(args)
            with ops:
                out = fn(*args)
            out_bytes = state_bytes(out)
            del fn, args, out
        log = ops.log + [["coll", k, b, n] for k, b, n in coll.WIRE.calls]
    finally:
        coll.WIRE.record_calls(False)
        reset_globals()
    parsed = hlo_compute_stats(log)
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": ops.peak - arg_bytes, "peak_bytes": ops.peak}
    cost = {"flops": parsed["flops"], "bytes accessed": parsed["hbm_bytes"]}
    return memory, cost, collective_stats(log), parsed, log


def kernel_counters() -> tuple:
    """The port's six kernel wrappers, each with its launch count (0 on
    this path: no kernel lies on a step of the trainer or of the serving
    path)."""
    from repro_torch.kernels import qsgd, sign_ef, topk_mask
    return (topk_mask.topk_rows, qsgd.qsgd_rows, sign_ef.sign_ef_rows,
            topk_mask.block_topk_tiles, qsgd.qsgd_tiles,
            sign_ef.sign_ef_tiles)


def bind(world: int) -> None:
    """This process's default group: a fake one of ``world`` members,
    made anew when the size changes."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    # registers the "fake" backend (the same module on torch 2.11 and 2.13)
    importlib.import_module("torch.testing._internal.distributed.fake_pg")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)


def release() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def run_case(arch: str, shape_name, *, multi_pod: bool = False,
             policy_name: str = "baseline", mesh_shape: str | None = None,
             device="cuda", cfg=None, out_dir: str | None = None,
             remat: bool = True) -> dict:
    """The record of one case: ``shape_name`` a name of ``SHAPES`` or a
    ``ShapeSpec``, ``cfg`` in place of ``arch``'s config where given; with
    ``out_dir`` the op log is saved there; ``remat`` False trains without
    recomputing each layer."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    dims, axes, mesh_name = mesh_of(mesh_shape, multi_pod)
    policy = policy_from_name(policy_name)
    # llama3-405b cannot replicate params over the data axis -> FSDP mode
    if shape.kind == "train" and arch == "llama3-405b" \
            and policy.mode == "pssgd" and policy_name == "baseline":
        policy = policy_from_name("fsdp")
        policy_name = "fsdp(auto:405b)"
    if not remat:
        policy = dataclasses.replace(policy, remat=False)
        policy_name += "(no-remat)"
    record = {
        "arch": arch, "shape": shape.name, "policy": policy_name,
        "mesh": mesh_name, "n_devices": math.prod(dims),
        "model_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "status": "ok", "device": str(device), "dtype": cfg.dtype,
        "n_layers": cfg.n_layers,
    }
    for f in kernel_counters():
        f.launches = 0
    try:
        t0 = time.time()
        bind(math.prod(dims))
        mesh = make_mesh(dims, axes)
        memory, cost, colls, parsed, log = analyze(cfg, shape, mesh, policy,
                                                   device)
        record["trace_s"] = round(time.time() - t0, 1)
        record.update(memory=memory, cost=cost, collectives=colls,
                      parsed=parsed, ops=len(log))
        if out_dir:
            save_log(record, log, out_dir)
        print(f"[{arch} x {shape.name} x {mesh_name} {policy_name}] "
              f"trace {record['trace_s']}s flops={cost['flops']:.3e} "
              f"coll_bytes={total_collective_bytes(log):.3e} "
              f"peak={memory['peak_bytes'] / 1e9:.3f} GB", flush=True)
    except Exception as e:  # noqa: BLE001 - record failures as data
        record["status"] = "fail"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        print(f"[{arch} x {shape.name} x {mesh_name}] FAIL "
              f"{record['error'][:200]}", flush=True)
    record["kernel_launches"] = {f.__name__: f.launches
                                 for f in kernel_counters()}
    return record


def case_name(record: dict) -> str:
    return (f"{record['arch']}__{record['shape']}__{record['mesh']}"
            f"__{record['policy'].replace('/', '_')}")


def save_log(record: dict, log, out_dir: str = ARTIFACT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, case_name(record) + ".ops.jsonl.gz")
    with gzip.open(path, "wt") as f:
        for e in log:
            f.write(json.dumps(e, separators=(",", ":")) + "\n")
    return path


def load_log(path: str) -> list:
    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f]


def save_record(record: dict, out_dir: str = ARTIFACT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, case_name(record) + ".json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--policy", default="baseline", choices=list(POLICIES))
    ap.add_argument("--mesh-shape", default=None,
                    help="override mesh, e.g. 256x1 (data x model)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="where the fake tensors live (cpu without CUDA)")
    ap.add_argument("--batch", type=int, default=None,
                    help="with --seq-len: one train shape of this size")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() (few layers, narrow)")
    ap.add_argument("--no-remat", action="store_true",
                    help="train without recomputing each layer")
    ap.add_argument("--dtype", default=None, help="replace the config's")
    ap.add_argument("--depth", type=int, default=None,
                    help="replace the config's layer count")
    return ap


def cases(args) -> list:
    """(arch, shape) of every case the arguments ask for."""
    if args.batch is not None:
        return [(args.arch, ShapeSpec(f"train_{args.batch}x{args.seq_len}",
                                      "train", args.seq_len, args.batch))]
    archs = ARCHS if args.all else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    return [(a, SHAPES[s]) for a in archs for s in shapes]


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if not (args.all or args.arch):
        ap.error("give --arch or --all")
    if args.batch is not None and not (args.arch and args.seq_len):
        ap.error("--batch needs --arch and --seq-len")
    todo = cases(args)
    n_fail = 0
    try:
        for arch, shape in todo:
            cfg = get_config(arch)
            if args.reduced:
                cfg = cfg.reduced()
            if args.dtype or args.depth:
                cfg = dataclasses.replace(
                    cfg, dtype=args.dtype or cfg.dtype,
                    n_layers=args.depth or cfg.n_layers)
            rec = run_case(arch, shape, multi_pod=args.multi_pod,
                           policy_name=args.policy,
                           mesh_shape=args.mesh_shape, device=args.device,
                           cfg=cfg, out_dir=args.out,
                           remat=not args.no_remat)
            save_record(rec, args.out)
            n_fail += rec["status"] != "ok"
    finally:
        release()
    print(f"done: {len(todo) - n_fail}/{len(todo)} ok")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
