"""The dry-run's command line (``python -m repro_torch.launch.dryrun``) and
``python -m repro_torch.launch.reanalyze``, each in a process of its own
(the dry-run holds its process's default group, a fake one), with fake
tensors on the CPU (``--device cpu``).

A case writes a record with the reference's keys (``lower_s`` /
``compile_s`` / ``hlo_bytes`` become ``trace_s`` and ``ops``) and its op
log; a dense config on the (16, 16) mesh is ``ok``, split over ``model``,
and so is an ssm config's decode step there, its recurrent states split
too; ``reanalyze`` re-derives
``parsed`` and ``collectives`` from the op logs exactly. The trainer's
``--cluster --reduced`` step on (data 2, model 2), traced with
``--reduced --no-remat``, sends what 4 gloo members send in each step.
"""
import json
import math
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun, members, specs  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.sharding import shard_shape  # noqa: E402
from repro_torch.launch.specs import tree_map  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
# the reference's record keys (repro/launch/dryrun.py::run_case), less
# lower_s, compile_s and hlo_bytes
REF_KEYS = {"arch", "shape", "policy", "mesh", "n_devices", "model_params",
            "active_params", "status", "memory", "cost", "collectives",
            "parsed"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}


def _run(module, *argv):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.run([sys.executable, "-m", module, *argv], env=env,
                          capture_output=True, text=True, timeout=300)


def _record(out, name):
    with open(os.path.join(out, name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("artifacts_torch"))
    runs = [_run("repro_torch.launch.dryrun", *argv, "--device", "cpu",
                 "--out", d)
            for argv in (["--arch", "whisper-base", "--shape", "decode_32k",
                          "--mesh-shape", "256x1"],
                         ["--arch", "qwen2-moe-a2.7b", "--shape",
                          "long_500k"],
                         ["--arch", "gemma-2b", "--shape", "train_4k"],
                         ["--arch", "falcon-mamba-7b", "--shape",
                          "decode_32k"])]
    return d, runs


def test_record_has_reference_keys(out):
    d, runs = out
    assert runs[0].returncode == 0, runs[0].stderr
    assert "done: 1/1 ok" in runs[0].stdout
    rec = _record(d, "whisper-base__decode_32k__256x1__baseline")
    assert REF_KEYS <= set(rec) and {"trace_s", "ops"} <= set(rec)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["cost"]) == {"flops", "bytes accessed"}
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["cost"]["flops"] == rec["parsed"]["flops"] > 0
    assert not any(rec["kernel_launches"].values())
    assert os.path.exists(os.path.join(
        d, "whisper-base__decode_32k__256x1__baseline.ops.jsonl.gz"))


def test_moe_on_production_mesh_is_ok(out):
    d, runs = out
    assert runs[1].returncode == 0, runs[1].stderr
    rec = _record(d, "qwen2-moe-a2.7b__long_500k__16x16__baseline")
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["collectives"]["all-reduce"]["bytes"] > 0


def test_dense_on_production_mesh_fails_with_dense_tp(out):
    """A dense config on (16, 16) is split over model and its record is
    ``ok``: each member holds its block of every leaf the reference splits
    (gemma-2b: the MLP and the vocabulary; its 8 q heads and 1 kv head do
    not divide by 16), and the step sends the all-reduces over model. An
    ssm config's decode step is ``ok`` too (ROADMAP queue A item 8b): a
    member holds its block of every mamba leaf and recurrent state, and
    its argument bytes are those blocks'."""
    d, runs = out
    assert runs[2].returncode == 0, runs[2].stderr
    assert "done: 1/1 ok" in runs[2].stdout
    rec = _record(d, "gemma-2b__train_4k__16x16__baseline")
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    cfg = get_config("gemma-2b")
    mesh = Mesh((16, 16), ("data", "model"), bind=False)
    pol = dryrun.policy_from_name("baseline")
    glob, sp, held = specs.case_specs(cfg, SHAPES["train_4k"], mesh, pol)
    state, state_held = glob[0], held[0]
    assert state_held["params"] == {
        k: tuple(s) for k, s in sp[0]["params"].items()}
    assert state_held["params"]["embed"] == ("model", None)
    assert state_held["params"]["blocks/mlp/w_up"] == (None, None, "model")
    assert state_held["params"]["blocks/attn/wq"] == (None, None, None)
    params = sum(math.prod(shard_shape(x.shape, state_held["params"][k],
                                       mesh)) * x.dtype.itemsize
                 for k, x in state["params"].items())
    whole = sum(math.prod(x.shape) * x.dtype.itemsize
                for x in state["params"].values())
    assert params < whole / 4
    assert rec["memory"]["argument_bytes"] > params
    assert rec["collectives"]["all-reduce"]["bytes"] > 0
    assert runs[3].returncode == 0, runs[3].stderr
    assert "done: 1/1 ok" in runs[3].stdout
    rec = _record(d, "falcon-mamba-7b__decode_32k__16x16__baseline")
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    cfg = get_config("falcon-mamba-7b")
    glob, sp, held = specs.case_specs(cfg, SHAPES["decode_32k"], mesh, pol)
    assert held[0]["blocks/mamba/in_proj"] == (None, None, "model")
    assert held[1] == {"conv": (None, "data", None, "model"),
                       "ssm": (None, "data", "model", None)}
    sizes = []
    tree_map(lambda x, h: sizes.append(math.prod(shard_shape(
        x.shape, h, mesh)) * x.dtype.itemsize) if hasattr(x, "shape")
        else None, glob, held)
    assert rec["memory"]["argument_bytes"] == sum(sizes)
    assert rec["collectives"]["all-reduce"]["bytes"] > 0


def test_reanalyze_reproduces_records(out):
    d, _ = out
    names = ["whisper-base__decode_32k__256x1__baseline",
             "qwen2-moe-a2.7b__long_500k__16x16__baseline",
             "gemma-2b__train_4k__16x16__baseline",
             "falcon-mamba-7b__decode_32k__16x16__baseline"]
    before = {n: _record(d, n) for n in names}
    for n in names:
        rec = dict(before[n], parsed={}, collectives={})
        with open(os.path.join(d, n + ".json"), "w") as f:
            json.dump(rec, f)
    res = _run("repro_torch.launch.reanalyze", "--out", d)
    assert res.returncode == 0, res.stderr
    assert "updated 4, missing op log for 0" in res.stdout
    for n in names:
        assert _record(d, n) == before[n]


def test_reduced_step_wire_is_the_members(tmp_path):
    d = str(tmp_path / "artifacts_torch")
    run = _run("repro_torch.launch.dryrun", "--arch", "qwen2-moe-a2.7b",
               "--reduced", "--no-remat", "--batch", "8", "--seq-len", "64",
               "--mesh-shape", "2x2", "--device", "cpu", "--out", d)
    assert run.returncode == 0, run.stderr
    rec = _record(d, "qwen2-moe-a2.7b__train_8x64__2x2__baseline(no-remat)")
    assert rec["status"] == "ok" and rec["n_devices"] == 4
    wire = sum(v["bytes"] for v in rec["collectives"].values())
    steps = 3
    argv = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--cluster",
            "--mesh-data", "2", "--mesh-model", "2", "--steps", str(steps),
            "--seq-len", "64", "--batch", "8", "--lr", "3e-3"]
    got = members.spawn(workers.cli, 4, (argv,),
                        rendezvous_dir=str(tmp_path))
    assert wire > 0
    assert [m["wire"] for m in got] == [steps * wire] * 4
