"""The port's trainer from the command line (``python -m
repro_torch.launch.train --cluster``) and its 100M example
(``python -m repro_torch.examples.train_fl_100m``) against the JAX
package's, on the CPU. The reference runs on the Auto-axis mesh of
``tests/test_torch_steps.py`` (handed to it through its
``make_local_mesh``).

(a) ``main([..., "--cluster"])`` at ``--reduced`` against the reference's
    CLI: the printed losses equal to their 4 printed decimals and the final
    line equal; its checkpoint loaded by ``repro.checkpoint.load_checkpoint``
    (the params within a relative L2 error of 1e-3 of the reference's own,
    as ``test_torch_steps.py`` holds the steps) and by the port's, bitwise;
    meshes of more than one member raise outside a process group, a model
    axis too, and the vlm and audio families train; the ssm and hybrid
    families train split over a model axis of 2 (two ``gloo`` members).
(b) ``train_fl_100m`` at its mini size for 3 steps against the reference's
    example: the model line and the printed losses equal; both raise the
    example's assertion (3 steps do not lower the loss by 0.3); the full
    ~100M config field for field.
"""
import dataclasses
import importlib.util
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.examples import train_fl_100m as tex  # noqa: E402
from repro_torch.launch import members  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from test_torch_steps import (  # noqa: E402,F401
    PARAMS_REL_L2, _np, _one_thread, _rel_l2, auto_mesh)
import torch_cluster_workers as workers  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# (a) the CLI
# ---------------------------------------------------------------------------
def _losses(out: str):
    return [float(x) for x in re.findall(r"^step +\d+ +loss ([0-9.]+)", out,
                                         re.M)]


@pytest.mark.parametrize("arch,comp", [("gemma-2b", "int8"),
                                       ("minicpm-2b", "sign")])
def test_cluster_main_matches_reference(arch, comp, tmp_path, monkeypatch,
                                        capsys):
    argv = ["--arch", arch, "--reduced", "--cluster", "--steps", "4",
            "--seq-len", "32", "--batch", "4", "--lr", "3e-3",
            "--compression", comp]
    monkeypatch.setattr(jtrain, "make_local_mesh", auto_mesh)
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--ckpt-dir", str(tmp_path / "j")])
    jtrain.main()
    want = capsys.readouterr().out
    ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "t")], device="cpu")
    got = capsys.readouterr().out
    assert len(_losses(got)) == 4 and _losses(got) == _losses(want)
    assert got.splitlines()[-1] == want.splitlines()[-1]  # final loss line
    assert f"[pssgd/{comp}+ef]" in got
    assert tckpt.latest_step(str(tmp_path / "t")) == 4
    # the port's checkpoint, loaded by the reference into its own tree
    jcfg = jget_config(arch).reduced()
    like = jtf.init_params(jcfg, jax.random.PRNGKey(9))
    theirs = jckpt.load_checkpoint(str(tmp_path / "t"), 4, like)
    ref = jckpt.load_checkpoint(str(tmp_path / "j"), 4, like)
    mine = convert.lm_params_from_jax(_np(theirs))
    assert _rel_l2(mine, convert.lm_params_from_jax(_np(ref))) < PARAMS_REL_L2
    ours = tckpt.load_checkpoint(
        str(tmp_path / "t"), 4,
        ttrain.tf.init_params(get_config(arch).reduced(), trandom.PRNGKey(9)))
    for k, v in mine.items():
        assert torch.equal(ours[k], v), k


def test_cluster_raises_for_meshes_and_runs_every_family(tmp_path):
    """A mesh of more than one member raises outside a process group of as
    many members (``tests/test_torch_cluster_cli_members.py`` runs one), a
    model axis too (``tests/test_torch_cluster_tp.py`` and
    ``_tp_recurrent.py`` hold the steps against the reference's); the ssm
    and hybrid families train over a model axis of 2 inside a group of two
    members, their recurrent blocks split (ROADMAP queue A item 8b), each
    member printing or silent as rank 0 or 1; the vlm and audio families
    train (on zero embeddings, as the reference's CLI feeds them;
    ``tests/test_torch_vlm_audio.py`` holds them against it)."""
    for arch, flags, n in (
            ("qwen2-moe-a2.7b", ["--mesh-data", "2"], 2),
            ("qwen2-moe-a2.7b", ["--mesh-data", "2", "--mesh-model", "2"], 4),
            ("gemma-2b", ["--mesh-model", "4"], 4),
            ("falcon-mamba-7b", ["--mesh-model", "4"], 4),
            ("recurrentgemma-2b", ["--mesh-model", "4"], 4)):
        with pytest.raises(RuntimeError, match=f"process group of {n} "):
            ttrain.main(["--arch", arch, "--reduced", "--cluster"] + flags,
                        device="cpu")
    recurrent = ("falcon-mamba-7b", "recurrentgemma-2b")
    got = members.spawn(workers.cli_runs, 2, ([
        ["--arch", a, "--reduced", "--cluster", "--mesh-model", "2",
         "--steps", "4", "--seq-len", "16", "--batch", "8", "--lr", "3e-3"]
        for a in recurrent],), rendezvous_dir=str(tmp_path))
    for arch, out, quiet in zip(recurrent, got[0], got[1]):
        assert quiet == "" and out.startswith("members: 2 members"), arch
        losses = _losses(out)
        assert len(losses) == 4 and losses[-1] < losses[0], arch
        assert "final loss" in out
    for arch in ("llama-3.2-vision-11b", "whisper-base"):
        args = ttrain.parser().parse_args(
            ["--arch", arch, "--reduced", "--cluster", "--steps", "4",
             "--seq-len", "16", "--batch", "8", "--lr", "3e-3"])
        losses, state = ttrain.run_cluster(args, device="cpu")
        assert len(losses) == 4 and losses[-1] < losses[0]
        assert all(torch.isfinite(v).all() for v in state["params"].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.main(["--arch", "gemma-2b", "--reduced", "--cluster"])


# ---------------------------------------------------------------------------
# (b) the 100M example
# ---------------------------------------------------------------------------
def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "train_fl_100m_reference",
        os.path.join(ROOT, "examples", "train_fl_100m.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("comp", ["int8"])
def test_train_fl_100m_mini_matches_reference(comp, monkeypatch, capsys):
    argv = ["--steps", "3", "--compression", comp]
    ref = _reference_example()
    monkeypatch.setattr(ref, "make_local_mesh", auto_mesh)
    monkeypatch.setattr(sys, "argv", ["train_fl_100m"] + argv)
    with pytest.raises(AssertionError):  # 3 steps do not fall by 0.3
        ref.main()
    want = capsys.readouterr().out
    losses = tex.train(tex.parser().parse_args(argv), device="cpu")
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]  # the model line
    assert _losses(got.replace("  ", " ")) == _losses(want.replace("  ", " "))
    assert len(losses) == 3
    assert dataclasses.asdict(tex.model_100m(True)) == dataclasses.asdict(
        ref.model_100m(True))
    with pytest.raises(AssertionError):
        tex.main(argv, device="cpu")
