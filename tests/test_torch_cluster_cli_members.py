"""The port's ``python -m repro_torch.launch.train --cluster --mesh-data 2``
on two members (one process each, ``gloo``) against the reference's CLI on
an Auto-axis (2, 1) mesh over forced CPU devices, on the CPU: the printed
losses equal to their 4 printed decimals and the final line equal, printed
by rank 0 alone (after one line naming the members and the backend); the
checkpoint, gathered to rank 0, loaded by the reference into its own tree
(the params within ``PARAMS_REL_L2`` of the reference's own checkpoint)
and by the port, bitwise.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import members  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from test_torch_steps import PARAMS_REL_L2, _np, _rel_l2  # noqa: E402
from torch_cluster_jax import run_reference  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402


def _losses(out: str):
    return [float(x) for x in re.findall(r"^step +\d+ +loss ([0-9.]+)", out,
                                         re.M)]


@pytest.mark.parametrize("arch,comp,mode", [("gemma-2b", "int8", "pssgd"),
                                            ("minicpm-2b", "none", "fsdp")])
def test_cluster_members_match_reference_cli(arch, comp, mode, tmp_path):
    argv = ["--arch", arch, "--reduced", "--cluster", "--steps", "4",
            "--seq-len", "32", "--batch", "4", "--lr", "3e-3",
            "--compression", comp, "--mode", mode, "--mesh-data", "2"]
    want = str(run_reference("cli", 2, str(tmp_path / "ref.npz"),
                             argv + ["--ckpt-dir", str(tmp_path / "j")])
               ["stdout"])
    got = members.spawn(workers.cli, 2,
                        (argv + ["--ckpt-dir", str(tmp_path / "t")],),
                        rendezvous_dir=str(tmp_path))
    out = got[0]["stdout"]
    assert got[1]["stdout"] == ""      # rank 0 alone prints
    assert out.splitlines()[0].startswith("members: 2 members")
    assert "backend gloo" in out.splitlines()[0]
    assert len(_losses(out)) == 4 and _losses(out) == _losses(want)
    assert out.splitlines()[-1] == want.splitlines()[-1]
    jcfg = jget_config(arch).reduced()
    like = jtf.init_params(jcfg, jax.random.PRNGKey(9))
    theirs = jckpt.load_checkpoint(str(tmp_path / "t"), 4, like)
    ref = jckpt.load_checkpoint(str(tmp_path / "j"), 4, like)
    mine = convert.lm_params_from_jax(_np(theirs))
    assert _rel_l2(mine, convert.lm_params_from_jax(_np(ref))) < PARAMS_REL_L2
    ours = tckpt.load_checkpoint(
        str(tmp_path / "t"), 4,
        ttf.init_params(get_config(arch).reduced(), trandom.PRNGKey(9)))
    for k, v in mine.items():
        assert torch.equal(ours[k], v), k
    assert np.isfinite([float(x) for x in _losses(out)]).all()
