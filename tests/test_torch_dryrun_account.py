"""The dry-run's op account (``repro_torch.launch.dryrun.analyze``) against
the reference's compiled analyses (``memory_analysis``,
``hlo_analysis.collective_stats`` and ``hlo_compute_stats`` of the jitted
step), on the CPU: gemma-2b ``reduced()`` on (data 2) under five policies,
and qwen2-moe-a2.7b ``reduced()`` on (data 1, model 1) and (data 1,
model 2) in its train, prefill and decode steps; global batch (8, 64).

The reference runs once, in a subprocess over forced CPU devices on Auto
axes (``torch_dryrun_jax.py``); the port runs one member's step under fake
tensors on a fake process group of the mesh's size, this module's, which
is destroyed at its end. Every byte and flop of difference is named:

* argument bytes: the port's train step takes the global batch and cuts
  its rows itself; its ``pos`` is a Python int, the reference's a 4-byte
  argument. On (data 1, model 2) a member holds its block of every leaf
  the reference splits over ``model`` (``steps.held_specs``): nothing more;
* wire bytes: pssgd and localsgd equal kind for kind, but for the loss's
  all-reduce, which the port's ``psum`` pads to one element a member (4
  bytes more on 2 members); fsdp's port wire is its own all-gather of each
  split leaf (a layer's twice: the layer is gathered where it runs and again
  where the backward recomputes it), reduce-scatter of its gradient and
  all-reduce of the rest (XLA's partitioner picks other collectives there:
  its figure is in PERF.md). Over ``model`` (``_model_wire``): the
  all-reduce of the embedding's rows, of each attention's and MoE layer's
  (T, d) partial output, in a train step the backward's all-reduce at each
  split region's input (each layer's attention input, the MoE input and its
  routing weights, the unembedding's input), the cross-entropy's max (an
  all-gather of the (B, S) maxima), sum of exps and gold logit, and the
  recomputation of each layer's attention sum (``torch.utils.checkpoint``
  stops recomputing at the last tensor the backward needs, before the
  layer's closing MoE sum). XLA's prefill and decode send one (T, d)
  all-reduce a layer more: it sums the shared experts' output apart from the
  experts', where the port adds them before one sum;
* flops: equal but for the reference's checkpointed cross-entropy chunk,
  which recomputes the logits in the backward, ``2 T d V`` more for T
  tokens a member (the port keeps the chunk's logits). On (data 1, model 2)
  every dot splits but the router's (heads, MLP, shared and routed
  experts, vocabulary): the port's count on (data 1, model 1) less the
  other member's share of all but the router's dots, read off its op log
  (``_router_dots``). The reference's fsdp step is partitioned by XLA and
  its MoE train step on (data 1, model 2) does not compile on JAX 0.9 (its
  own failure, asserted).

Beside the reference, the port alone: the fsdp step's peak live bytes,
gathering a layer at a time, below those of the step that gathers every
leaf for the step (``torch_cluster_workers.whole_gather_step``), remat on
and off; and on (data 2) the MoE serving steps' wire, which adds to
``_model_wire`` an all-gather of each member's (E_pad,) int32 counts a
layer (routing the global batch as one capacity group).
"""
import dataclasses
import math

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_dryrun_jax import (  # noqa: E402
    ACCOUNT_CASES, BATCH, SEQ, case_key, run_reference)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import shard_shape  # noqa: E402
from repro_torch.models.moe import padded_n_experts  # noqa: E402
from repro_torch.models.transformer import LAYER_KEYS  # noqa: E402
import torch_cluster_workers as workers  # noqa: E402

# the loss's all-reduce on 2 members: the port sends its 1-element psum
# padded to 2 (4 B out in the reduce-scatter, 4 B in the all-gather), the
# reference's ring model 2 * 4 * (2 - 1) / 2
LOSS_PAD = 4
POS_BYTES = 4


def _case(arch, kind):
    return get_config(arch).reduced(), ShapeSpec(kind, kind, SEQ, BATCH)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    want = run_reference(str(tmp_path_factory.mktemp("ref") / "ref.json"))
    got = {}
    try:
        for arch, mshape, kind, policy in ACCOUNT_CASES:
            cfg, shape = _case(arch, kind)
            dryrun.bind(math.prod(mshape))
            mesh = make_mesh(mshape, ("data", "model"))
            mem, _, colls, parsed, log = dryrun.analyze(
                cfg, shape, mesh, dryrun.policy_from_name(policy), "cpu")
            got[case_key(arch, mshape, kind, policy)] = (mem, colls, parsed,
                                                         mesh, log)
    finally:
        dryrun.reset_globals()
        dryrun.release()
    return got, want


def _bytes(shape, dtype):
    return math.prod(shape) * dtype.itemsize


def _held_minus_split(cfg, shape, mesh, policy):
    """Argument bytes the port holds beyond the reference's: each leaf's
    held block less its block under the reference's spec, less ``pos``."""
    glob, sp, held = specs.case_specs(cfg, shape, mesh,
                                      dryrun.policy_from_name(policy))
    extra = []

    def leaf(x, s, h):
        if isinstance(x, int):
            extra.append(-POS_BYTES)
        else:
            extra.append(_bytes(shard_shape(x.shape, h, mesh), x.dtype)
                         - _bytes(shard_shape(x.shape, s, mesh), x.dtype))
    specs.tree_map(leaf, glob, sp, held)
    return sum(extra), glob


def _xent_recompute(cfg, tokens):
    return 2.0 * tokens * cfg.d_model * cfg.vocab_size


def _router_dots(log, cfg):
    """Flops of the dots on the router in an op log: each ``mm`` that
    reads or writes a (d, experts) or (experts, d) matrix, the router's or
    its gradient's."""
    d, e_ = cfg.d_model, cfg.n_experts
    flops = 0.0
    for e in log:
        if e[0] == "op" and e[1] == "aten.mm.default" and any(
                dims in ([d, e_], [e_, d]) for _, dims in e[2] + e[3]):
            flops += 2.0 * math.prod(e[3][0][1]) * e[2][0][1][-1]
    return flops


def _model_wire(cfg, kind, tokens, n):
    """The port's bytes over a ``model`` axis of ``n`` members in one
    member's step of the MoE config (remat on), by kind (see above)."""
    def psum(numel):
        return 2.0 * (n - 1) * -(-numel // n) * 4

    act = psum(tokens * cfg.d_model)
    layers = cfg.n_layers * 2 * act          # attention's and MoE's sums
    out = {"all-reduce": act + layers}       # and the embedding's
    if kind == "train":
        out["all-reduce"] += (
            cfg.n_layers * act                # recomputed attention sums
            + cfg.n_layers * (2 * act + psum(tokens * cfg.moe_top_k))
            + act                             # the unembedding's input
            + 2 * psum(tokens))               # sum of exps, gold logit
        out["all-gather"] = (n - 1) * tokens * 4.0   # the max
    return out


@pytest.mark.parametrize("case", ACCOUNT_CASES,
                         ids=[case_key(*c) for c in ACCOUNT_CASES])
def test_account_matches_reference(runs, case):
    arch, mshape, kind, policy = case
    key = case_key(*case)
    got, want = runs
    mem, colls, parsed, mesh, _ = got[key]
    ref = want[key]
    cfg, shape = _case(arch, kind)
    if ref["status"] == "fail":
        # the reference's own: its MoE train step on a model axis of 2
        assert (arch, mshape, kind) == ("qwen2-moe-a2.7b", (1, 2), "train")
        assert "Cross-partition allreduce must be in (partial) manual" \
            in ref["error"]
    n_data, n_model = mshape
    tokens = BATCH * SEQ // n_data if kind != "decode" else BATCH // n_data

    # flops
    recompute = _xent_recompute(cfg, tokens) if kind == "train" else 0.0
    if policy == "fsdp":
        assert parsed["flops"] + recompute <= ref["parsed"]["flops"]
    elif n_model > 1:
        one = case_key(arch, (n_data, 1), kind, policy)
        router = _router_dots(got[one][4], cfg)
        assert router > 0
        whole = want[one]["parsed"]["flops"] - recompute
        assert parsed["flops"] == (whole - router) / n_model + router
    else:
        assert parsed["flops"] + recompute == ref["parsed"]["flops"]
    wire = {k: v["bytes"] for k, v in colls.items()}
    if n_model > 1:
        assert wire == _model_wire(cfg, kind, tokens, n_model)
    if ref["status"] == "fail":
        return

    # argument bytes, every byte of difference named
    extra, glob = _held_minus_split(cfg, shape, mesh, policy)
    assert mem["argument_bytes"] - ref["argument_bytes"] == extra
    if kind == "train" and n_model == 1:
        batch = glob[1]
        assert extra == sum(_bytes(x.shape, x.dtype) * (n_data - 1) // n_data
                            for x in batch.values())
    if n_data == 1:   # (1, 2) holds its block of every split leaf
        assert extra == (-POS_BYTES if kind == "decode" else 0)

    # wire bytes
    ref_wire = {k: v["bytes"] for k, v in ref["collectives"].items()
                if v["bytes"]}
    if arch == "gemma-2b" and policy != "fsdp":
        assert wire.pop("all-reduce") - ref_wire.pop("all-reduce") == LOSS_PAD
        assert wire == ref_wire
    elif policy == "fsdp":
        assert wire == _fsdp_wire(cfg, mesh, glob[0]["params"])
    elif n_model > 1:
        # XLA's all-reduce of each layer's shared experts' (T, d) output
        act = 2 * (n_model - 1) * tokens * cfg.d_model // n_model * 4
        assert ref_wire == {"all-reduce": wire["all-reduce"]
                            + cfg.n_layers * act}
    else:
        assert wire == ref_wire == {}


def _fsdp_wire(cfg, mesh, params):
    """The port's fsdp collectives (remat on): each leaf split over the
    data axis is all-gathered, a layer's again where the backward
    recomputes the layer (``transformer.LAYER_KEYS``), and its gradient
    reduce-scattered; every other gradient and the loss are all-reduced,
    padded to one element a member."""
    n = mesh.n("data")
    held = specs.case_specs(cfg, ShapeSpec("t", "train", SEQ, BATCH), mesh,
                            dryrun.policy_from_name("fsdp"))[2][0]["params"]
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}

    def psum(numel, size):
        return 2.0 * (n - 1) * -(-numel // n) * size

    for k, p in params.items():
        block = _bytes(shard_shape(p.shape, held[k], mesh), p.dtype)
        if "data" in held[k]:
            gathers = 2 if k.startswith(LAYER_KEYS) else 1
            out["all-gather"] += gathers * (n - 1) * block
            out["reduce-scatter"] += (n - 1) * block
        else:
            out["all-reduce"] += psum(math.prod(p.shape), p.dtype.itemsize)
    out["all-reduce"] += psum(1, 4)
    return out


def _alone(cfg, shape, mshape, policy):
    """``dryrun.analyze`` of one case on its own fake process group."""
    try:
        dryrun.bind(math.prod(mshape))
        return dryrun.analyze(cfg, shape, make_mesh(mshape, ("data",
                                                             "model")),
                              policy, "cpu")
    finally:
        dryrun.reset_globals()
        dryrun.release()


@pytest.mark.parametrize("remat", [True, False])
def test_fsdp_layers_peak_below_whole_gather(remat, monkeypatch):
    cfg, shape = _case("gemma-2b", "train")
    policy = dataclasses.replace(dryrun.policy_from_name("fsdp"),
                                 remat=remat)
    layers = _alone(cfg, shape, (2, 1), policy)
    monkeypatch.setattr(tsteps, "_make_fsdp_step", workers.whole_gather_step)
    whole = _alone(cfg, shape, (2, 1), policy)
    assert layers[0]["argument_bytes"] == whole[0]["argument_bytes"]
    assert layers[0]["peak_bytes"] < whole[0]["peak_bytes"]
    assert (layers[2]["reduce-scatter"]["bytes"]
            == whole[2]["reduce-scatter"]["bytes"])


MOE_DATA_CASES = [(m, k) for m in ((2, 1), (2, 2))
                  for k in ("prefill", "decode")]


@pytest.mark.parametrize("mshape,kind", MOE_DATA_CASES,
                         ids=[f"{m[0]}x{m[1]}-{k}" for m, k in MOE_DATA_CASES])
def test_moe_serving_on_data_members_gathers_expert_counts(mshape, kind):
    cfg, shape = _case("qwen2-moe-a2.7b", kind)
    n_data, n_model = mshape
    colls = _alone(cfg, shape, mshape, dryrun.policy_from_name("baseline"))[2]
    tokens = BATCH * SEQ // n_data if kind != "decode" else BATCH // n_data
    want = _model_wire(cfg, kind, tokens, n_model) if n_model > 1 else {}
    want["all-gather"] = (want.get("all-gather", 0.0) + cfg.n_layers
                          * (n_data - 1) * padded_n_experts(cfg) * 4)
    assert {k: v["bytes"] for k, v in colls.items()} == want
