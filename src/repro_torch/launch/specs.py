"""One member's inputs for every (arch x shape) case, the port of
``repro/launch/specs.py``: ``build_case(cfg, shape, mesh, policy)`` returns
(step_fn, args, specs) for a train, prefill or decode step
(``train_case``, ``prefill_case``, ``decode_case``).

``args`` holds fake tensors of a ``FakeTensorMode``, of this member's
shapes on ``device``: nothing is allocated and nothing is drawn. They are
cut from the case's global inputs (``case_specs``), which are worked out on
the meta device as the reference's ``jax.eval_shape`` of its init gives
them: full shapes and dtypes from ``steps.param_shapes``, the state's
moments, step and EF from ``steps.full_state``, the batch from
``batch_specs`` and the cache from ``transformer.init_decode_cache``. Each
member's block is ``sharding.shard_shape`` of its global leaf under the
spec the member holds it by. ``specs`` holds the reference-layout spec of
every leaf, in the structure of ``args``; the held spec is the same (mamba's
``in_proj`` by halves, ``sharding.held_spec``), a cache's too
(``held_cache_specs``: ``model`` on its kv heads, recurrent channels or
positions, as the rule finds them). A ``pos`` is a Python int, as
``transformer.decode_step`` takes it, with spec ``()``.

A train step is handed the global batch and cuts its rows itself
(``steps.local_batch``), as ``run_cluster`` hands it to every member; the
serving cases run as a member would: its block of the batch over the data
axes (``batch_shardings``: replicated where the batch does not divide), its
blocks of the params and caches, the layers split over ``model``
(``steps.make_prefill_step`` / ``make_decode_step`` on the mesh).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch import sharding as shard_rules
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as tf
from repro_torch.models.layers import torch_dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """The global batch (meta tensors)."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((b, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _meta((b, s), torch.int32)
    if cfg.family == "vlm":
        out["vision_embeds"] = _meta((b, cfg.n_vision_tokens, cfg.vision_dim),
                                     torch_dtype(cfg.dtype))
    if cfg.family == "audio":
        out["audio_embeds"] = _meta((b, cfg.n_audio_frames, cfg.d_model),
                                    torch_dtype(cfg.dtype))
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """The global decode inputs (meta tensors): the cache, the token and
    ``pos``, the last position of the context."""
    b = shape.global_batch
    cache = tf.init_decode_cache(cfg, b, shape.seq_len,
                                 sliding=shape.sliding_window_decode,
                                 device="meta")
    return {"cache": cache, "token": _meta((b, 1), torch.int32),
            "pos": shape.seq_len - 1}


def tree_map(fn, tree, *rest):
    """``fn(leaf, *rest_leaves)`` over a pytree of dicts, lists and tuples
    (``OptState`` included) whose leaves are tensors or ints; ``rest`` are
    trees of its structure with anything at the leaves; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(getattr(r, f) for r in rest))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def held_cache_specs(cfg: ModelConfig, cache, mesh: Mesh, batch: int):
    """The spec a member holds each leaf of ``cache``, a decode cache of
    ``batch`` rows, by: the reference's (``sharding.cache_shardings``),
    ``model`` on the kv heads, the recurrent channels or the positions,
    wherever the rule puts it (``transformer.init_decode_cache`` on a mesh
    makes these blocks, the attention reads a block of the positions)."""
    return shard_rules.cache_shardings(cfg, cache, mesh, batch)


def _train_inputs(cfg, shape, mesh, policy):
    state = steps_mod.full_state(cfg, policy, mesh,
                                 steps_mod.param_shapes(cfg))
    state_sh = steps_mod.state_shardings(cfg, policy, mesh, state)
    batch = batch_specs(cfg, shape)
    batch_sh = shard_rules.batch_shardings(batch, mesh)
    whole = {k: (None,) * x.dim() for k, x in batch.items()}
    return ((state, batch), (state_sh, batch_sh),
            (steps_mod.held_specs(cfg, policy, mesh), whole))


def _params_inputs(cfg, mesh):
    params = steps_mod.param_shapes(cfg)
    params_sh = shard_rules.param_shardings(cfg, params, mesh)
    return params, params_sh, {
        k: shard_rules.held_spec(sp, k, params[k].shape, mesh)
        for k, sp in params_sh.items()}


def _prefill_inputs(cfg, shape, mesh):
    params, params_sh, params_held = _params_inputs(cfg, mesh)
    batch = batch_specs(cfg, shape)
    batch_sh = shard_rules.batch_shardings(batch, mesh)
    return (params, batch), (params_sh, batch_sh), (params_held, batch_sh)


def _decode_inputs(cfg, shape, mesh):
    params, params_sh, params_held = _params_inputs(cfg, mesh)
    d = decode_specs(cfg, shape)
    cache_sh = held_cache_specs(cfg, d["cache"], mesh, shape.global_batch)
    tok_sh = shard_rules.batch_shardings({"token": d["token"]},
                                         mesh)["token"]
    return ((params, d["cache"], d["token"], d["pos"]),
            (params_sh, cache_sh, tok_sh, ()),
            (params_held, cache_sh, tok_sh, ()))


def case_specs(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
               policy: steps_mod.TrainPolicy) -> tuple:
    """(global inputs, their reference-layout specs, their held specs),
    three trees of the structure of ``build_case``'s ``args``; the inputs
    are meta tensors (``pos`` an int). Any mesh will do, a description
    (``Mesh(..., bind=False)``) too."""
    if shape.kind == "train":
        return _train_inputs(cfg, shape, mesh, policy)
    if shape.kind == "prefill":
        return _prefill_inputs(cfg, shape, mesh)
    return _decode_inputs(cfg, shape, mesh)


def member_inputs(glob, held, mesh: Mesh, fake: FakeTensorMode,
                  device="cuda"):
    """This member's block of every global input, fake tensors of
    ``fake`` on ``device``."""
    with fake:
        return tree_map(lambda x, sp: torch.empty(
            shard_rules.shard_shape(x.shape, sp, mesh), dtype=x.dtype,
            device=device) if torch.is_tensor(x) else x, glob, held)


def _case(mesh, step_fn, inputs, fake, device):
    glob, specs, held = inputs
    return step_fn, member_inputs(glob, held, mesh, fake or FakeTensorMode(),
                                  device), specs


def train_case(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
               policy: steps_mod.TrainPolicy, fake: FakeTensorMode = None,
               device="cuda"):
    """(train_step, (state, global batch), their specs)."""
    return _case(mesh, steps_mod.make_train_step(cfg, policy, mesh),
                 _train_inputs(cfg, shape, mesh, policy), fake, device)


def prefill_case(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
                 fake: FakeTensorMode = None, device="cuda"):
    """(prefill_step, (params, batch), their specs)."""
    return _case(mesh, steps_mod.make_prefill_step(
        cfg, mesh=mesh, global_batch=shape.global_batch),
                 _prefill_inputs(cfg, shape, mesh), fake, device)


def decode_case(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
                fake: FakeTensorMode = None, device="cuda"):
    """(decode_step, (params, cache, token, pos), their specs)."""
    inputs = _decode_inputs(cfg, shape, mesh)
    step_fn = steps_mod.make_decode_step(
        cfg, circular=shape.sliding_window_decode, mesh=mesh,
        global_batch=shape.global_batch,
        cache_len=tf.attention_cache_len(inputs[0][1]))
    return _case(mesh, step_fn, inputs, fake, device)


def build_case(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
               policy: steps_mod.TrainPolicy, fake: FakeTensorMode = None,
               device="cuda"):
    """(step_fn, args, specs) of the case; ``args`` are fake tensors of
    ``fake`` (a new mode if None): run ``step_fn(*args)`` under it."""
    if shape.kind == "train":
        return train_case(cfg, shape, mesh, policy, fake, device)
    if shape.kind == "prefill":
        return prefill_case(cfg, shape, mesh, fake, device)
    return decode_case(cfg, shape, mesh, fake, device)


def state_bytes(tree) -> int:
    """Bytes of the distinct storages under a pytree of tensors."""
    seen: Dict[int, int] = {}

    def add(x):
        if torch.is_tensor(x):
            st = x.untyped_storage()
            seen.setdefault(st._cdata, st.nbytes())
    tree_map(add, tree)
    return sum(seen.values())
