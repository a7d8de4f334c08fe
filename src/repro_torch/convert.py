"""Carry JAX-side values into the port, as numpy arrays: parameter dicts
(flat, or a transformer's nested tree), PRNG keys, a whole round state, the
channel, compression, algorithm, fault and privacy parameters, the
hierarchical and gossip engines' configurations, model configs, the
trainer's state and policy, and decode caches. The port
never imports JAX; callers hand over JAX objects, which are read through
``np.asarray`` and their field names."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.configs.base import ModelConfig
from repro_torch.core.algorithms.registry import AlgoParams
from repro_torch.core.compression.registry import CompressionParams
from repro_torch.core.compression.error_feedback import SparseEF
from repro_torch.core.faults import FaultParams
from repro_torch.core.hierarchy import HFLConfig
from repro_torch.core.privacy.registry import PrivacyParams
from repro_torch.core.wireless import ChannelParams
from repro_torch.fl.decentralized import GossipConfig
from repro_torch.fl.server import FLState
from repro_torch.launch.steps import TrainPolicy
from repro_torch.models.transformer import flatten_params
from repro_torch.optim.optimizers import OptState


def _tensor(v, device=None) -> torch.Tensor:
    """An array-like -> a tensor of the same dtype and values (bf16, which
    numpy holds as an extension type, goes through float32 exactly)."""
    a = np.array(v)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.as_tensor(a).to(device)


def params_from_jax(tree: Dict, device=None) -> Dict[str, torch.Tensor]:
    """A (flat) dict of arrays -> dict of tensors on ``device``, same
    dtypes and values."""
    return {k: _tensor(v, device) for k, v in tree.items()}


def lm_params_from_jax(tree: Dict, device=None) -> Dict[str, torch.Tensor]:
    """The reference transformer's nested params -> the port's flat dict
    keyed by ``/``-joined paths, leaves (the stacked ``(L, ...)`` ones
    included) as they are; a list (hybrid's ``rest`` layers) by index.
    Sorted, the keys are ``jax.tree.leaves`` order."""
    return params_from_jax(flatten_params(tree), device)


def model_config_from_jax(cfg) -> ModelConfig:
    """The reference's ``ModelConfig`` -> the port's, field by field."""
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def key_from_jax(key, device=None) -> torch.Tensor:
    """A raw ``jax.random.PRNGKey`` (uint32 words, shape (..., 2)) -> the
    port's int64 key tensor."""
    return torch.as_tensor(np.asarray(key).astype(np.int64), device=device)


# the reference's NamedTuples of server and EF state, by class name
_NAMED = {"SlowMoState": agg.SlowMoState,
          "ServerOptState": agg.ServerOptState,
          "SparseEF": SparseEF}


def _tree(v, device):
    if v is None:
        return None
    if isinstance(v, dict):
        return {k: _tree(x, device) for k, x in v.items()}
    if isinstance(v, list):
        return [_tree(x, device) for x in v]
    if isinstance(v, tuple):
        leaves = [_tree(x, device) for x in v]
        if hasattr(v, "_fields"):
            return _NAMED[type(v).__name__](*leaves)
        return tuple(leaves)
    return _tensor(v, device)


def fl_state_from_jax(state, device=None):
    """The reference's ``repro.fl.server.FLState`` -> the port's, on
    ``device``: params, the uplink EF (dense or sparse), the downlink EF,
    the algorithm's server state (SCAFFOLD's control variate, SlowMo's
    momentum, Adam's / Yogi's moments and step, fedbuff's buffer and
    counter), the (N, D) ctrl matrix and the round counter."""
    return FLState(params_from_jax(state.params, device),
                   _tree(state.client_error, device),
                   _tree(state.server_error, device),
                   _tree(state.server_opt, device),
                   _tree(state.ctrl, device), int(state.round))


def decode_cache_from_jax(cache, device=None):
    """A reference decode or prefill cache (nested dicts of stacked arrays;
    hybrid's ``rest`` a list of tuples) -> the port's: the same structure,
    tensors of the same dtypes and values."""
    return _tree(cache, device)


def _named(cls, p, device):
    """One of the reference's parameter NamedTuples -> the port's ``cls``,
    field by field (stacked variant axes carry over)."""
    return cls(*(_tensor(getattr(p, f), device) for f in cls._fields))


def fault_params_from_jax(fp, device=None) -> FaultParams:
    return _named(FaultParams, fp, device)


def privacy_params_from_jax(pp, device=None) -> PrivacyParams:
    return _named(PrivacyParams, pp, device)


def compression_params_from_jax(cp, device=None) -> CompressionParams:
    return _named(CompressionParams, cp, device)


def algo_params_from_jax(ap, device=None) -> AlgoParams:
    return _named(AlgoParams, ap, device)


def channel_params_from_jax(cp, device=None) -> ChannelParams:
    return _named(ChannelParams, cp, device)


def hfl_config_from_jax(h) -> HFLConfig:
    """The reference's ``HFLConfig`` -> the port's, field by field."""
    return HFLConfig(**{f.name: getattr(h, f.name)
                        for f in dataclasses.fields(HFLConfig)})


def gossip_config_from_jax(c) -> GossipConfig:
    """The reference's ``GossipConfig`` -> the port's: its static fields
    as they are, its algorithm, compression and fault parameters crossed
    with the converters above."""
    conv = {"algo_params": algo_params_from_jax,
            "compression_params": compression_params_from_jax,
            "faults": fault_params_from_jax}
    kw = {}
    for f in dataclasses.fields(GossipConfig):
        v = getattr(c, f.name)
        kw[f.name] = (conv[f.name](v) if f.name in conv and v is not None
                      else v)
    return GossipConfig(**kw)


def opt_state_from_jax(opt, device=None) -> OptState:
    """The reference's ``OptState`` -> the port's: the step, and each
    moment tree (or None) flattened as ``lm_params_from_jax`` flattens
    params."""
    def tree(t):
        return None if t is None else lm_params_from_jax(t, device)
    return OptState(_tensor(opt.step, device), tree(opt.m), tree(opt.v))


def train_state_from_jax(state: Dict, device=None) -> Dict:
    """A state of the reference's trainer (``launch/steps.py``'s
    ``make_init_fn`` and train steps) -> the port's: params, ``OptState``,
    the step and, where there is one, the EF tree."""
    out = {"params": lm_params_from_jax(state["params"], device),
           "opt": opt_state_from_jax(state["opt"], device),
           "step": _tensor(state["step"], device)}
    if "ef" in state:
        out["ef"] = lm_params_from_jax(state["ef"], device)
    return out


def train_policy_from_jax(p) -> TrainPolicy:
    """The reference's ``TrainPolicy`` -> the port's, field by field."""
    return TrainPolicy(**{f.name: getattr(p, f.name)
                          for f in dataclasses.fields(TrainPolicy)})
