"""Privacy mechanisms as a registry axis, port of
``repro/core/privacy/registry.py``: secure aggregation, differential privacy
and their composition, priced on the wireless uplink.

The mechanism *name* is static; ``clip``, ``sigma`` and ``field_bits`` are
float32 0-d tensors in :class:`PrivacyParams`. :func:`get_privacy` returns
the static facts the engine branches on (``uses_field``, ``uses_dp``,
``uses_masks``, ``dp_local``) and the
``(client_transform, server_transform, init_privacy_state)`` triple.

``none``
    The clear-text path (the privacy key is not even derived).
``secagg``
    Pairwise-mask secure aggregation over Z_{2^32} (``coding.to_field``
    fixed point). Client ``i`` adds ``|S| * g_i - sum_{j in S} g_j`` to its
    encoded message, ``g_i`` its PRG mask vector and ``S`` the surviving
    cohort: the Bonawitz et al. masks after dropout recovery, in closed form
    (the key agreement is priced by :func:`mask_bits_jax`, not simulated).
    The masks cancel mod 2^32 over any survivor set.
``dp``
    Central DP-SGD: per-client L2 clipping to ``clip`` and Gaussian noise
    ``sigma * clip * N(0, I)`` on the server's sum, with a Renyi ledger.
``secagg_dp``
    Distributed DP under secure aggregation: each client adds rounded
    Gaussian noise of std ``sigma * clip`` in the field before masking.

The hidden ``_secagg_unmasked`` entry runs the secagg pipeline without
masks: the oracle the masked aggregate must equal bit for bit.

Field elements are int64 tensors holding values in ``[0, 2^32)``; every
uint32 operation of the reference is int64 arithmetic followed by
``& FIELD_MASK`` (``cnt * g - gsum`` may go negative, and the mask then
gives the two's-complement residue; ``cnt * g`` stays below 2^49).

Composition rules (:func:`validate_privacy_config`): the field modes need a
dense compressor (:data:`FIELD_COMPATIBLE`); SCAFFOLD's control-variate
uplink is not privatized, so any privacy bans it; fedbuff's fractional
staleness weights cannot scale field elements, so the field modes ban it.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch import random as trandom
from repro_torch.core import chunking
from repro_torch.core.algorithms import registry as algo_registry
from repro_torch.core.compression import coding
from repro_torch.core.compression.coding import FIELD_MASK

# domain-separation tags: the round key is folded under PRIVACY_FOLD (only
# when a mechanism is active), then under each consumer's own sub-tag
PRIVACY_FOLD = 0x9C1A
MASK_FOLD = 0x3A5C      # per-client pairwise-mask PRG seeds
NOISE_FOLD = 0xA01E     # DP noise (per-client for dp_local, server central)

# one key agreement per client pair each round, 256 bits per key share
KEY_BITS = 256.0

# compressors whose dense wire format survives field encoding
FIELD_COMPATIBLE = ("none", "sign", "scaled_sign", "blockwise_scaled_sign",
                    "ternary", "qsgd")

# Renyi orders of the accountant, and the delta the epsilon is reported at
ALPHAS = (2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
DELTA = 1e-5


class PrivacyParams(NamedTuple):
    """``clip``: the per-client L2 bound (and the field codec's range);
    ``sigma``: the noise multiplier (std ``sigma * clip``); ``field_bits``:
    the fixed-point width of the field (a sum of m messages decodes exactly
    while ``m * 2^(field_bits-1) < 2^31``). Float32 0-d tensors."""
    clip: torch.Tensor
    sigma: torch.Tensor
    field_bits: torch.Tensor

    def to(self, device) -> "PrivacyParams":
        return PrivacyParams(*(f.to(device) for f in self))


def privacy_params(clip: float = 1.0, sigma: float = 0.0,
                   field_bits: float = 20.0, device=None) -> PrivacyParams:
    return PrivacyParams(*(torch.tensor(float(v), dtype=torch.float32,
                                        device=device)
                           for v in (clip, sigma, field_bits)))


def default_privacy_params(device=None) -> PrivacyParams:
    return privacy_params(device=device)


def stack_privacy_params(ps) -> PrivacyParams:
    """Stack params along a leading variant axis."""
    ps = list(ps)
    return PrivacyParams(*(torch.stack([getattr(p, f) for p in ps])
                           for f in PrivacyParams._fields))


# ---------------------------------------------------------------------------
# Per-client primitives (chunk-invariant: fold_in(tagged key, client_id))
# ---------------------------------------------------------------------------
def clip_rows(pp: PrivacyParams, rows: torch.Tensor) -> torch.Tensor:
    """Per-row L2 clipping to ``pp.clip``, as a select between the raw and
    the rescaled row (the reference's form, which pins its wire rows
    against fused multiply-adds)."""
    nrm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    scaled = rows * (pp.clip / torch.clamp_min(nrm, 1e-30))
    return torch.where(nrm > pp.clip, scaled, rows)


def mask_rows(privacy_key: torch.Tensor, ids: torch.Tensor,
              d: int) -> torch.Tensor:
    """Per-client PRG mask vectors ``g_i``: (len(ids), d) field elements
    keyed ``fold_in(fold_in(privacy_key, MASK_FOLD), id)``."""
    keys = chunking.client_keys(trandom.fold_in(privacy_key, MASK_FOLD), ids)
    return trandom.bits(keys, (d,))


def pairwise_masks(privacy_key: torch.Tensor, ids: torch.Tensor, d: int,
                   gsum: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Each client's summed pairwise mask ``|S| * g_i - sum_{j in S} g_j``
    mod 2^32; sums to 0 mod 2^32 over the survivor set S."""
    g = mask_rows(privacy_key, ids, d)
    return (cnt * g - gsum[None, :]) & FIELD_MASK


def field_noise_rows(pp: PrivacyParams, privacy_key: torch.Tensor,
                     ids: torch.Tensor, d: int) -> torch.Tensor:
    """Per-client rounded Gaussian noise in field units, std
    ``sigma * clip`` in message space: (len(ids), d) field addends."""
    keys = chunking.client_keys(trandom.fold_in(privacy_key, NOISE_FOLD),
                                ids)
    z = trandom.normal(keys, (d,))
    s = coding.field_scale(pp.clip, pp.field_bits)
    q = torch.round(pp.sigma * pp.clip * s * z).to(torch.int32)
    return q.to(torch.int64) & FIELD_MASK


def central_noise(pp: PrivacyParams, privacy_key: torch.Tensor,
                  d: int) -> torch.Tensor:
    """Server-side Gaussian noise for the central-DP sum: (d,) float32 of
    std ``sigma * clip``."""
    k = trandom.fold_in(privacy_key, NOISE_FOLD)
    return pp.sigma * pp.clip * trandom.normal(k, (d,))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
# client_transform: (pp, privacy_key, ids, rows (c, D) float32) -> wire rows
# (float32 for the clear and dp modes, field elements for the field modes;
# the pairwise masks are added by the caller, which knows the cohort).
# server_transform: (pp, privacy_key, total (D,)) -> float32 sum.
# init_privacy_state: () -> the RDP ledger, or None.


def _ct_none(pp, key, ids, rows):
    return rows


def _ct_dp(pp, key, ids, rows):
    return clip_rows(pp, rows)


def _ct_secagg(pp, key, ids, rows):
    return coding.to_field(rows, pp.clip, pp.field_bits)


def _ct_secagg_dp(pp, key, ids, rows):
    q = coding.to_field(clip_rows(pp, rows), pp.clip, pp.field_bits)
    return (q + field_noise_rows(pp, key, ids, rows.shape[-1])) & FIELD_MASK


def _st_none(pp, key, total):
    return total


def _st_dp(pp, key, total):
    return total + central_noise(pp, key, total.shape[-1])


def _st_field(pp, key, total):
    return coding.from_field(total, pp.clip, pp.field_bits)


def _init_state_none():
    return None


def _init_state_dp():
    return torch.zeros(len(ALPHAS), dtype=torch.float32)


class Privacy(NamedTuple):
    """A registered mechanism: the static facts the engine branches on and
    the transform triple."""
    name: str
    uses_field: bool     # wire messages are field elements
    uses_dp: bool        # clipping + noise + (epsilon, delta) accounting
    uses_masks: bool     # pairwise secure-aggregation masks (priced)
    dp_local: bool       # noise added per client (in the field)
    client_transform: Callable
    server_transform: Callable
    init_privacy_state: Callable


_REGISTRY: Dict[str, Privacy] = {
    "none": Privacy("none", False, False, False, False,
                    _ct_none, _st_none, _init_state_none),
    "secagg": Privacy("secagg", True, False, True, False,
                      _ct_secagg, _st_field, _init_state_none),
    "dp": Privacy("dp", False, True, False, False,
                  _ct_dp, _st_dp, _init_state_dp),
    "secagg_dp": Privacy("secagg_dp", True, True, True, True,
                         _ct_secagg_dp, _st_field, _init_state_dp),
    # hidden oracle: the secagg pipeline without the masks
    "_secagg_unmasked": Privacy("_secagg_unmasked", True, False, False,
                                False, _ct_secagg, _st_field,
                                _init_state_none),
}


def get_privacy(name: str) -> Privacy:
    """Registry lookup: name -> :class:`Privacy`."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown privacy mechanism {name!r}; "
                         f"known: {sorted(privacy_names())}") from None


def privacy_names() -> Tuple[str, ...]:
    return tuple(n for n in _REGISTRY if not n.startswith("_"))


def validate_privacy_config(name: str, *, compression: str,
                            algorithm: str) -> None:
    """Reject illegal (privacy, compression, algorithm) combinations, with
    the reference's messages."""
    p = get_privacy(name)
    if p.name == "none":
        return
    algo = algo_registry.get_algorithm(algorithm)
    if p.uses_field and compression not in FIELD_COMPATIBLE:
        raise ValueError(
            f"privacy={name!r} aggregates in the uint32 finite field, where "
            f"every coordinate of a masked message is uniformly random — "
            f"the sparse position-coded compressor {compression!r} cannot "
            f"ship such a message. Legal pairs: "
            f"{'/'.join(FIELD_COMPATIBLE)}")
    if algo.uses_ctrl:
        raise ValueError(
            f"privacy={name!r} does not cover algorithm={algorithm!r}: its "
            "second (control-variate) uplink would leave the server a "
            "per-client plaintext side channel. Use a ctrl-free algorithm")
    if p.uses_field and algo.uses_staleness:
        raise ValueError(
            f"privacy={name!r} cannot run algorithm={algorithm!r}: "
            "fractional staleness weights cannot scale uint32 field "
            "elements (masked sums admit only modular integer arithmetic). "
            "Plain 'dp' supports fedbuff — weights <= 1 keep the L2 "
            "sensitivity at clip")


# ---------------------------------------------------------------------------
# Wire pricing
# ---------------------------------------------------------------------------
def uplink_bits_jax(name: str, pp: PrivacyParams, d: int,
                    base_bits) -> torch.Tensor:
    """Per-message payload bits: the field modes send dense ``field_bits``
    per coordinate; the clear and dp modes keep ``base_bits``."""
    if get_privacy(name).uses_field:
        return pp.field_bits * torch.tensor(float(d), dtype=torch.float32,
                                            device=pp.field_bits.device)
    return torch.as_tensor(base_bits, dtype=torch.float32,
                           device=pp.field_bits.device)


def mask_bits_jax(name: str, n_peers, device=None) -> torch.Tensor:
    """Per-client mask-agreement bits of one round: two ``KEY_BITS`` key
    shares per peer; zero for mask-free modes. Raw protocol bits, not
    scaled by the model-payload ratio."""
    if get_privacy(name).uses_masks:
        return 2.0 * KEY_BITS * torch.as_tensor(n_peers, dtype=torch.float32,
                                                device=device)
    return torch.zeros((), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# (epsilon, delta) accounting: Renyi DP over a fixed order grid
# ---------------------------------------------------------------------------
def rdp_increment(q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """One round's RDP cost at every order in :data:`ALPHAS` for the
    subsampled Gaussian mechanism (sampling fraction ``q``, noise multiplier
    ``z``): ``min(alpha / (2 z^2), 2 alpha q^2 / z^2)``; ``q = 0`` costs
    nothing, ``z = 0`` costs infinity, ``q >= 1`` is the full Gaussian."""
    q = torch.as_tensor(q, dtype=torch.float32)
    z = torch.as_tensor(z, dtype=torch.float32, device=q.device)
    a = torch.tensor(ALPHAS, dtype=torch.float32, device=q.device)
    z2 = torch.clamp_min(z * z, 1e-30)
    full = a / (2.0 * z2)
    sub = 2.0 * a * q * q / z2
    inc = torch.where(q >= 1.0, full, torch.minimum(full, sub))
    inc = torch.where(z > 0.0, inc, torch.inf)
    return torch.where(q > 0.0, inc, 0.0)


def epsilon_of(rdp: torch.Tensor, delta: float = DELTA) -> torch.Tensor:
    """RDP to DP: ``eps = min_alpha RDP(alpha) + log(1/delta) /
    (alpha - 1)``; monotone in the non-decreasing ledger. ``log`` is taken
    in float32, as the reference takes it."""
    a = torch.tensor(ALPHAS, dtype=torch.float32, device=rdp.device)
    log_inv = torch.log(torch.tensor(1.0 / delta, dtype=torch.float32,
                                     device=rdp.device))
    return torch.amin(rdp + log_inv / (a - 1.0))
