"""Privacy mechanisms as a registry axis (secure aggregation + DP); see
:mod:`repro_torch.core.privacy.registry`."""
from repro_torch.core.privacy.registry import (  # noqa: F401
    ALPHAS, DELTA, FIELD_COMPATIBLE, KEY_BITS, MASK_FOLD, NOISE_FOLD,
    PRIVACY_FOLD, Privacy, PrivacyParams, central_noise, clip_rows,
    default_privacy_params, epsilon_of, field_noise_rows, get_privacy,
    mask_bits_jax, mask_rows, pairwise_masks, privacy_names, privacy_params,
    rdp_increment, stack_privacy_params, uplink_bits_jax,
    validate_privacy_config)
