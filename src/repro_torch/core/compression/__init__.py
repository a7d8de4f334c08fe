"""Gradient compression operators (paper §II), port of
``repro/core/compression``.

The per-tensor operators (``quantize``, ``sparsify``) each return
``(compressed_tensor, meta)``: the dense representation of the compressed
value (what the PS would reconstruct) and bit accounting or the kept mask.
``error_feedback`` wraps any of them leaf-wise over a gradient tree;
``coding`` holds the position codec and the bit costs; ``registry`` the
engine's row operators by name.
"""
from repro_torch.core.compression.sparsify import (  # noqa: F401
    random_sparsify, topk_mask, topk_sparsify, randk_sparsify, rtopk_sparsify,
    synchronous_mask_cycle)
from repro_torch.core.compression.quantize import (  # noqa: F401
    qsgd, ternary, sign_compress, scaled_sign, blockwise_scaled_sign)
from repro_torch.core.compression.error_feedback import (  # noqa: F401
    SparseEF, densify_rows, ef_compress, init_error_state, init_sparse_error,
    sparsify_rows, tree_ef_compress, tree_init_error)
from repro_torch.core.compression.coding import (  # noqa: F401
    encode_positions, decode_positions, elias_gamma_bits, elias_gamma_bits_jax,
    sparse_bits_jax, sparse_message_bits)
from repro_torch.core.compression.registry import (  # noqa: F401
    KERNEL_DISPATCH_MIN_ELEMS, CompressionParams, compression_params,
    compressor_names, default_compression_params, get_compressor,
    kernel_dispatch, rows_compressor, stack_compression_params,
    uplink_bits_jax)
