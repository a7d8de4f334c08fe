"""Hand-written CUDA kernels of the port (``csrc/``), each beside its plain
PyTorch version; ``ops`` holds the row APIs the engine calls and the
whole-tensor compression APIs."""
from repro_torch.kernels.ops import (  # noqa: F401
    block_topk, qsgd_quantize, qsgd_rows, sign_ef_compress, sign_ef_rows,
    topk_rows)
