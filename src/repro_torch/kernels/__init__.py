"""Hand-written CUDA kernels of the port (``csrc/``), each beside its plain
PyTorch version; see ``ops`` for the row APIs the engine calls."""
