"""PyTorch/CUDA port of the wireless collaborative-learning system.

A second package beside the JAX reference ``repro``: module paths mirror it
(``repro_torch/core/chunking.py`` opposite ``repro/core/chunking.py``), it
imports neither JAX nor ``repro``, and its entry points run on the CUDA
device unless asked for the CPU. Its compression row kernels are CUDA C++
for Hopper (``repro_torch/kernels/csrc``).
"""
