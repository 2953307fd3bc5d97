"""SwapLess multi-tenant serving in PyTorch, for one NVIDIA H100.

A port of the JAX package ``repro`` (the reference), module for module:
``repro_torch.core.allocator`` mirrors ``repro.core.allocator`` and so on.
The host-side planning and simulation modules are float64 NumPy copies of
the reference; real execution runs the CNN prefixes on the GPU through
hand-written CUDA kernels (``repro_torch.kernels``) and the suffixes on
host thread pools.
"""
