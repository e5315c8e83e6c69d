"""PyTorch / CUDA port of the TimeRipple reproduction.

A package beside the JAX reference ``repro``, with the same module
layout.  It imports torch and numpy only; its hand-written Hopper
kernels live in ``csrc/`` and are built with nvcc at first use.
"""
