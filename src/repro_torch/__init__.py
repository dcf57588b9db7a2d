"""PyTorch + CUDA port of the block-space fractal mapping engine.

A second package beside the JAX reference ``repro``: the same module
layout and names, with every Pallas kernel rewritten by hand in CUDA C++
for Hopper (``sm_90a``).  It imports ``torch`` and never ``jax`` or
``repro``; arrays cross between the two packages as numpy.
"""
