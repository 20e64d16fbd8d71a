"""Fulcrum on PyTorch and CUDA: the port of the ``repro`` package to an
NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``repro_torch/core/simulate.py`` is the counterpart of
``repro/core/simulate.py``), imports nothing from it and never imports jax.
Engine entry points take ``backend="cuda"`` (the default: the hand-written
Hopper kernels under ``kernels/csrc``) or ``backend="cpu"`` (their plain
PyTorch versions). Importing the package touches no CUDA and builds
nothing; kernels are compiled at their first launch.
"""
__version__ = "0.1.0"
