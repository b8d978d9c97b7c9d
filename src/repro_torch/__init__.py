"""DegreeSketch on PyTorch and CUDA: the port of ``repro`` to NVIDIA Hopper.

Mirrors the module layout of the JAX package so each counterpart is easy
to find. Plain tensor code is PyTorch; every kernel on the main path is a
hand-written CUDA kernel under ``csrc/``, built at first use and bound
with ``ctypes`` (``kernels._build``). Entry points run on the card unless
the caller asks for the CPU (``engine.open(..., device="cpu")``), where
each kernel wrapper takes its plain PyTorch version instead.

This package never imports ``jax`` or ``repro``; only the tests import
both sides, and state crosses between them as numpy arrays
(``engine.convert``).
"""
