"""The main-path kernels: CUDA wrappers, their plain versions, and glue.

``hll_accumulate``, ``hll_estimate``, ``hll_propagate``,
``intersection_stats``, ``union_estimate``, ``ertl_stats`` and
``hip_delta`` each wrap one hand-written kernel from ``csrc/``
(built by ``_build``); ``ref`` holds the plain PyTorch versions; ``ops``
and ``registry`` are the glue the engine calls.
"""
