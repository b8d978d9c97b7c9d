"""The main-path kernels: CUDA wrappers, their plain versions, and glue.

``hll_accumulate``, ``hll_estimate``, ``hll_propagate``,
``intersection_stats``, ``union_estimate``, ``ertl_stats``,
``hip_delta`` and ``intersection_newton`` each wrap one hand-written
kernel from ``csrc/`` (built by ``_build``); ``ref`` holds the plain
PyTorch versions of the first seven (``intersection_newton`` keeps its
own); ``ops`` and ``registry`` are the glue the engine calls.
"""
